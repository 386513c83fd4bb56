"""int8 FTE kernel: int8 x int8 -> int32 matmul against a relaid weight."""
