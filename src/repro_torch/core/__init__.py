"""AMPLE core: event-driven scheduling, Degree-Quant, mixed-precision AGE/FTE."""
