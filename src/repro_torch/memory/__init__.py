"""Out-of-core memory subsystem: host-resident features + plan-driven prefetch.

AMPLE's third pillar — "a prefetcher for data and instructions is implemented
to optimize off-chip memory access" (§3.3) — for the port:

* ``feature_store`` — a chunked, host-resident :class:`FeatureStore` holding
  node features off the device in two representations (f32 for the float
  gather stream, int8 under the aggregation scale for the int8 stream),
  page-locked for the card, or ``np.memmap``-backed so host RSS stays
  bounded too;
* ``prefetcher`` — a :class:`ChunkPrefetcher` executing a scheduler
  ``ChunkSchedule`` against a fixed-budget device chunk cache (reuse-distance
  eviction, uploads staged on a side stream ahead of the tiles that read
  them), and the streamed aggregation/transform executors, bitwise the
  in-memory engine paths, through the AGE and int8 GEMM kernels on the card.
"""
from repro_torch.memory.feature_store import FeatureStore, default_chunk_rows
from repro_torch.memory.prefetcher import (
    ChunkPrefetcher,
    StreamStats,
    StreamedFeatures,
    aggregate_streamed,
    scale_add_streamed,
)

__all__ = [
    "FeatureStore",
    "default_chunk_rows",
    "ChunkPrefetcher",
    "StreamStats",
    "StreamedFeatures",
    "aggregate_streamed",
    "scale_add_streamed",
]
