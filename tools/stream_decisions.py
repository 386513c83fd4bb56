#!/usr/bin/env python3
"""Count the chunk cache's decisions on a synthetic schedule, on the CPU.

Run from the root of a checkout (no card needed):

    python3 tools/stream_decisions.py [--tiles 2000] [--lanes 256] [--chunks 176]

It builds a tile plan of ``--tiles`` tiles of ``--lanes`` lanes whose rows
are drawn uniformly from ``--chunks`` chunks of 4,096 rows (a graph without
neighbour locality, as the synthetic Yelp graph is) and runs the out-of-core
prefetcher's cache state machine (``memory.prefetcher.build_stream_program``,
whose counters equal the reference's ``ChunkPrefetcher``'s) with 21 and 87
slots (an f32 and an int8 stream at Yelp's 1/8 budget) at prefetch depth 0
and 2. It prints, per tile: chunk visits, hits, sparse visits, demand
uploads and prefetch uploads.
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CHUNK_ROWS = 4096


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=2000)
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--chunks", type=int, default=176)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro_torch.core import scheduler as sched
    from repro_torch.memory.prefetcher import build_stream_program

    t, e = args.tiles, args.lanes
    rows = args.chunks * CHUNK_ROWS
    rng = np.random.default_rng(args.seed)
    plan = sched.EdgeTilePlan(
        gather_idx=rng.integers(0, rows, (t, e)).astype(np.int32),
        coeff=np.ones((t, e), np.float32),
        seg_ids=np.zeros((t, e), np.int32),
        out_node=np.arange(t, dtype=np.int32).reshape(t, 1),  # one node a tile
        node_ids=np.arange(t, dtype=np.int32),
        edge_ids=np.arange(t * e, dtype=np.int32).reshape(t, e),
        num_nodes=rows, edges_per_tile=e, segments_per_tile=1, total_edges=t * e,
    )
    schedule = sched.build_chunk_schedule(plan, CHUNK_ROWS, reorder=False)
    visits = schedule.total_chunk_visits / t
    print(f"{t} tiles of {e} lanes over {args.chunks} chunks: {visits:.1f} chunk visits a tile")
    for slots in (21, 87):
        for depth in (0, 2):
            c = build_stream_program(plan, schedule, num_slots=slots, prefetch_depth=depth,
                                     chunk_bytes=1, row_bytes=0).counts
            demand = c["bytes_streamed"] - c["prefetched"]  # one byte a chunk upload
            sparse = c["chunk_misses"] - demand
            print(f"slots {slots} depth {depth}: per tile hits {c['chunk_hits'] / t:.1f}, "
                  f"sparse visits {sparse / t:.1f}, demand uploads {demand / t:.2f}, "
                  f"prefetch uploads {c['prefetched'] / t:.2f}; evictions {c['evictions']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
