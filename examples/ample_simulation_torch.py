"""Reproduce Table 5 / Figure 4 with the AMPLE discrete-event simulator, from the PyTorch port.

    PYTHONPATH=src python examples/ample_simulation_torch.py [--full] [--max-nodes N]

The port of ``examples/ample_simulation.py``: it reads only the port's copy
of the simulator (``repro_torch/core/simulator.py``, numpy on the host),
which simulates the accelerator (64 nodeslots, 32 HBM banks, fetch-tag
partial response, mixed-precision pools, 200 MHz) over the six paper
datasets, event-driven and double-buffered. It touches no device, so
``--device`` only checks that the device exists (default ``cuda``) and
``--device cpu`` runs it anywhere.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

from repro_torch.core.simulator import SimConfig, simulate_dataset
from repro_torch.device import resolve_device

PAPER = {"cora": 0.246, "citeseer": 0.294, "pubmed": 1.617,
         "flickr": 7.227, "reddit": 24.6, "yelp": 57.5}
PAPER_CPU = {"cora": 244.4, "citeseer": 244.3, "pubmed": 362.4,
             "flickr": 475.4, "reddit": 953.3, "yelp": 760.8}


def run(*, max_nodes: Optional[int] = 120_000, datasets=tuple(PAPER),
        device="cuda") -> Dict[str, Dict[str, float]]:
    """The table over ``datasets`` (each capped at ``max_nodes``; None: no
    cap): per dataset the event-driven and double-buffered records."""
    resolve_device(device)
    print(f"{'dataset':10s} {'sim ms':>9s} {'paper ms':>9s} {'vs CPU':>8s} "
          f"{'db ms':>9s} {'ev gain':>8s} {'slot busy':>9s}")
    rows = {}
    for name in datasets:
        ev = simulate_dataset(name, max_nodes=max_nodes)
        db = simulate_dataset(name, max_nodes=max_nodes, cfg=SimConfig(event_driven=False))
        print(f"{name:10s} {ev['latency_ms']:9.3f} {PAPER[name]:9.3f} "
              f"{PAPER_CPU[name] / ev['latency_ms']:7.0f}x {db['latency_ms']:9.3f} "
              f"{db['latency_ms'] / ev['latency_ms']:7.2f}x {ev['slot_busy_frac']:9.2f}")
        rows[name] = {"event_driven": ev, "double_buffered": db}
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="no node cap (slow)")
    ap.add_argument("--max-nodes", type=int, default=120_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(max_nodes=None if args.full else args.max_nodes, device=args.device)


if __name__ == "__main__":
    main()
