#!/usr/bin/env python3
"""Time the two GAT forward kernels of two checkouts in turns on one CUDA card.

Run from the root of a checkout on a machine with a Hopper card and the CUDA
toolkit, with a second checkout (say the parent commit, unpacked with
``git archive`` into the ignored ``build/``) beside it:

    python3 tools/gat_kernels_ab.py --trees build/parent . [--order 0 1 1 0]

Each turn is a process of its own that imports the tree's ``src/repro_torch``,
builds its kernels from the tree's sources, serves FULL ``ample-gat`` once on
the Yelp graph (716,847 nodes, seed 0) to build its plans, and times the
fused attention (``attend_tiles``, with no lse buffer) and the multi-head AGE
(``aggregate_tiles_mh``) at the ``gat kernels`` phase's shapes of
``chip_smoke.py``: H 4, dh 64 and 100, f32 rows in both precision groups and
int8 codes in the int8 group. Each time is the median of five runs of ten
launches, by CUDA events. The turns run in ``--order`` (indices into
``--trees``), so that two versions are compared within one call. Every
output is hashed, and the script exits 1 if two trees disagree on one. It
prints one JSON object with every turn's times, the card's name and power
limit, and each case's mean time per tree. A tree whose ``attend_tiles``
takes an lse buffer also times the attention with one (not hashed).
"""
import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _turn(tree: str, reps: int) -> dict:
    """One tree's times and output hashes (run in a process of its own)."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.quantization import compute_scale_zp, quantize
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import attn_ops
    from repro_torch.models.gnn.gat import LEAKY_SLOPE
    from repro_torch.serve.gnn_engine import GNNServeEngine

    build.build()
    build.library()
    cfg = get_config("ample-gat")
    g = make_dataset("yelp", max_feature_dim=cfg.d_model, seed=0)
    srv = GNNServeEngine(cfg)
    srv.infer(g, g.features)
    entry = next(e for _, _, e in srv._cache.values() if e.graph.num_nodes >= g.num_nodes)
    n, e = entry.graph.num_nodes, entry.graph.num_edges
    dplans = entry._device_plans("runtime", entry.plans("runtime"), torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    scores = torch.randn((e, 4), generator=gen, device="cuda")
    coeffs = torch.rand((e, 4), generator=gen, device="cuda")

    def timed(fn):
        fn()
        runs = []
        for _ in range(5):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop) / reps)
        return statistics.median(runs)

    cases = {}
    for tag in ("int8", "float"):
        dp = dplans[tag]
        plan = (dp.gather_idx, dp.edge_ids)
        rest = (dp.coeff, dp.seg_ids, dp.out_node, dp.split)
        for dh in (64, 100):
            z = torch.randn((n, 4, dh), generator=gen, device="cuda")
            kinds = [("f32", z, None)]
            if tag == "int8":
                qp = compute_scale_zp(z, symmetric=True)
                kinds.append(("int8", quantize(z, qp), qp))
            for rows, x, qp in kinds:
                for name, fn in (
                        ("attention", lambda: attn_ops.attend_tiles(
                            x, *plan, scores, *rest, num_nodes=n, leaky_slope=LEAKY_SLOPE,
                            qp=qp)),
                        ("segment_agg_mh", lambda: attn_ops.aggregate_tiles_mh(
                            x, *plan, coeffs, *rest, num_nodes=n, qp=qp))):
                    out = fn()
                    torch.cuda.synchronize()
                    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
                    cases[f"{name} {tag} {rows} rows dh={dh}"] = dict(ms=timed(fn), hash=digest)
                    del out
                if "lse" in inspect.signature(attn_ops.attend_tiles).parameters:
                    lse = torch.empty((n, 4), device="cuda")
                    cases[f"attention {tag} {rows} rows dh={dh} with lse"] = dict(
                        ms=timed(lambda: attn_ops.attend_tiles(
                            x, *plan, scores, *rest, num_nodes=n, leaky_slope=LEAKY_SLOPE,
                            qp=qp, lse=lse)), hash=None)
            del z, kinds
    return dict(tree=tree, tiles={t: int(p.gather_idx.shape[0]) for t, p in dplans.items()},
                cases=cases)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[os.path.join("build", "parent"), "."])
    ap.add_argument("--order", nargs="+", type=int, default=[0, 1, 1, 0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(_turn(args.one, args.reps)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("gat_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    turns = []
    for i in args.order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", args.trees[i],
                              "--reps", str(args.reps)], capture_output=True, text=True,
                             cwd=ROOT)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"turn {len(turns)} ({args.trees[i]}): " + ", ".join(
            f"{k} {v['ms']:.3f}" for k, v in turns[-1]["cases"].items()), flush=True)
    mean = {}
    same = True
    for case in dict.fromkeys(c for t in turns for c in t["cases"]):
        per_tree = {}
        for t in turns:
            if case in t["cases"]:
                per_tree.setdefault(t["tree"], []).append(t["cases"][case]["ms"])
        mean[case] = {tree: statistics.mean(v) for tree, v in per_tree.items()}
        hashes = {t["cases"][case]["hash"] for t in turns if case in t["cases"]}
        same &= None in hashes or len(hashes) == 1
    print(json.dumps(dict(card=card.strip(), order=[args.trees[i] for i in args.order],
                          turns=turns, mean_ms=mean, outputs_bitwise_across_trees=same)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
