#!/usr/bin/env python3
"""Time the GAT backward kernel of two checkouts in turns on one CUDA card.

Run from the root of a checkout on a machine with a Hopper card and the CUDA
toolkit, with a second checkout (say the parent commit, unpacked with
``git archive`` into the ignored ``build/``) beside it:

    python3 tools/gat_bwd_ab.py --trees build/parent . [--order 0 1 1 0]

Each turn is a process of its own that imports the tree's ``src/repro_torch``,
builds its kernels from the tree's sources, and calls the backward through its
wrappers on FULL ample-gat's Yelp graph with self-loops (716,847 nodes,
14,694,439 edges, seed 0; the work items from the tree's ``row_items`` over
every node): ``attend_tiles_bwd`` (alpha, ds) and ``edge_dot`` (the
coefficients' gradient), at both layer shapes (H 4, dh 64 and 100), on f32
rows and int8 codes, on inputs made from the same seeds in every turn. Each
time is the median of five runs of ten launches, by CUDA events. The turns
run in ``--order`` (indices into ``--trees``), so that two versions are
compared within one call. Alpha is hashed and must be bitwise equal across
trees; ds and the coefficients' gradient of each tree's first turn are kept
under ``build/gat_bwd_ab/`` (removed at the end) and must agree within 1e-5
of each value and of the largest (the dots' sums may run in another order).
It prints one JSON object with every turn's times, the card's name and power
limit, each case's mean time per tree and the comparison, and exits 1 if two
trees disagree.
"""
import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP = os.path.join(ROOT, "build", "gat_bwd_ab")
TOL = 1e-5  # chip_smoke.GAT_BWD_TOL


def _turn(tree: str, reps: int, keep: str) -> dict:
    """One tree's times, alpha hashes and (into ``keep``, when given) its ds
    and coefficient gradients (run in a process of its own)."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.quantization import compute_scale_zp, quantize
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import attn_ops
    from repro_torch.models.gnn.api import prepare_graph
    from repro_torch.models.gnn.gat import LEAKY_SLOPE

    build.build()
    build.library()
    cfg = get_config("ample-gat")
    gs = prepare_graph(cfg, make_dataset("yelp", with_features=False, seed=0))
    n, e, h = gs.num_nodes, gs.num_edges, cfg.gnn_heads
    dev = torch.device("cuda")
    indices = torch.as_tensor(gs.indices, dtype=torch.int32).to(dev)
    items = torch.from_numpy(attn_ops.row_items(gs.indptr, np.arange(n))).to(dev)

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
    for dh in (64, 100):
        gen = torch.Generator(device=dev).manual_seed(dh)
        z = torch.randn((n, h, dh), generator=gen, device=dev)
        g = torch.randn((n, h, dh), generator=gen, device=dev)
        out = torch.randn((n, h, dh), generator=gen, device=dev)
        lse = torch.randn((n, h), generator=gen, device=dev).abs() + 2.0
        scores = torch.randn((e, h), generator=gen, device=dev)
        qp = compute_scale_zp(z)
        for rows, x, xqp in (("f32", z, None), ("int8", quantize(z, qp), qp)):
            calls = {
                "attention": lambda: attn_ops.attend_tiles_bwd(
                    x, g, out, lse, scores, indices, items, leaky_slope=LEAKY_SLOPE, qp=xqp),
                "coefficients": lambda: (attn_ops.edge_dot(x, g, indices, items, qp=xqp),),
            }
            for mode, fn in calls.items():
                name = f"{mode} {rows} rows dh={dh}"
                res = fn()
                torch.cuda.synchronize()
                row = dict(ms=timed(fn))
                if mode == "attention":
                    row["alpha_hash"] = hashlib.sha256(
                        res[0].cpu().numpy().tobytes()).hexdigest()[:16]
                if keep:
                    np.save(os.path.join(keep, name.replace(" ", "_") + ".npy"),
                            res[-1].cpu().numpy())
                cases[name] = row
                del res
        del z, g, out, lse, scores
    return dict(tree=tree, items=int(items.shape[0]), cases=cases)


def _agree(a, b) -> float:
    """The largest |a - b| over TOL * (|b| + max |b|): <= 1 within tolerance."""
    import numpy as np

    scale = float(np.abs(b).max())
    return float((np.abs(a - b) / (TOL * (np.abs(b) + scale))).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[os.path.join("build", "parent"), "."])
    ap.add_argument("--order", nargs="+", type=int, default=[0, 1, 1, 0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--keep", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(_turn(args.one, args.reps, args.keep)))
        return 0

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gat_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    shutil.rmtree(KEEP, ignore_errors=True)
    kept = {}
    turns = []
    try:
        for i in args.order:
            keep = ""
            if i not in kept:
                keep = kept[i] = os.path.join(KEEP, str(i))
                os.makedirs(keep)
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                                  args.trees[i], "--reps", str(args.reps), "--keep", keep],
                                 capture_output=True, text=True, cwd=ROOT)
            if res.returncode != 0:
                print(res.stderr[-4000:], file=sys.stderr)
                return 1
            turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(f"turn {len(turns)} ({args.trees[i]}): " + ", ".join(
                f"{k} {v['ms']:.3f}" for k, v in turns[-1]["cases"].items()), flush=True)
        mean, compared = {}, {}
        same = True
        first, *others = list(kept)
        for case in dict.fromkeys(c for t in turns for c in t["cases"]):
            per_tree = {}
            for t in turns:
                per_tree.setdefault(t["tree"], []).append(t["cases"][case]["ms"])
            mean[case] = {tree: statistics.mean(v) for tree, v in per_tree.items()}
            hashes = {t["cases"][case].get("alpha_hash") for t in turns}
            fname = case.replace(" ", "_") + ".npy"
            want = np.load(os.path.join(kept[first], fname))
            errs = [_agree(np.load(os.path.join(kept[k], fname)), want) for k in others]
            label = "ds" if case.startswith("attention") else "coefficient gradient"
            compared[case] = {"alpha_bitwise": len(hashes) == 1,
                              f"{label} err/tol": max(errs, default=0.0)}
            same &= len(hashes) == 1 and all(err <= 1.0 for err in errs)
    finally:
        shutil.rmtree(KEEP, ignore_errors=True)
    print(json.dumps(dict(card=card.strip(), order=[args.trees[i] for i in args.order],
                          turns=turns, mean_ms=mean, across_trees=compared,
                          outputs_agree_across_trees=same)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
