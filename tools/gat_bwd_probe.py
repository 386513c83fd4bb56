#!/usr/bin/env python3
"""Find what holds the GAT backward kernel on one CUDA card, by variants.

Run from the root of a checkout on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/gat_bwd_probe.py [--reps 5] [--items 64 32 128]

It builds, each with one ``nvcc -shared`` of its own (all started together),
and loads with ``ctypes`` under the C entry point ``ample_attention_bwd``:

- the first design's stripped variants (``tools/gat_bwd_probe.cu``): gather
  only, + the per-element head select, + the butterflies (the full dots, no
  per-edge operands), and the whole first kernel;
- ``src/repro_torch/csrc/attn_agg_bwd.cu`` as it is, and copies of it with
  other values of its constants (``kRawWords``, ``kCodeWords``: the registers
  a lane gives to rows in flight, f32 and codes; ``kMinBlocks``,
  ``kCodeMinBlocks``: the blocks an SM the register cap is set for) or with
  one step of the design taken back (one butterfly an edge instead of the
  reduce-scatter).

Each is timed on FULL ample-gat's Yelp graph with self-loops (716,847 nodes,
14,694,439 edges, seed 0) at both layer shapes (H 4, dh 64 and 100), on f32
rows and int8 codes, in attention mode (alpha, ds), by CUDA events: the
median of five runs of ``--reps`` launches. The kernel at its defaults is
also timed in coefficient mode and over work items of other lengths
(``--items``). Every full variant's alpha is held bitwise to the kernel's at
its defaults, ds within 1e-5 of each value and of the largest (the dots' sums
run in another order). It prints the card's name and power limit, each
build's registers and spills, one line per case beside the row floor (every
edge's row gathered once at 3.35 TB/s) and the bound, and one JSON object
with everything, also written to ``chiprun_out/gat_bwd_probe.json``.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
HBM_BPS = 3.35e12
TOL = 1e-5
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
PROBE_CU = os.path.join(ROOT, "tools", "gat_bwd_probe.cu")
OUT_DIR = os.path.join(ROOT, "build", "gat_bwd_probe")

NEW_CU = os.path.join(CSRC, "attn_agg_bwd.cu")
# name -> (source, -D flags, (text, replacement) or None): the first design's
# stages, the kernel, and copies of it with one text replaced.
VARIANTS = {
    "first: gather": (PROBE_CU, ["-DPROBE_STAGE=0"], None),
    "first: + select": (PROBE_CU, ["-DPROBE_STAGE=1"], None),
    "first: + butterflies": (PROBE_CU, ["-DPROBE_STAGE=2"], None),
    "first: full": (PROBE_CU, ["-DPROBE_STAGE=3"], None),
    "new": (NEW_CU, [], None),
    "new, f32 raw 32": (NEW_CU, [], ("kRawWords = 16;", "kRawWords = 32;")),
    "new, codes raw 8": (NEW_CU, [], ("kCodeWords = 4;", "kCodeWords = 8;")),
    "new, f32 min blocks 2": (NEW_CU, [], ("kMinBlocks = 3;", "kMinBlocks = 2;")),
    "new, codes min blocks 3": (NEW_CU, [], ("kCodeMinBlocks = 4;", "kCodeMinBlocks = 3;")),
    # one butterfly an edge instead of the reduce-scatter
    "new, butterfly an edge": (NEW_CU, [], (
        "return launch_mode<T, kChunk, P, L>(", "return launch_mode<T, kChunk, P, 0>(")),
}


def build_all(names):
    """One nvcc per variant, all started together: {name: (entry point, ptxas
    registers and spills per kernel)}."""
    from chip_smoke import ptxas_table
    from repro_torch.kernels import build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for k, name in enumerate(names):
        src, flags, patch = VARIANTS[name]
        if patch is not None:
            text = open(src).read()
            if patch[0] not in text:
                raise RuntimeError(f"{name}: {patch[0]!r} is not in {src}")
            src = os.path.join(OUT_DIR, f"variant{k}-{os.getpid()}.cu")
            with open(src, "w") as f:
                f.write(text.replace(patch[0], patch[1]))
        lib = os.path.join(OUT_DIR, f"variant{k}-{os.getpid()}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, *flags,
               "-shared", src, "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        table = {fn: v for fn, v in ptxas_table(text).items() if "gat_bwd_kernel" in fn}
        fn = ctypes.CDLL(lib).ample_attention_bwd
        fn.argtypes = build._SIGNATURES["ample_attention_bwd"]
        fn.restype = ctypes.c_int
        libs[name] = (fn, dict(kernels={k: dict(registers=r, spill_stores=st, spill_loads=ld)
                                        for k, (r, st, ld) in table.items()},
                               spill_bytes=sum(st + ld for _, st, ld in table.values())))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--items", nargs="+", type=int, default=[64, 32, 128])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gat_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.core.quantization import compute_scale_zp, quantize
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels.segment_agg.attn_ops import row_items
    from repro_torch.models.gnn.api import prepare_graph
    from repro_torch.models.gnn.gat import LEAKY_SLOPE

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    t0 = time.perf_counter()
    libs = build_all(args.variants)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, info) in libs.items():
        print(f"  {name}: registers {sorted({v['registers'] for v in info['kernels'].values()})}"
              f", spill bytes {info['spill_bytes']} "
              f"{[k for k, v in info['kernels'].items() if v['spill_stores'] + v['spill_loads']]}")

    cfg = get_config("ample-gat")
    gs = prepare_graph(cfg, make_dataset("yelp", with_features=False, seed=0))
    n, e = gs.num_nodes, gs.num_edges
    dev = torch.device("cuda")
    indices = torch.as_tensor(gs.indices, dtype=torch.int32).to(dev)
    items = {c: torch.from_numpy(row_items(gs.indptr, np.arange(n), c)).to(dev)
             for c in args.items}
    heads = cfg.gnn_heads
    gen = torch.Generator(device=dev).manual_seed(5)
    scores = torch.randn((e, heads), generator=gen, device=dev)
    lse = torch.randn((n, heads), generator=gen, device=dev).abs() + 2.0
    stream = torch.cuda.current_stream().cuda_stream
    res_a = torch.empty((e, heads), device=dev)
    res_b = torch.empty((e, heads), device=dev)

    def timed(fn):
        fn()
        runs = []
        for _ in range(5):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop) / args.reps)
        return statistics.median(runs)

    cases = []
    for dh in (64, 100):
        d = heads * dh
        z = torch.randn((n, heads, dh), generator=gen, device=dev)
        g = torch.randn((n, heads, dh), generator=gen, device=dev)
        out = torch.randn((n, heads, dh), generator=gen, device=dev)
        qp = compute_scale_zp(z)
        for rows, x in (("f32", z), ("int8", quantize(z, qp))):
            elem = x.element_size()
            qs, qz = (None, None) if elem == 4 else (qp.scale.data_ptr(), qp.zero_point.data_ptr())
            floor = e * d * elem / HBM_BPS * 1e3
            nbytes = (n * d * elem + 2 * n * d * 4 + n * heads * 4 + e * heads * 4 + e * 4
                      + 2 * e * heads * 4)
            bound = max(nbytes / HBM_BPS * 1e3, (2.0 * e * d + 2.0 * n * d) / 67e12 * 1e3)

            def launch(fn, attn, it):
                def go():
                    status = fn(0, x.data_ptr(), elem, qs, qz, d, g.data_ptr(), out.data_ptr(),
                                lse.data_ptr(), scores.data_ptr(), None, indices.data_ptr(),
                                it.data_ptr(), int(it.shape[0]), res_a.data_ptr(),
                                res_b.data_ptr(), heads, dh, 4 * elem, int(attn), LEAKY_SLOPE,
                                stream)
                    if status:
                        raise RuntimeError(f"CUDA error {status}")
                return go

            want = None
            runs = [(name, True, args.items[0]) for name in sorted(libs, key=lambda k: k != "new")]
            runs += [("new", True, c) for c in args.items[1:]] + [("new", False, args.items[0])]
            for name, attn, chunk in runs:
                if name not in libs:
                    continue
                go = launch(libs[name][0], attn, items[chunk])
                res_a.fill_(float("nan"))
                res_b.fill_(float("nan"))
                go()
                torch.cuda.synchronize()
                row = dict(variant=name, attn=attn, item_edges=chunk, rows=rows, dh=dh,
                           ms=timed(go), row_floor_ms=floor, bound_ms=bound,
                           finite=bool(torch.isfinite(res_a).all()))
                if name == "new" and attn and chunk == args.items[0]:
                    want = (res_a.clone(), res_b.clone())
                full = attn and not name.startswith("first: ") or name == "first: full"
                if full and want is not None:
                    row["alpha_bitwise"] = bool(torch.equal(res_a, want[0]))
                    scale = float(want[1].abs().max())
                    row["ds_err_over_tol"] = float(
                        ((res_b - want[1]).abs() / (TOL * (want[1].abs() + scale))).max())
                cases.append(row)
                print(f"{name:22s} {'attn' if attn else 'coef'} items {chunk:3d} {rows:4s} "
                      f"dh {dh:3d}: {row['ms']:.3f} ms (row floor {floor:.3f}, bound "
                      f"{bound:.3f}){'' if 'alpha_bitwise' not in row else ' alpha bitwise %s, ds err/tol %.3g' % (row['alpha_bitwise'], row['ds_err_over_tol'])}",
                      flush=True)
            del want
        del z, g, out
    bad = [c for c in cases if not c["finite"] or c.get("alpha_bitwise") is False
           or c.get("ds_err_over_tol", 0.0) > 1.0]
    result = dict(card=card.strip(), n=n, edges=e, heads=heads, reps=args.reps,
                  builds={k: v[1] for k, v in libs.items()}, cases=cases, disagree=bad)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gat_bwd_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(dict(card=result["card"], disagree=bad)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
