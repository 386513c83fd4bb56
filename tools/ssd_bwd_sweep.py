#!/usr/bin/env python3
"""Time the SSD backward over its design knobs on one CUDA card, and beside an earlier build of it.

Run from the root of a checkout on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/ssd_bwd_sweep.py [--parent DIR]

At ``chip_smoke.py``'s four ``SSD_BWD_CASES`` (the Mamba2-370M and Jamba
training shapes, a ragged Q 200 and the REDUCED launcher's), it times
``ops.ssd_intra_chunk_bwd`` (``csrc/ssd_scan_bwd.cu``) at each number of
heads a run of its fused kernel (1 to 8 runs) and each depth of its
``cp.async`` ring that fits the card, beside the pick of
``ops.bwd_heads_per_run``, both bounds (bytes against the three TF32
products, and against f32 FMAs on the CUDA cores) and each kernel's ms a
call of the pick, from a profiled run of ``chip_smoke.PROFILED_CALLS``
calls. With ``--parent DIR`` (an unpacked ``git archive`` of an earlier
commit) it also builds that commit's ``csrc/ssd_scan_bwd.cu`` and
``csrc/ssd_scan.cu`` with ``nvcc`` under ``build/``, times its backward and
the pick in turns (earlier, this, this, earlier) and holds this forward
bitwise equal to its forward. Each time is the median of three runs of ten
calls, by CUDA events; the card's name and power limit are printed first.
Every variant must give the plain backward's gradients within 1e-4 of each
one's largest magnitude (and the forward the earlier one's bits); the
script exits 1 if one does not.
"""
import argparse
import ctypes
import importlib.util
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

REL = 1e-4


def _median_ms(fn):
    import chip_smoke as smoke

    return statistics.median(smoke.cuda_ms(fn, reps=10) for _ in range(3))


def _rel_err(got, want):
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def _parent(parent_dir):
    """The earlier commit's backward as a callable of (cc, bc, xdt, acum, dy):
    its source built alone into a shared library, its scratch and head
    split as its own wrapper sized them."""
    import torch

    from repro_torch.kernels import build

    csrc = os.path.join(parent_dir, "src", "repro_torch", "csrc")
    lib_path = os.path.join(ROOT, "build", "ssd_parent.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    os.path.join(csrc, "ssd_scan_bwd.cu"), os.path.join(csrc, "ssd_scan.cu"),
                    "-o", lib_path], check=True)
    lib = ctypes.CDLL(lib_path)
    fn = lib.ample_ssd_intra_chunk_bwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fwd = lib.ample_ssd_intra_chunk
    fwd.argtypes = build._SIGNATURES["ample_ssd_intra_chunk"]
    fwd.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "parent_ssd_ops", os.path.join(parent_dir, "src", "repro_torch", "kernels", "ssd_scan",
                                       "ops.py"))
    parent_ops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_ops)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(cc, bc, xdt, acum, dy):
        b, nc, q, n = cc.shape
        h, p = xdt.shape[2], xdt.shape[4]
        tiles = -(-q // 64)
        qp = tiles * 64
        splits = parent_ops.bwd_head_splits(b * nc, tiles, h, sms)
        square, part = b * nc * qp * qp, b * nc * h * tiles * qp
        scratch = torch.empty(((1 + splits) * square + 2 * part,), device=cc.device)
        cb, dcb, rowp, colp = scratch.split([square, splits * square, part, part])
        outs = [torch.empty_like(t) for t in (cc, bc, xdt, acum)]
        status = fn(0, *(t.data_ptr() for t in (cc, bc, xdt, acum, dy, *outs, cb, dcb, rowp,
                                                colp)),
                    b, nc, q, n, h, p, splits, torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"the earlier backward: CUDA error {status}")
        return outs

    def forward(cc, bc, xdt, acum):
        from repro_torch.kernels.ssd_scan import ops as ssd_ops

        b, nc, q, n = cc.shape
        h, p = xdt.shape[2], xdt.shape[4]
        q64 = -(-q // 64) * 64
        out = torch.empty_like(xdt)
        cb = torch.empty((b * nc * (q64 // 16) * (q64 // 8) * 128,), device=cc.device)
        status = fwd(0, *(t.data_ptr() for t in (cc, bc, xdt, acum, out, cb)), b, nc, q, n, h, p,
                     ssd_ops.HEADS_PER_BLOCK, torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"the earlier forward: CUDA error {status}")
        return out

    return call, forward


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an unpacked git archive of an earlier commit")
    args = parser.parse_args()

    import torch

    import chip_smoke as smoke
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_bwd_ref

    if not torch.cuda.is_available():
        print("ssd_bwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(smoke.card_line(), flush=True)
    parent, parent_fwd = _parent(args.parent) if args.parent else (None, None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for label, b, nc, q, n, h, p in smoke.SSD_BWD_CASES:
        args5 = smoke.ssd_bwd_inputs(b, nc, q, n, h, p, seed=7)
        want = ssd_intra_chunk_bwd_ref(*args5)
        ops, nbytes = smoke.ssd_bwd_work(b, nc, q, n, h, p)
        tc_ms, tc_by = smoke.bound(nbytes, 3 * ops, smoke.TF32_FLOPS)
        f32_ms, _ = smoke.bound(nbytes, ops, smoke.FP32_FLOPS)
        shape = f"{label} B={b} NC={nc} Q={q} N={n} H={h} P={p}"
        print(f"{shape}: bound {tc_ms:.4f} ms ({tc_by}; TF32, 3 x {ops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), f32 bound {f32_ms:.4f} ms", flush=True)
        picked = ssd_ops.bwd_heads_per_run(b * nc, -(-q // 64), h, sms)
        hprs = sorted({-(-h // runs) for runs in range(1, min(h, ssd_ops.BWD_MAX_RUNS) + 1)})
        times = {}
        for hpr in hprs:
            for stages in (1, 2):
                def call(hpr=hpr, stages=stages):
                    return ssd_ops.ssd_intra_chunk_bwd(*args5, heads_per_run=hpr, stages=stages)

                try:
                    got = call()
                    torch.cuda.synchronize()
                except RuntimeError:
                    print(f"{shape}: {hpr} heads a run, {stages} slots: does not fit", flush=True)
                    continue
                err = _rel_err(got, want)
                ok &= err <= REL
                times[hpr, stages] = _median_ms(call)
                print(f"{shape}: {hpr} heads a run ({-(-h // hpr)} runs), {stages} slots"
                      f"{' (picked)' if hpr == picked else ''}: {times[hpr, stages]:.4f} ms, "
                      f"{times[hpr, stages] / tc_ms:.2f}x the bound, {err:.2e} of max",
                      flush=True)
                del got
        best = min(times, key=times.get)
        pick = min((k for k in times if k[0] == picked), key=times.get)
        print(f"{shape}: fastest {best[0]} heads a run, {best[1]} slots ({times[best]:.4f} ms); "
              f"picked {pick[0]}, {pick[1]} slots ({times[pick]:.4f} ms) on {sms} SMs",
              flush=True)
        _, _, rows = smoke._device_profile(
            lambda: [ssd_ops.ssd_intra_chunk_bwd(*args5) for _ in range(smoke.PROFILED_CALLS)])
        per_kernel = {re.search(r"ssd_bwd_\w+", name).group(0): ms / count
                      for name, ms, count in rows if "ssd_bwd_" in name}
        print(f"{shape}: a call of {smoke.PROFILED_CALLS} profiled: "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in per_kernel.items()), flush=True)
        if parent is not None:
            err = _rel_err(parent(*args5), want)
            ok &= err <= REL
            # the forward (csrc/ssd_scan.cu) bitwise the earlier commit's
            same = torch.equal(parent_fwd(*args5[:4]), ssd_ops.ssd_intra_chunk(*args5[:4]))
            ok &= same
            print(f"{shape}: the forward bitwise the earlier commit's: {same}", flush=True)
            turns = []
            for which in ("earlier", "this", "this", "earlier"):
                fn = (lambda: parent(*args5)) if which == "earlier" else (
                    lambda: ssd_ops.ssd_intra_chunk_bwd(*args5))
                turns.append((which, _median_ms(fn)))
            print(f"{shape}: in turns "
                  + ", ".join(f"{which} {ms:.4f}" for which, ms in turns)
                  + f" ms (earlier: {err:.2e} of max)", flush=True)
        del args5, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
