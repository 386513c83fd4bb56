#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card; hold each kernel against its plain version.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX or the JAX package.
Without a card, or outside a checkout, it exits non-zero and prints no result.
Every phase that fails raises, so the script exits non-zero.

1. build   — nvcc every ``src/repro_torch/csrc/*.cu`` for sm_90a, one process
             per source, and print each kernel's registers, shared memory and
             spills (the tensor-core flash kernel, the int8 GEMM, the tile
             walk of the AGE and the GAT kernels, and the SSD kernel must not
             spill);
2. path    — serve the FULL ``ample-gcn`` config on the Yelp-scale graph
             (716,847 nodes, 300 features, random weights from seed 0):
             ``infer`` three times (cold, warm, warm; warm must equal cold
             bitwise, and each request must launch the AGE kernel 4 times and
             the int8 matmul twice), then ``infer_batch`` of three cora-sized
             graphs. Launch counts are set to 0 just before and read just after;
             one more warm request runs under torch.profiler to show where its
             time goes. The requests must call ``quantization.dequantize`` no
             time (the int8 group's rows reach the AGE as codes), and the
             profile must show the AGE's 4 launches on ``heads_walk_kernel``,
             none of the retired ``tile_heads_kernel`` and no full-size add
             (the two precision groups share one output);
3. kernels — the AGE and the int8 matmul against their plain PyTorch
             versions on the card, at the path's shapes (AGE within 1e-4 and
             run-to-run bitwise, on f32 rows and, in the int8 group, on int8
             codes, at D 300 also at a row stride of 304 bytes; int8 matmul
             bitwise), timed with CUDA events beside the plain version, one
             PyTorch library call and the card's bound (the int8 matmul's
             ratio to ``torch._int_mm`` printed);
4. cpu     — the same model served on the CPU (plain versions) on a
             cora-sized graph, against the card's output at the
             mixed-precision tolerance;
5. gat path — the same for FULL ``ample-gat`` (4 heads, 300 → 256 → 100) on
             the same graph: each request must launch the fused attention
             kernel 4 times and the int8 matmul twice, warm == cold bitwise,
             peak device memory under 20 GiB, and no copy of the scores into
             tile layout (``tile_edge_coeff`` is counted and must stay at 0);
             then a profiled warm request;
6. gat decomposed — at the Yelp layer-2 shapes (H = 4, dh = 100),
             ``edge_softmax`` + ``aggregate(edge_coeff=…)``: the multi-head AGE
             twice per precision group, run-to-run bitwise, within atol 5e-5,
             rtol 1e-4 of the fused layer;
7. gat kernels — the fused attention and multi-head AGE kernels against
             their plain versions at the Yelp shapes (f32 rows in both groups
             and int8 codes in the int8 group, H·dh = 256 and 400; within 1e-4
             and run-to-run bitwise), timed beside the plain version, the
             bound, the gathered-row floor (lanes × row bytes / 3.35 TB/s)
             and, for the multi-head AGE, one ``torch.sparse.mm`` with the
             heads folded into the rows, on the f32 rows (no single PyTorch
             call computes the fused attention, so it has no library time);
8. gat cpu — ``ample-gat`` served on the CPU against the card;
9. lm path — FULL ``qwen3-8b`` (36 layers, d 4096, GQA 32/8, hd 128, bf16,
             random weights from a CUDA generator of seed 0) through
             ``ServeEngine.generate``: 4 prompts of 2048 tokens (numpy seed
             0), 32 new tokens, twice (36 flash-attention launches each, all
             on the tensor-core kernel; the repeat bitwise), once with one new
             token (prefill time); then the serving path's logits, fed the
             generated tokens, against one teacher-forced ``model_forward``
             (argmax agreement >= 0.9, max relative difference < 0.05, all
             finite), and a profiled ``generate``;
10. ssm path — the same for FULL ``mamba2-370m`` (48 SSD launches each);
11. lm kernels — flash attention (Qwen3-8B and SmolLM-360M prefill in bf16
             on the tensor-core kernel, within 1.6e-2 and >= 99% of the bf16
             entries bitwise equal to the plain version's; a ragged S = 1000
             in f32 on the CUDA-core kernel within 1e-4) and the SSD
             intra-chunk term (Mamba2-370M prefill and a ragged chunk, within
             1e-4 of the plain version run with TF32 off) against their plain
             versions, run-to-run bitwise, timed beside the plain version, the
             bound and, for flash, one ``scaled_dot_product_attention`` call
             (variant and ratios to SDPA and to the bound printed; the SSD's
             bound counts its three TF32 products at the TF32 peak, and the
             f32 CUDA-core bound of PR 13-15 is printed beside it);
12. lm cpu — REDUCED ``qwen3-8b`` and ``mamba2-370m`` served on the CPU
             against the card: the same tokens, prefill logits within 5e-4;
13. summary — a JSON line of kernels, the card's name and power limit, and
             the result line.

Details of every measurement also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 (no tensor
# cores) flop/s, int8 tensor-core op/s.
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12  # tensor cores, dense
TF32_FLOPS = 494.7e12  # tensor cores, dense

AGE_ATOL = 1e-4  # unit-normal features, summation order differs
ATTN_ATOL, ATTN_RTOL = 5e-5, 1e-4  # decomposed vs fused GAT layer (tests/test_gat.py:101)
MIXED_ATOL, MIXED_RTOL, MIXED_FLIP = 6e-2, 2e-3, 2e-3  # int8 code flips

# LM traffic: B prompts of P tokens from numpy seed 0, NEW greedy tokens.
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_MAX_LEN = LM_PROMPT + LM_NEW
FLASH_F32_ATOL = 1e-4  # order of sums
FLASH_BF16_ATOL = 1.6e-2  # both keep p in f32; the bf16 output: two ulps at magnitude 1
# Share of bf16 outputs bitwise equal to the plain version's: p kept in f32
# moves only the order of the sums (~2^-18 relative) and flips well under 1%
# of the roundings; one bf16 p (2^-9) flips about a third of them.
FLASH_BF16_EQUAL = 0.99
SSD_ATOL = SSD_RTOL = 1e-4  # tests/test_kernels_ssd.py:27
TF_AGREE, TF_REL = 0.9, 0.05  # bf16-level bounds, tests/test_int8_kv.py:37-41
LM_CPU_ATOL, LM_CPU_RTOL = 5e-4, 1e-3  # f32 paths, tests/test_gnn_models.py:46


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _yelp_engine(srv, g):
    """The engine a server built for the Yelp request (the largest one cached)."""
    return next(e for _, _, e in srv._cache.values() if e.graph.num_nodes >= g.num_nodes)


# Kernels that must keep every value in registers (a spill would sit in the
# inner loop): the tensor-core flash kernel, the int8 GEMM, the tile walk
# (AGE and GAT) and the SSD's two kernels.
NO_SPILL = ("flash_tc_kernel", "quant_matmul_kernel", "heads_walk_kernel", "ssd_cb_kernel",
            "ssd_tc_kernel")
# The rows the GCN path's int8 group hands the AGE at D 300 (phase_age's row
# kinds): int8 codes at a row stride of 304 bytes (aggregation._int8_rows).
AGE_PATH_ROWS = "int8 stride 304"


def ptxas_table(text):
    """{entry function: (registers, spill store bytes, spill load bytes)} from
    ``nvcc -Xptxas -v`` output."""
    import re

    table, fn, props = {}, None, None
    for line in text.splitlines():
        if (hit := re.search(r"Compiling entry function '([^']+)'", line)):
            fn = hit.group(1)
            table[fn] = [0, 0, 0]
        elif (hit := re.search(r"Function properties for (\S+)", line)):
            props = hit.group(1)
        elif props in table and (
                hit := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            table[props][1:] = [int(hit.group(1)), int(hit.group(2))]
        elif fn and (hit := re.search(r"Used (\d+) registers", line)):
            table[fn][0] = int(hit.group(1))
    return {k: tuple(v) for k, v in table.items()}


def phase_build():
    from repro_torch.kernels import build

    report = build.build()
    build.library()
    log(f"[build] {report.library.name}: {report.seconds:.2f} s"
        + (" (reused)" if report.seconds == 0.0 else ""))
    for line in report.ptxas_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "==")):
            log("[build]   " + line.strip())
    table = ptxas_table(report.ptxas_log)
    watched = {fn: v for fn, v in table.items() if any(w in fn for w in NO_SPILL)}
    for fn, (regs, st, ld) in sorted(watched.items()):
        log(f"[build] {fn}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    if len({w for w in NO_SPILL for fn in watched if w in fn}) != len(NO_SPILL):
        raise RuntimeError(f"ptxas reported none of {NO_SPILL} in {sorted(table)}")
    spilled = [fn for fn, (_, st, ld) in watched.items() if st or ld]
    if spilled:
        raise RuntimeError(f"kernels spill to local memory: {spilled}")
    return report


def phase_path(cfg, g, batch_graphs, want, tag="path"):
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine

    srv = GNNServeEngine(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    per_request, outs = [], []
    for i in range(3):
        before = build.launch_counts()
        resp = srv.infer(g, g.features)
        after = build.launch_counts()
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        per_request.append(delta)
        outs.append(resp)
        log(f"[{tag}] yelp infer {i}: cache_hit={resp.cache_hit} "
            f"plan_ms={resp.plan_ms:.1f} run_ms={resp.run_ms:.3f} launches={delta}")
    reqs = [GNNRequest(graph=b, features=b.features) for b in batch_graphs]
    before = build.launch_counts()
    batch = srv.infer_batch(reqs)
    after = build.launch_counts()
    batch_delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    log(f"[{tag}] infer_batch of {len(reqs)} graphs "
        f"({sum(b.num_nodes for b in batch_graphs)} nodes): "
        f"plan_ms={batch[0].plan_ms:.1f} run_ms={batch[0].run_ms:.3f} launches={batch_delta}")
    counts = build.launch_counts()  # the whole main path
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] launches over the path: {counts}; peak device memory "
        f"{peak / 2**30:.2f} GiB")

    for i, d in enumerate(per_request):
        if d != want:
            raise RuntimeError(f"request {i} launched {d}, expected {want}")
    if batch_delta != want:
        raise RuntimeError(f"infer_batch launched {batch_delta}, expected {want}")
    y = outs[0].outputs
    if y.shape != (g.num_nodes, cfg.vocab_size) or not np.isfinite(y).all():
        raise RuntimeError(f"bad yelp outputs: shape {y.shape}, finite {np.isfinite(y).all()}")
    for r in outs[1:]:
        if not r.cache_hit or not np.array_equal(r.outputs, y):
            raise RuntimeError("warm request differs from the cold one")
    for r, b in zip(batch, batch_graphs):
        if r.outputs.shape != (b.num_nodes, cfg.vocab_size) or not np.isfinite(r.outputs).all():
            raise RuntimeError("bad batch outputs")
    log(f"[{tag}] warm == cold bitwise; outputs finite, shape "
        f"{y.shape}")
    return srv, outs, batch, counts, peak


def _device_profile(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, result, rows of
    (device op, ms, count) sorted by device time). Rows are device-side events
    only (kernels, copies, memsets): an operator's own entry repeats the
    device time of the kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(
        ((e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
         if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0),
        key=lambda r: -r[1],
    )
    return wall_ms, result, rows


def phase_profile(srv, g, tag="profile"):
    """Where one warm Yelp request's time goes: device time by kernel or copy
    (torch.profiler), against the wall time of the whole ``infer`` call
    (host padding, upload, forward, download; run_ms covers the upload and
    the forward). Prints "not measured" when the profiler records no device
    time."""
    wall_ms, resp, rows = _device_profile(lambda: srv.infer(g, g.features))
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        log(f"[{tag}] warm infer wall_ms={wall_ms:.3f} run_ms={resp.run_ms:.3f}; "
            "device time not measured")
        return dict(wall_ms=wall_ms, run_ms=resp.run_ms, device_ms=None, top=[])
    log(f"[{tag}] warm infer wall_ms={wall_ms:.3f} run_ms={resp.run_ms:.3f}, device "
        f"busy {busy:.3f} ms (idle share of the call {max(0.0, 1 - busy / wall_ms):.3f})")
    for name, ms, count in rows[:14]:
        log(f"[{tag}]   {ms:9.3f} ms  x{count:<4d} {name[:90]}")
    return dict(wall_ms=wall_ms, run_ms=resp.run_ms, device_ms=busy,
                top=[dict(name=n, ms=ms, count=c) for n, ms, c in rows[:24]],
                kernels={n: c for n, _, c in rows})


def check_gcn_profile(row):
    """The GCN request's profile: the AGE's 4 launches all on the walk, no
    launch of the retired tile_heads_kernel, and no full-size contiguous add
    (what ``zeros + float + int8`` launched twice per layer)."""
    if row["device_ms"] is None:
        log("[profile] device time not measured: the profile checks did not run")
        return
    kernels = row["kernels"]
    walk = sum(c for n, c in kernels.items() if "heads_walk_kernel" in n)
    old = sum(c for n, c in kernels.items() if "tile_heads_kernel" in n)
    adds = sum(c for n, c in kernels.items()
               if "vectorized_elementwise_kernel" in n and "CUDAFunctor_add<float>" in n)
    log(f"[profile] AGE launches on heads_walk_kernel {walk}, on tile_heads_kernel {old}; "
        f"contiguous f32 adds {adds}")
    if walk != 4 or old or adds:
        raise RuntimeError(f"GCN profile: walk launches {walk}, tile_heads_kernel {old}, "
                           f"adds {adds}")


def _group_csr(plan, n):
    """The plan's coefficient matrix as a torch CSR [n, n] (library yardstick)."""
    import numpy as np
    import torch

    live = plan.edge_ids >= 0
    t_idx = np.nonzero(live)[0]
    dst = plan.out_node[t_idx, plan.seg_ids[live]].astype(np.int64)
    src = plan.gather_idx[live].astype(np.int64)
    coo = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([dst, src])), torch.from_numpy(plan.coeff[live]),
        (n, n),
    ).coalesce()
    return coo.to_sparse_csr().cuda()


def phase_age(engine, mode, x300):
    """The AGE against its plain version at the GCN request's shapes, per
    precision group and width (D 300, 256): on f32 rows and, in the int8
    group, on int8 codes: contiguous, and at D 300 also as the path hands
    them, at a row stride of 304 bytes (16-byte chunks, the last one reading
    the padding)."""
    import numpy as np
    import torch

    from repro_torch.core.aggregation import _int8_rows
    from repro_torch.core.quantization import compute_scale_zp, dequantize, quantize
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg.ref import aggregate_tiles_ref

    n = engine.graph.num_nodes
    plans = engine.plans(mode)
    dplans = engine._device_plans(mode, plans, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    x256 = torch.randn((n, 256), generator=gen, device="cuda")
    rows = []
    for tag in ("int8", "float"):
        p, dp = plans[tag], dplans[tag]
        args = (dp.gather_idx, dp.coeff, dp.seg_ids, dp.out_node, dp.split)
        lib_a = _group_csr(p, n)
        live = p.edge_ids >= 0
        lanes = int(live.sum())
        uniq = np.unique(p.gather_idx[live]).size
        plan_bytes = sum(t.numel() * t.element_size() for t in args[:4]) + sum(
            t.numel() * t.element_size()
            for t in (dp.split.slot_of, dp.split.split_ptr, dp.split.split_node)
        )
        for x in (x300, x256):
            d = x.shape[1]
            kinds = [("f32", x, None)]
            if tag == "int8":
                qp = compute_scale_zp(x, symmetric=True)
                kinds.append(("int8", quantize(x, qp), qp))
                if d % 16:  # the path's codes: rows at a stride of 16-byte multiples
                    codes = _int8_rows(x, qp)
                    kinds.append((f"int8 stride {codes.stride(0)}", codes, qp))
            for rows_kind, xr, qp in kinds:
                elem = xr.element_size()
                xf = xr if qp is None else dequantize(xr, qp)
                out = seg_ops.aggregate_tiles(xr, *args, num_nodes=n, qp=qp)
                again = seg_ops.aggregate_tiles(xr, *args, num_nodes=n, qp=qp)
                plain = aggregate_tiles_ref(xr, *args, num_nodes=n, qp=qp)
                torch.cuda.synchronize()
                bitwise = bool(torch.equal(out, again))
                err = float((out - plain).abs().max())
                ms = cuda_ms(lambda: seg_ops.aggregate_tiles(xr, *args, num_nodes=n, qp=qp),
                             reps=5)
                plain_ms = cuda_ms(lambda: aggregate_tiles_ref(xr, *args, num_nodes=n, qp=qp),
                                   reps=2)
                # the library call on the f32 rows (the dequantized codes)
                lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, xf), reps=5)
                # each unique row once at its precision, the plan, the output
                nbytes = uniq * d * elem + plan_bytes + n * d * 4
                b_ms, b_by = bound(nbytes, 2.0 * lanes * d, FP32_FLOPS)
                row = dict(group=tag, rows=rows_kind, tiles=p.num_tiles,
                           lanes=p.edges_per_tile, edges=lanes, n=n, d=d,
                           split_slots=dp.split.num_slots, max_abs_err=err,
                           run_to_run_bitwise=bitwise, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                           gathered_row_bytes=lanes * d * elem)
                rows.append(row)
                log(f"[kernels] segment_agg {tag} {rows_kind} rows T={p.num_tiles} D={d}: "
                    f"err={err:.3g} bitwise={bitwise} ms={ms:.3f} plain_ms={plain_ms:.3f} "
                    f"library_ms={lib_ms:.3f} bound_ms={b_ms:.3f} ({b_by}) row_floor_ms="
                    f"{lanes * d * elem / HBM_BPS * 1e3:.3f}")
                if not bitwise or not err <= AGE_ATOL:
                    raise RuntimeError(f"segment_agg {tag} {rows_kind} D={d}: err {err}, "
                                       f"bitwise {bitwise}")
                del out, again, plain, xf
        del lib_a
    return rows


def phase_gemm(m):
    import torch

    from repro_torch.kernels.quant_matmul import ops as qm_ops
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for k, n, fill in ((300, 256, None), (256, 100, None), (256, 400, None), (130, 256, None),
                       (300, 256, -128)):
        if fill is None:
            a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        else:
            a = torch.full((m, k), fill, device="cuda", dtype=torch.int8)
            w = torch.full((k, n), fill, device="cuda", dtype=torch.int8)
        packed = qm_ops.repack_weight(w)
        out = qm_ops.quant_matmul_repacked(a, packed)
        plain = quant_matmul_ref(a, w)
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, plain))
        err = float((out.double() - plain.double()).abs().max())
        ms = cuda_ms(lambda: qm_ops.quant_matmul_repacked(a, packed), reps=5)
        plain_ms = cuda_ms(lambda: quant_matmul_ref(a, w), reps=2)
        kp8, np8 = -(-k // 8) * 8, -(-n // 8) * 8
        a8 = torch.zeros((m, kp8), dtype=torch.int8, device="cuda")
        a8[:, :k] = a
        w8 = torch.zeros((kp8, np8), dtype=torch.int8, device="cuda")
        w8[:k, :n] = w
        lib_ms = cuda_ms(lambda: torch._int_mm(a8, w8), reps=5)
        nbytes = m * k + k * n + m * n * 4
        b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS)
        row = dict(m=m, k=k, n=n, fill=fill, max_abs_err=err, bitwise=exact, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes)
        rows.append(row)
        log(f"[kernels] quant_matmul M={m} K={k} N={n}"
            f"{' all -128' if fill is not None else ''}: bitwise={exact} ms={ms:.3f} "
            f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} bound_ms={b_ms:.3f} ({b_by}); "
            f"{ms / lib_ms:.3f}x torch._int_mm, {ms / b_ms:.2f}x the bound")
        if not exact:
            raise RuntimeError(f"quant_matmul K={k} N={n} not bitwise (max err {err})")
        if fill is not None and int(out[0, 0]) != k * 128 * 128:
            raise RuntimeError("quant_matmul extreme case overflowed")
        del a, w, a8, w8, out, plain
    return rows


def _heads_csr(dp, edge_coeff, n):
    """The multi-head coefficients of one plan as a torch CSR [n·H, n·H]:
    entry ((node, h), (src, h)) sums coeff · edge_coeff[edge, h] over the live
    lanes from src to node, so that out.view(n·H, dh) = A @ x.view(n·H, dh)
    (library yardstick: the multi-head AGE with the heads folded into the
    rows)."""
    import torch

    h = edge_coeff.shape[-1]
    live = dp.edge_ids >= 0
    dst = torch.gather(dp.out_node, 1, dp.seg_ids.long())[live].long()
    src = dp.gather_idx[live].long()
    cf = dp.coeff[live].unsqueeze(-1) * edge_coeff[dp.edge_ids[live].long()]
    head = torch.arange(h, device=src.device)
    rows = (dst[:, None] * h + head).reshape(-1)
    cols = (src[:, None] * h + head).reshape(-1)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), cf.reshape(-1),
                                  (n * h, n * h)).coalesce()
    return coo.to_sparse_csr()


def _plan_bytes(dp):
    """Bytes of the plan arrays and split map the GAT kernels read: the lane
    indices, edge ids, static coeff and segments, the split map."""
    arrays = [dp.gather_idx, dp.edge_ids, dp.coeff, dp.seg_ids, dp.out_node, dp.split.slot_of,
              dp.split.split_ptr, dp.split.split_node]
    return sum(t.numel() * t.element_size() for t in arrays)


class _count_calls:
    """Count the calls of the port's function ``module.name`` while the block
    runs: every module of the port that holds it (by import) gets a counting
    wrapper."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        import importlib

        orig = getattr(importlib.import_module(self.module), self.name)
        self.count = [0]
        self.holders = [m for m in list(sys.modules.values())
                        if getattr(m, "__name__", "").startswith("repro_torch")
                        and getattr(m, self.name, None) is orig]
        self.orig = orig

        def counted(*args, **kwargs):
            self.count[0] += 1
            return orig(*args, **kwargs)

        for m in self.holders:
            setattr(m, self.name, counted)
        return self.count

    def __exit__(self, *exc):
        for m in self.holders:
            setattr(m, self.name, self.orig)
        return False


def _leaky(s):
    import torch.nn.functional as F

    from repro_torch.models.gnn.gat import LEAKY_SLOPE

    return F.leaky_relu(s, LEAKY_SLOPE)


def phase_gat_decomposed(entry):
    """The GAT layer in two passes (edge_softmax, then aggregate with per-head
    coefficients) at the Yelp layer-2 shapes, against the fused layer."""
    import torch

    from repro_torch.core.message_passing import AmpleEngine
    from repro_torch.kernels import build

    eng = AmpleEngine(entry.graph, plan=entry.plan)
    n, e = eng.graph.num_nodes, eng.graph.num_edges
    gen = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn((n, 4, 100), generator=gen, device="cuda")
    scores = torch.randn((e, 4), generator=gen, device="cuda")
    fused = eng.attention_aggregate(scores, z)

    def decomposed():
        alpha = eng.edge_softmax(_leaky(scores))
        return eng.aggregate(z, mode="runtime", edge_coeff=alpha)

    decomposed()  # warm: device plans and edge endpoints are cached
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = decomposed()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    again = decomposed()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out, again))
    diff = (out - fused).abs()
    err = float(diff.max())
    close = bool((diff <= ATTN_ATOL + ATTN_RTOL * fused.abs()).all())
    groups = len(eng.plans("runtime"))
    log(f"[gat decomposed] N={n} E={e} H=4 dh=100, {groups} precision groups: "
        f"launches={counts} wall_ms={wall_ms:.3f} run-to-run bitwise={bitwise}; "
        f"vs fused max abs diff {err:.3g} (atol {ATTN_ATOL}, rtol {ATTN_RTOL}: {close})")
    want = {"segment_agg_mh": 2 * groups}  # denominator + aggregate, per group
    if counts != want:
        raise RuntimeError(f"decomposed layer launched {counts}, expected {want}")
    if not bitwise or not close:
        raise RuntimeError(f"decomposed layer: bitwise {bitwise}, max diff to fused {err}")
    return dict(launches=counts, groups=groups, wall_ms=wall_ms, run_to_run_bitwise=bitwise,
                max_abs_diff_to_fused=err)


def phase_gat_kernels(entry):
    """Both GAT kernels against their plain versions at the Yelp shapes: f32
    rows in both groups and int8 codes in the int8 group, H·dh 256 and 400."""
    import numpy as np
    import torch

    from repro_torch.core.quantization import compute_scale_zp, dequantize, quantize
    from repro_torch.kernels.segment_agg import attn_ops
    from repro_torch.kernels.segment_agg.ref import aggregate_tiles_mh_ref, attend_tiles_ref
    from repro_torch.models.gnn.gat import LEAKY_SLOPE

    n, e = entry.graph.num_nodes, entry.graph.num_edges
    plans = entry.plans("runtime")
    dplans = entry._device_plans("runtime", plans, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    scores = torch.randn((e, 4), generator=gen, device="cuda")
    alpha = entry.edge_softmax(_leaky(scores))
    attn_rows, mh_rows = [], []
    for tag in ("int8", "float"):
        p, dp = plans[tag], dplans[tag]
        live = p.edge_ids >= 0
        lanes = int(live.sum())
        uniq = np.unique(p.gather_idx[live]).size
        lib_a = _heads_csr(dp, alpha, n)
        plan_bytes = _plan_bytes(dp)
        for dh in (64, 100):
            d = 4 * dh
            z = torch.randn((n, 4, dh), generator=gen, device="cuda")
            kinds = [("f32", z, None, z)]
            if tag == "int8":
                qp = compute_scale_zp(z, symmetric=True)
                q = quantize(z, qp)
                kinds.append(("int8", q, qp, dequantize(q, qp)))
            for rows_kind, x, qp, xf in kinds:
                elem = x.element_size()
                a_args = (dp.gather_idx, dp.edge_ids, scores, dp.coeff, dp.seg_ids, dp.out_node,
                          dp.split)
                m_args = (dp.gather_idx, dp.edge_ids, alpha, dp.coeff, dp.seg_ids, dp.out_node,
                          dp.split)
                xff = xf.view(n * 4, dh)
                cases = (
                    ("attention", attn_rows,
                     lambda: attn_ops.attend_tiles(x, *a_args, num_nodes=n,
                                                   leaky_slope=LEAKY_SLOPE, qp=qp),
                     lambda: attend_tiles_ref(x, *a_args, num_nodes=n, leaky_slope=LEAKY_SLOPE,
                                              qp=qp),
                     None, lanes * (2.0 * d + 5 * 4)),
                    ("segment_agg_mh", mh_rows,
                     lambda: attn_ops.aggregate_tiles_mh(x, *m_args, num_nodes=n, qp=qp),
                     lambda: aggregate_tiles_mh_ref(x, *m_args, num_nodes=n, qp=qp),
                     lambda: torch.sparse.mm(lib_a, xff), lanes * 2.0 * d),
                )
                for name, rows, kernel, plain_fn, lib_fn, ops in cases:
                    out = kernel()
                    again = kernel()
                    plain = plain_fn()
                    torch.cuda.synchronize()
                    bitwise = bool(torch.equal(out, again))
                    finite = bool(torch.isfinite(out).all())
                    err = float((out - plain).abs().max())
                    ms = cuda_ms(kernel, reps=5)
                    plain_ms = cuda_ms(plain_fn, reps=2)
                    lib_ms = lib_err = None
                    if lib_fn is not None:
                        lib_err = float((lib_fn().view_as(out) - out).abs().max())
                        lib_ms = cuda_ms(lib_fn, reps=5)
                    # Each unique row once at its precision, the per-edge
                    # operand [E, H] through the edge ids, the plan, the output.
                    nbytes = uniq * d * elem + lanes * 4 * 4 + plan_bytes + n * d * 4
                    b_ms, b_by = bound(nbytes, ops, FP32_FLOPS)
                    floor_ms = lanes * d * elem / HBM_BPS * 1e3
                    rows.append(dict(group=tag, rows=rows_kind, tiles=p.num_tiles,
                                     lanes=p.edges_per_tile, edges=lanes, n=n, heads=4, dh=dh,
                                     d=d, split_slots=dp.split.num_slots, max_abs_err=err,
                                     run_to_run_bitwise=bitwise, ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, library_err=lib_err, bound_ms=b_ms,
                                     bound_by=b_by, bytes=nbytes, row_floor_ms=floor_ms,
                                     gathered_row_bytes=lanes * d * elem))
                    lib = "" if lib_ms is None else (
                        f" library_ms={lib_ms:.3f} (err {lib_err:.3g}; {ms / lib_ms:.3f}x)")
                    log(f"[kernels] {name} {tag} {rows_kind} rows T={p.num_tiles} H=4 dh={dh}: "
                        f"err={err:.3g} bitwise={bitwise} ms={ms:.3f} plain_ms={plain_ms:.3f}{lib} "
                        f"bound_ms={b_ms:.3f} ({b_by}) row_floor_ms={floor_ms:.3f} "
                        f"({ms / floor_ms:.2f}x)")
                    if not bitwise or not finite or not err <= AGE_ATOL:
                        raise RuntimeError(f"{name} {tag} {rows_kind} dh={dh}: err {err}, "
                                           f"bitwise {bitwise}, finite {finite}")
                    if lib_err is not None and not lib_err <= AGE_ATOL:
                        raise RuntimeError(f"{name} {tag} dh={dh}: library yardstick differs "
                                           f"by {lib_err}")
                    del out, again, plain
            del z, x, xf, xff
        del lib_a
    return attn_rows, mh_rows


def phase_cpu(srv, cfg, g, tag="cpu"):
    import numpy as np

    from repro_torch.serve.gnn_engine import GNNServeEngine

    card = srv.infer(g, g.features).outputs
    cpu = GNNServeEngine(cfg, params=srv.params, device="cpu").infer(g, g.features).outputs
    diff = np.abs(card - cpu)
    flips = float((diff > MIXED_FLIP).mean())
    log(f"[{tag}] {g.num_nodes}-node graph: card vs CPU max abs diff {diff.max():.4g}, "
        f"share of entries off by > {MIXED_FLIP}: {flips:.4f}")
    np.testing.assert_allclose(card, cpu, atol=MIXED_ATOL, rtol=MIXED_RTOL)
    if not flips < 0.05:
        raise RuntimeError(f"{flips:.3f} of entries differ by > {MIXED_FLIP}")
    return dict(nodes=g.num_nodes, max_abs_diff=float(diff.max()), flip_share=flips)


# ------------------------------------------------------------------ LM phases
def _cuda_gen(seed):
    import torch

    return torch.Generator(device="cuda").manual_seed(seed)


def _timed(fn):
    """(result, wall ms) of ``fn`` ended by a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_lm_path(arch, kernels, tag):
    """Serve the FULL ``arch`` with ``ServeEngine.generate`` (B 4 x 2048-token
    prompts, 32 new tokens, random weights from a CUDA generator of seed 0):
    twice (each counter of ``kernels`` once per layer and call, the repeat
    bitwise), once with one new token (the prefill alone), then the
    teacher-forced check and a profiled ``generate``."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models.api import model_decode_step, model_forward, model_prefill
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    b, p, new, vocab = LM_BATCH, LM_PROMPT, LM_NEW, cfg.vocab_size
    eng, init_ms = _timed(lambda: ServeEngine(cfg, max_len=LM_MAX_LEN, device="cuda",
                                              generator=_cuda_gen(0)))
    leaves = _leaves(eng.params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[{tag}] {arch}: {cfg.num_layers} layers, d {cfg.d_model}, {n_params:,} params, "
        f"{weight_bytes / 1e9:.2f} GB of weights, made in {init_ms:.0f} ms")
    prompts = np.random.default_rng(0).integers(0, vocab, (b, p))
    want = {name: cfg.num_layers for name in kernels}
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        build.reset_launch_counts()
        out, ms = _timed(lambda: eng.generate(prompts, max_new_tokens=new))
        counts = build.launch_counts()
        runs.append((out, ms, counts))
        log(f"[{tag}] generate {i}: B={b} P={p} new={new}: {ms:.1f} ms, launches {counts}")
        if counts != want:
            raise RuntimeError(f"{tag}: generate launched {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    out = runs[0][0]
    if not torch.equal(out, runs[1][0]):
        raise RuntimeError(f"{tag}: the repeated generate differs")
    if (tuple(out.shape) != (b, p + new)
            or not torch.equal(out[:, :p].cpu(), torch.as_tensor(prompts).int())):
        raise RuntimeError(f"{tag}: bad output {tuple(out.shape)}")
    _, prefill_ms = _timed(lambda: eng.generate(prompts, max_new_tokens=1))
    gen_ms = min(r[1] for r in runs)
    decode_ms = (gen_ms - prefill_ms) / (new - 1)
    kv_bytes = sum(t.numel() * t.element_size() for c in _meta_cache(cfg, b) for t in c)
    logit_bytes = b * p * cfg.padded_vocab(1) * 4
    log(f"[{tag}] prefill {prefill_ms:.1f} ms ({b * p / prefill_ms * 1e3:,.0f} tokens/s), "
        f"decode {decode_ms:.2f} ms per token (batch {b}), peak device memory "
        f"{peak / 2**30:.2f} GiB (weights {weight_bytes / 2**30:.2f} GiB, cache "
        f"{kv_bytes / 2**30:.2f} GiB, prefill logits {logit_bytes / 2**30:.2f} GiB)")

    # Teacher forcing: the serving path's logits, fed the generated tokens
    # (prefill + decode steps, which reproduce generate's argmax exactly),
    # against one forward over the whole sequences.
    seqs = out.long()
    with torch.inference_mode():
        logits, cache, n = model_prefill(eng.params, cfg, {"tokens": seqs[:, :p]}, LM_MAX_LEN)
        finite = bool(torch.isfinite(logits).all())
        steps = [logits[:, -1, :vocab].clone()]
        del logits  # [B, P, V] f32
        for i in range(new - 1):
            lg, cache = model_decode_step(eng.params, cfg, {"tokens": seqs[:, p + i : p + i + 1]},
                                          cache, n + i)
            steps.append(lg[:, :vocab])
        served = torch.stack(steps, dim=1)  # [B, new, V]
        del cache
        fwd = model_forward(eng.params, cfg, {"tokens": seqs[:, :-1]})[0]
        finite = finite and bool(torch.isfinite(fwd).all()) and bool(torch.isfinite(served).all())
        tf = fwd[:, p - 1 :, :vocab]
        reproduced = bool(torch.equal(served.argmax(-1), seqs[:, p:]))
        agree = float((tf.argmax(-1) == seqs[:, p:]).float().mean())
        rel = float((tf - served).abs().max() / served.abs().max())
        del fwd, tf, served
    log(f"[{tag}] teacher-forced forward vs served logits: argmax agreement {agree:.4f} "
        f"(>= {TF_AGREE}), max relative difference {rel:.4g} (< {TF_REL}); served argmax "
        f"== generated tokens: {reproduced}; all logits finite: {finite}")
    if not (reproduced and finite and agree >= TF_AGREE and rel < TF_REL):
        raise RuntimeError(f"{tag}: teacher-forced check failed")

    build.reset_launch_counts()
    wall_ms, _, rows = _device_profile(lambda: eng.generate(prompts, max_new_tokens=new))
    busy = sum(ms for _, ms, _ in rows)
    if rows:
        log(f"[{tag} profile] generate wall_ms={wall_ms:.1f}, device busy {busy:.1f} ms "
            f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})")
        for name, ms, count in rows[:14]:
            log(f"[{tag} profile]   {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    else:
        log(f"[{tag} profile] generate wall_ms={wall_ms:.1f}; device time not measured")
    detail = dict(arch=arch, params=n_params, weight_bytes=weight_bytes, init_ms=init_ms,
                  generate_ms=[r[1] for r in runs], launches=runs[0][2], prefill_ms=prefill_ms,
                  prefill_tokens_per_s=b * p / prefill_ms * 1e3, decode_ms_per_token=decode_ms,
                  peak_bytes=peak, kv_cache_bytes=kv_bytes, teacher_forced_agreement=agree,
                  teacher_forced_rel_diff=rel,
                  profile=dict(wall_ms=wall_ms, device_ms=busy if rows else None,
                               top=[dict(name=nm, ms=ms, count=c) for nm, ms, c in rows[:24]]))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return detail


def _meta_cache(cfg, batch):
    """The decode cache of ``cfg`` for ``batch`` sequences, on the meta device
    (shapes and dtypes, no memory)."""
    from repro_torch.models.lm.transformer import init_cache

    return [list(c.values()) for c in init_cache(cfg, batch, LM_MAX_LEN, device="meta")]


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _kernel_case(name, kernel, plain, library, atol, rtol, nbytes, ops, peak):
    """One kernel call against its plain version: error, run-to-run bitwise,
    times and bound."""
    import torch

    out = kernel()
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out, again))
    finite = bool(torch.isfinite(out).all())
    diff = (out.float() - want.float()).abs()
    err = float(diff.max())
    close = bool((diff <= atol + rtol * want.float().abs()).all())
    del want, again
    ms = cuda_ms(kernel, reps=5)
    plain_ms = cuda_ms(plain, reps=2)
    lib_ms = lib_err = None
    if library is not None:
        lib_err = float((library().float() - out.float()).abs().max())
        lib_ms = cuda_ms(library, reps=5)
    b_ms, b_by = bound(nbytes, ops, peak)
    lib = "" if lib_ms is None else f" library_ms={lib_ms:.3f} (diff {lib_err:.3g})"
    log(f"[lm kernels] {name}: err={err:.3g} (atol {atol}, rtol {rtol}) bitwise={bitwise} "
        f"ms={ms:.3f} plain_ms={plain_ms:.3f}{lib} bound_ms={b_ms:.3f} ({b_by})")
    if not (bitwise and finite and close):
        raise RuntimeError(f"{name}: err {err}, bitwise {bitwise}, finite {finite}")
    return dict(case=name, max_abs_err=err, run_to_run_bitwise=bitwise, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops)


def phase_lm_kernels():
    """Both LM kernels against their plain versions at the served shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

    gen = _cuda_gen(5)
    flash = []
    # (label, B, S, H, KV, hd, dtype): Qwen3-8B and SmolLM-360M prefill, and a
    # sequence ragged against the kernel's 64-row blocks, in f32.
    for label, b, s, h, kv, hd, dt in (
        ("qwen3-8b prefill bf16", 4, 2048, 32, 8, 128, torch.bfloat16),
        ("smollm-360m prefill bf16", 4, 2048, 15, 5, 64, torch.bfloat16),
        ("ragged S=1000 f32", 4, 1000, 32, 8, 128, torch.float32),
    ):
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dt)
        bf16 = dt == torch.bfloat16
        variant = fa_ops.flash_variant(dt, hd)
        before = build.launch_counts().get(fa_ops.TC_KERNEL, 0)
        out = fa_ops.flash_attention(q, k, v)
        tc_ran = build.launch_counts().get(fa_ops.TC_KERNEL, 0) - before
        equal = float((out == flash_attention_ref(q, k, v)).float().mean())
        del out
        pairs = s * (s + 1) // 2  # (query, key) pairs the causal mask keeps, S == T
        row = _kernel_case(
            f"flash_attention {label} B={b} S={s} H={h} KV={kv} hd={hd}",
            lambda: fa_ops.flash_attention(q, k, v),
            lambda: flash_attention_ref(q, k, v),
            # top-left causal == end-aligned causal when S == T
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True).transpose(1, 2),
            FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL, 0.0 if bf16 else FLASH_F32_ATOL,
            nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(),
            ops=4.0 * b * h * hd * pairs, peak=BF16_FLOPS if bf16 else FP32_FLOPS)
        row.update(b=b, s=s, h=h, kv=kv, hd=hd, dtype=str(dt), variant=variant,
                   equal_share=equal, vs_library=row["ms"] / row["library_ms"],
                   vs_bound=row["ms"] / row["bound_ms"])
        log(f"[lm kernels]   variant {variant} (tensor-core launches {tc_ran}); bitwise equal "
            f"to the plain version: {equal:.5f} of entries; {row['vs_library']:.2f}x SDPA, "
            f"{row['vs_bound']:.2f}x the bound")
        if tc_ran != int(bf16 and hd in fa_ops.TC_HEAD_DIMS):  # served bf16 widths: tensor cores
            raise RuntimeError(f"flash {label}: variant {variant}, tensor-core launches {tc_ran}")
        if bf16 and not equal >= FLASH_BF16_EQUAL:
            raise RuntimeError(f"flash {label}: only {equal:.5f} of bf16 entries equal the plain "
                               f"version's (< {FLASH_BF16_EQUAL})")
        flash.append(row)
        del q, k, v
        torch.cuda.empty_cache()

    ssd = []
    for label, b, nc, q_, n, h, p in (("mamba2-370m prefill", 4, 8, 256, 128, 32, 64),
                                      ("ragged chunk Q=200", 4, 2, 200, 128, 32, 64)):
        cc = torch.randn((b, nc, q_, n), generator=gen, device="cuda")
        bc = torch.randn((b, nc, q_, n), generator=gen, device="cuda")
        xdt = torch.randn((b, nc, h, q_, p), generator=gen, device="cuda")
        # a realistic decreasing log-decay, as tests/test_kernels_ssd.py:24
        acum = -torch.cumsum(torch.rand((b, nc, h, q_), generator=gen, device="cuda") * 0.05, -1)
        pairs = q_ * (q_ + 1) // 2  # (i, j) pairs with i >= j
        # C Bᵀ once per (b, c) and the weighted P·V per head, lower triangle
        ops = 2.0 * b * nc * pairs * (n + h * p)
        nbytes = (cc.numel() + bc.numel() + 2 * xdt.numel() + acum.numel()) * 4
        # the bound: the bytes, or the three TF32 products of the split at
        # the TF32 peak; beside it the f32 CUDA-core bound of PR 13-15
        row = _kernel_case(
            f"ssd_intra_chunk {label} B={b} NC={nc} Q={q_} N={n} H={h} P={p}",
            lambda: ssd_ops.ssd_intra_chunk(cc, bc, xdt, acum),
            lambda: ssd_intra_chunk_ref(cc, bc, xdt, acum),
            None, SSD_ATOL, SSD_RTOL, nbytes=nbytes, ops=3 * ops, peak=TF32_FLOPS)
        f32_ms, f32_by = bound(nbytes, ops, FP32_FLOPS)
        row.update(b=b, nc=nc, q=q_, n=n, h=h, p=p, f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                   tflops=ops / row["ms"] / 1e9)
        log(f"[lm kernels]   {ops / 1e9:.2f} GFLOP at {row['tflops']:.1f} TFLOP/s; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; three TF32 products at "
            f"{TF32_FLOPS / 1e12:.1f} TFLOP/s: {3 * ops / TF32_FLOPS * 1e3:.4f} ms), f32 "
            f"CUDA-core bound {f32_ms:.4f} ms ({f32_by}); {row['ms'] / row['bound_ms']:.2f}x "
            f"the bound")
        ssd.append(row)
        del cc, bc, xdt, acum
        torch.cuda.empty_cache()
    return flash, ssd


def phase_lm_cpu():
    """REDUCED qwen3-8b and mamba2-370m served on the CPU (plain versions)
    against the card: the same tokens, prefill logits within atol 5e-4,
    rtol 1e-3."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.api import model_prefill, params_to
    from repro_torch.serve.engine import ServeEngine

    rows = []
    for arch, kernel in (("qwen3-8b", fa_ops.KERNEL), ("mamba2-370m", ssd_ops.KERNEL)):
        cfg = get_config(arch, reduced=True)
        card = ServeEngine(cfg, max_len=64, device="cuda", generator=_cuda_gen(0))
        cpu = ServeEngine(cfg, params_to(card.params, "cpu"), max_len=64, device="cpu")
        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
        build.reset_launch_counts()
        got = card.generate(prompts, max_new_tokens=8)
        counts = build.launch_counts()
        same = bool(torch.equal(got.cpu(), cpu.generate(prompts, max_new_tokens=8)))
        toks = torch.as_tensor(prompts)
        want = model_prefill(cpu.params, cfg, {"tokens": toks}, 64)[0]
        lg = model_prefill(card.params, cfg, {"tokens": toks.cuda()}, 64)[0].cpu()
        diff = (lg - want).abs()
        err = float(diff.max())
        close = bool((diff <= LM_CPU_ATOL + LM_CPU_RTOL * want.abs()).all())
        log(f"[lm cpu] {arch} REDUCED: card launches {counts}, tokens equal {same}, prefill "
            f"logits max abs diff {err:.3g} (atol {LM_CPU_ATOL}, rtol {LM_CPU_RTOL}: {close})")
        if counts != {kernel: cfg.num_layers} or not same or not close:
            raise RuntimeError(f"lm cpu {arch}: launches {counts}, tokens equal {same}, err {err}")
        rows.append(dict(arch=arch, launches=counts, tokens_equal=same, max_abs_diff=err))
    return rows


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls accumulate in f32 (as XLA's do), with no reduced-precision
    # split-K reduction.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    log(f"[env] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    from repro_torch.configs.base import get_config
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.models.gnn import api as gnn_api

    report = phase_build()
    cfg = get_config("ample-gcn")
    t0 = time.perf_counter()
    g = make_dataset("yelp", max_feature_dim=cfg.d_model, seed=0)
    batch_graphs = [make_dataset("cora", max_feature_dim=cfg.d_model, seed=s) for s in (1, 2, 3)]
    log(f"[data] yelp {g.num_nodes} nodes {g.num_edges} edges, "
        f"generated in {time.perf_counter() - t0:.1f} s")
    with _count_calls("repro_torch.core.quantization", "dequantize") as dequantized:
        srv, outs, batch, counts, peak = phase_path(
            cfg, g, batch_graphs, {"segment_agg": 4, "quant_matmul": 2})
        profile_row = phase_profile(srv, g)
    log(f"[path] dequantize calls during the requests: {dequantized[0]}")
    if dequantized[0]:
        raise RuntimeError("the GCN requests dequantized the int8 group before the AGE")
    check_gcn_profile(profile_row)

    entry = _yelp_engine(srv, g)
    mode = gnn_api.agg_mode(cfg)
    x300 = torch.from_numpy(srv._pad_features(g.features, entry.graph.num_nodes)).cuda()
    age_rows = phase_age(entry, mode, x300)
    m = int(entry.node_groups["int8"].size)
    del x300
    gemm_rows = phase_gemm(m)
    cora = make_dataset("cora", max_feature_dim=cfg.d_model, seed=4)
    cpu_row = phase_cpu(srv, cfg, cora)
    del srv, entry
    gc.collect()
    torch.cuda.empty_cache()

    gat_cfg = get_config("ample-gat")
    with _count_calls("repro_torch.core.aggregation", "tile_edge_coeff") as scatters:
        gsrv, gouts, gbatch, gcounts, gpeak = phase_path(
            gat_cfg, g, batch_graphs, {"attention": 4, "quant_matmul": 2}, tag="gat path")
        gprofile_row = phase_profile(gsrv, g, tag="gat profile")
    log(f"[gat path] per-edge operands scattered into tile layout: {scatters[0]} times")
    if scatters[0]:
        raise RuntimeError("the GAT requests gathered per-edge operands into tile layout")
    if gpeak >= 20 * 2**30:
        raise RuntimeError(f"GAT path peak device memory {gpeak / 2**30:.2f} GiB >= 20 GiB")
    gentry = _yelp_engine(gsrv, g)
    dec_row = phase_gat_decomposed(gentry)
    attn_rows, mh_rows = phase_gat_kernels(gentry)
    gcpu_row = phase_cpu(gsrv, gat_cfg, cora, tag="gat cpu")
    del gsrv, gentry
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    lm_row = phase_lm_path("qwen3-8b", (fa_ops.KERNEL, fa_ops.TC_KERNEL), "lm path")
    ssm_row = phase_lm_path("mamba2-370m", (ssd_ops.KERNEL,), "ssm path")
    flash_rows, ssd_rows = phase_lm_kernels()
    lm_cpu_rows = phase_lm_cpu()

    def kernel_row(name, source, replaces, launches, row, shape):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"], shape=shape)

    # The largest call of each kernel on its path: the int8 group, at D = 300
    # on the rows the path hands it (AGE), K = 300 (GEMM), and H·dh = 4·100
    # (GAT layer 2).
    age = next(r for r in age_rows
               if r["group"] == "int8" and r["d"] == 300 and r["rows"] == AGE_PATH_ROWS)
    gemm = gemm_rows[0]
    # The GAT kernels' int8 group gathers int8 codes on the path.
    attn = next(r for r in attn_rows
                if r["group"] == "int8" and r["dh"] == 100 and r["rows"] == "int8")
    mh = next(r for r in mh_rows
              if r["group"] == "int8" and r["dh"] == 100 and r["rows"] == "int8")
    gat_shape = "int8 group T={tiles} E={lanes} N={n} H={heads} dh={dh}, {rows} rows"
    kernels = [
        kernel_row("segment_agg", "src/repro_torch/csrc/segment_agg.cu",
                   "src/repro/kernels/segment_agg/segment_agg.py:135",
                   counts.get("segment_agg", 0), age,
                   f"int8 group T={age['tiles']} E={age['lanes']} N={age['n']} D={age['d']}, "
                   f"{age['rows']} rows"),
        kernel_row("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
                   "src/repro/kernels/quant_matmul/repack.py:108",
                   counts.get("quant_matmul", 0), gemm,
                   f"M={gemm['m']} K={gemm['k']} N={gemm['n']}"),
        kernel_row("attention", "src/repro_torch/csrc/attn_agg.cu",
                   "src/repro/kernels/segment_agg/attn_kernel.py:194",
                   gcounts.get("attention", 0), attn, gat_shape.format(**attn)),
        kernel_row("segment_agg_mh", "src/repro_torch/csrc/attn_agg.cu",
                   "src/repro/kernels/segment_agg/attn_kernel.py:239",
                   dec_row["launches"].get("segment_agg_mh", 0), mh, gat_shape.format(**mh)),
        # Launches: one Qwen3-8B / Mamba2-370M generate (B 4 x 2048 + 32 tokens).
        # Every launch of the path went through the tensor-core variant.
        dict(kernel_row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:95",
                        lm_row["launches"].get(fa_ops.KERNEL, 0), flash_rows[0],
                        "B={b} S={s} H={h} KV={kv} hd={hd} {dtype}".format(**flash_rows[0])),
             variant=flash_rows[0]["variant"],
             tensor_core_launches=lm_row["launches"].get(fa_ops.TC_KERNEL, 0)),
        dict(kernel_row("ssd_intra_chunk", "src/repro_torch/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan/ssd_scan.py:52",
                        ssm_row["launches"].get(ssd_ops.KERNEL, 0), ssd_rows[0],
                        "B={b} NC={nc} Q={q} N={n} H={h} P={p} f32".format(**ssd_rows[0])),
             f32_bound_ms=ssd_rows[0]["f32_bound_ms"]),
    ]

    def path_detail(outs, batch, counts, peak):
        return dict(requests=[dict(cache_hit=r.cache_hit, plan_ms=r.plan_ms, run_ms=r.run_ms)
                              for r in outs],
                    batch=dict(plan_ms=batch[0].plan_ms, run_ms=batch[0].run_ms,
                               nodes=sum(b.num_nodes for b in batch_graphs)),
                    launches=counts, peak_bytes=peak, yelp_nodes=g.num_nodes,
                    yelp_edges=g.num_edges)

    details = dict(
        card=card, device=torch.cuda.get_device_name(0), torch=torch.__version__,
        build_seconds=report.seconds, ptxas=report.ptxas_log,
        path=path_detail(outs, batch, counts, peak), profile=profile_row,
        segment_agg=age_rows, quant_matmul=gemm_rows, cpu=cpu_row,
        gat_path=path_detail(gouts, gbatch, gcounts, gpeak), gat_profile=gprofile_row,
        gat_decomposed=dec_row, attention=attn_rows, segment_agg_mh=mh_rows, gat_cpu=gcpu_row,
        lm_path=lm_row, ssm_path=ssm_row, flash_attention=flash_rows, ssd_intra_chunk=ssd_rows,
        lm_cpu=lm_cpu_rows,
        seconds=time.perf_counter() - t_start,
    )
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    log(f"[done] {details['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
