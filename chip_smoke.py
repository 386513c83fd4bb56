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
             walk of the AGE and the GAT kernels, the SSD kernels and both
             pairs of flash backward kernels must not spill);
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
             codes, at D 300 also at the path's row stride of 304 bytes; int8
             matmul bitwise), timed with CUDA events beside
             the plain version, one PyTorch library call and the card's bound
             (the int8 matmul's ratio to ``torch._int_mm`` printed);
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
9. gin path, sage path — the same for FULL ``ample-gin`` and ``ample-sage``
             (sum and mean coefficients on the raw graph): each request must
             launch the AGE 4 times and the int8 matmul 4 (GIN) or 6 (SAGE)
             times, warm == cold bitwise, outputs finite and [716847, 100],
             no ``dequantize`` call; then ``infer_batch``, a profiled warm
             request, and the CPU against the card on a cora-sized graph
             (gin cpu, sage cpu);
10. baseline — the event-driven AGE (``aggregate_edge_tiles``) against the
             double-buffered baseline (``aggregate_padded_plan``, plain
             PyTorch) on the full pubmed graph at 128 features, within 1e-4,
             timed, with the lane occupancy and the pipeline-gap ratio; then
             ``occupancy_report()`` of pubmed and of the Yelp GIN engine
             (Yelp's only when the padded plan's host arrays fit in 4 GB);
11. trace  — one warm Yelp GCN request with the trace recorder enabled: its
             outputs bitwise equal to the untraced warm request's, the
             ``queue``, ``plan`` and ``execute`` spans present, in that order
             without overlap, inside the request's own wall-clock window;
             ``execute`` within 1 ms of run_ms and ``plan`` covering plan_ms
             (consistency: the engine takes both from the spans' stamps);
             the request's wall time split into queue, plan, execute and
             the remainder (the padding and the output download timed alone
             beside it);
             the Chrome trace goes to ``chiprun_out/trace_gcn_request.json``;
12. lm path — FULL ``qwen3-8b`` (36 layers, d 4096, GQA 32/8, hd 128, bf16,
             random weights from a CUDA generator of seed 0) through
             ``ServeEngine.generate``: 4 prompts of 2048 tokens (numpy seed
             0), 32 new tokens, twice (36 flash-attention launches each, all
             on the tensor-core kernel; the repeat bitwise), once with one new
             token (prefill time); then the serving path's logits, fed the
             generated tokens, against one teacher-forced ``model_forward``
             (argmax agreement >= 0.9, max relative difference < 0.05, all
             finite), and a profiled ``generate``;
13. ssm path — the same for FULL ``mamba2-370m`` (48 SSD launches each);
    moe path — the same for FULL ``granite-moe-3b-a800m`` (32 layers, 40
             experts top-8, GQA 24/8, hd 64: 32 flash launches each, all on
             the tensor-core kernel), with each MoE layer's capacity,
             dropped fraction and expert loads of one prefill and one decode
             step; the teacher-forced check runs on an engine at capacity
             factor E / k (no slot drops: decode's B tokens and the forward's
             B x S would drop different slots at the config's factor), on
             the tokens that engine generates: the free forward within
             0.05 relative difference at every position before its
             sequence's first flipped route, each flip at a router margin
             under 0.02 (bf16 rounding flips the near-ties of random
             routers), then the forward routed as the serving path routed
             each token within the bounds above; decode is printed beside
             its weight-read floor (every weight but an untied embedding
             table once a step, at 3.35 TB/s: the capacity dispatch runs
             every expert);
    moe interleaved path — ``llama4-maverick-400b-a17b`` at its published
             widths, cut to one ``(attn, dense), (attn, moe)`` unit (2 of 48
             layers: 800 GB of bf16 weights do not fit the card): 2 flash
             launches each; the teacher-forced check at B 1 x 512 (no-drop
             expert buffers of B 4 x 2048 do not fit beside the weights);
    hybrid path — ``jamba-v0.1-52b`` at its published widths, cut to one
             unit of 8 roles (8 of 32 layers): 1 flash and 7 SSD launches
             each (N 16, 128 heads);
    vlm path — FULL ``qwen2-vl-7b`` (28 layers, d 3584, GQA 28/4, hd 128)
             on embeds: B 4 x 2,048 f32 embeds (numpy seed 0) over Qwen2-VL's
             M-RoPE streams (64 text positions, one 32 x 32 image grid, 960
             text positions), ``model_prefill`` then 31 greedy decode steps,
             twice (28 flash launches each, the repeat bitwise); the served
             logits against one teacher-forced ``model_forward`` over the
             embeds and the generated tokens' embedding rows, positions
             extended at ``cache_len`` on all three streams (the bounds of
             ``lm path``); a profiled run; a text-only ``ServeEngine.generate``;
    encdec path — FULL ``seamless-m4t-medium`` (12 + 12 layers, d 1024):
             B 4 x 1,024 f32 source frames and a 4-token target prefix
             through ``model_prefill`` and 31 ``model_decode_step``s, twice
             (flash causal 12 and unmasked 24 a prefill, unmasked 12 a decode
             step; the repeat bitwise); decoding the 36 target tokens from
             ``model_init_cache`` against one teacher-forced ``model_forward``
             (the bounds of ``lm path``); the served path's gap to it (the
             reference's prefill leaves the self K/V empty) logged; prefill
             and decode ms beside their floors; a profiled run;
14. lm kernels — flash attention (Qwen3-8B, SmolLM-360M, Granite-MoE,
             Llama-4 Maverick and Qwen2-VL-7B prefill in bf16 on the
             tensor-core kernel, within 1.6e-2 and >= 99% of the bf16 entries
             bitwise equal to the plain version's; a ragged S = 1000 in f32 on
             the CUDA-core kernel within 1e-4; unmasked: the Seamless encoder
             (S = T = 1,024), its cross-attention (S 36 and S 1 over T 1,024)
             in bf16 and a ragged f32 case) and
             the SSD intra-chunk term (Mamba2-370M and Jamba prefill and a
             ragged chunk, within 1e-4 of the plain version run with TF32
             off) against their plain versions, run-to-run bitwise, timed
             beside the plain version, the bound and, for flash, one
             ``scaled_dot_product_attention`` call (variant and ratios to
             SDPA and to the bound printed; the SSD's bound counts its three
             TF32 products at the TF32 peak, and the f32 CUDA-core bound is
             printed beside it);
    lm train — FULL ``qwen2-1.5b`` (28 layers, d 1,536, GQA 12/2, hd 128,
             vocab 151,936, tied: 1,543,714,304 params, bf16, AdamW's f32
             moments, no cut) trained through ``train.loop.Trainer`` (the
             code under ``python -m repro_torch.launch.train``) on
             ``synthetic_batch(seed=0)`` batches of B 4 x 2,048 tokens: two
             2-step runs from seed 0 bitwise equal; 4 steps with loss, ce,
             grad_norm, lr, forward / backward / optimiser ms (CUDA events),
             tokens/s, peak memory and the flash launches of each (28 forward
             on the tensor cores, 28 of each backward kernel, all on the
             tensor-core pair); the model-flop
             share (6 N tokens / step / 989 TFLOP/s, and with attention); one
             profiled warm step; the card against the CPU at full width cut
             to 2 layers, B 1 x 256 (loss and ce within 1e-2 relative, every
             gradient leaf within 5e-2 of its largest CPU magnitude, the
             CPU's bf16 against its f32 printed beside); crash after step 3
             and resume to 6 at 2 layers, B 2 x 512, a checkpoint every 3
             steps, bitwise the straight run, each checkpoint's bytes, a save
             and a restore timed, under a temporary directory removed after;
             the launcher's default (``launch.train.main``: REDUCED, f32)
             for 3 steps, its backward on the CUDA-core pair;
    flash bwd — the backward (``csrc/flash_attention_bwd.cu``) through its
             wrapper against ``flash_attention_bwd_ref`` at Qwen2-1.5B's
             training shape, SmolLM-360M's (hd 64, GQA 15/5), the REDUCED
             configs' hd 20 in f32, an unmasked cross shape (S 36 over T
             1,024) and a ragged T of 1,000: every bf16 case on the
             tensor-core pair, the f32 one on the CUDA-core pair; within 2^-7
             (bf16) or 1e-4 (f32) of each gradient's largest magnitude,
             run-to-run bitwise; each kernel of each pair the case runs
             timed beside its bound, the pairs in turns (CUDA-core,
             tensor-core, tensor-core, CUDA-core), beside the plain version,
             the bound (2.5x the forward's operations) and one
             ``torch.autograd.grad`` of ``scaled_dot_product_attention``; the
             forward's lse against ``flash_attention_lse_ref`` (1e-4), its
             output bitwise the output without lse;
    ssm train — the ``lm train`` phase for FULL ``mamba2-370m`` (48 layers,
             d 1,024, state 128, 32 heads of 64: 368,338,432 params, bf16),
             B 4 x 2,048: 48 SSD forward and 48 backward launches
             (``csrc/ssd_scan_bwd.cu``) a step, the runs and crash-and-resume
             bitwise, the card against the CPU, the launcher's REDUCED
             default; both phases also give the model-flop share by
             ``launch/analytic.step_flops`` (the SSD's quadratic terms in);
    hybrid train — REDUCED ``jamba-v0.1-52b`` (f32, 8 layers: 7 SSD, flash
             on the CUDA-core pair, MoE) through the Trainer, 3 steps of B 4
             x 512 with their launches, one ``loss_fn`` gradient against the
             CPU's at atol 5e-4, rtol 1e-3 (FULL Jamba's weights, grads and
             moments do not fit one card);
    ssd bwd — the SSD backward through its wrapper against
             ``ssd_intra_chunk_bwd_ref`` at Mamba2-370M's and Jamba's training
             shapes, a ragged chunk of 200 and the REDUCED launcher's P 16:
             within 1e-4 of each gradient's largest magnitude, run-to-run
             bitwise, all finite, bitwise the same on the layer's permuted dY
             view; timed beside the plain backward, ``torch.autograd.grad``
             through the plain forward and both bounds (bytes against the
             three TF32 products, and the f32 CUDA-core peak), each of its
             three kernels' ms a call from a profiled run, the permuted dY
             read at its strides against a contiguous copy;
    serve cli — ``launch.serve.main`` on the card: REDUCED ``ample-gcn``
             (3 requests: one cold plan, then cache hits, bitwise) and FULL
             ``mamba2-370m`` (8 new tokens, 48 SSD launches);
15. lm cpu — REDUCED ``qwen3-8b``, ``mamba2-370m``, ``granite-moe-3b-a800m``,
             ``llama4-maverick-400b-a17b``, ``jamba-v0.1-52b`` and
             ``qwen2-vl-7b`` served on the CPU against the card: each kernel
             launched once per layer of its mixer, the same tokens, prefill
             logits within 5e-4; REDUCED ``seamless-m4t-medium`` through
             ``model_prefill`` and two decode steps, logits and cache leaves;
16. h2d — the copy rate of one f32 and one int8 Yelp chunk from page-locked
             and from pageable host memory (CUDA events, 200 copies);
    outofcore gcn — the GCN path's engine (plans warm) serves the Yelp
             request with ``feature_budget_bytes = features.nbytes // 8``
             (4,096-row chunks, 176 chunks, 21 f32 and 87 int8 slots): the
             features stay in page-locked host memory and stream through the
             chunk prefetcher, one request at prefetch depth 2 and one at
             depth 0 (each builds its stream programs; a second request
             that replays them is a ``gpu`` test at cora size, since a
             Yelp one costs 43-84 s across hosts); each bitwise the
             in-memory output, with the AGE and the int8 GEMM launched and a
             peak device memory below the in-memory request's (measured
             just before); per request the launches, bytes_streamed, hit
             rate, uploads, sparse rows, copy_ms, stall_ms,
             prefetch_overlap and run_ms are printed; then ``outofcore
             gin``/``sage``/``gat`` after their paths, at depth 2 and 0;
17. fronts — FULL ``ample-gcn``: 16 requests (pubmed-sized and cora-sized,
             seeds 0-7, interleaved) through ``AsyncGNNEngine`` (window 8,
             the config's union buckets): completions in submission order,
             each window bitwise ``infer_batch`` of its composition, its AGE
             and GEMM launches printed; then a ``TenantRouter`` (gold weight
             3 at priority 1, bronze weight 1) on the same requests, every
             logged window replayed directly bitwise, per-tenant p50/p99
             latency, requests/s and nodes/s from its telemetry;
    sharded gcn — after the fronts, the GCN path's params served over 4
             edge-balanced shards of Yelp (``num_shards=4``): cold, warm,
             warm, warm == cold bitwise, the AGE once per shard, precision
             group and layer (16) and the int8 matmul twice a request,
             within the mixed tolerance of the unsharded output; per-shard
             plan_ms, edge balance, halo rows and bytes, warm run_ms beside
             the unsharded one, peak memory;
    plan store — ``save_plan_cache`` of the unsharded and the sharded Yelp
             engines, ``load_plan_cache`` into fresh engines with the same
             params: the first request a cache hit, plan_ms 0.0, bitwise;
             the load seconds beside the cold plan_ms;
    sharded overlap — the same sharded engine with ``halo_overlap=True``,
             its shard plans loaded from the saved cache: bitwise the
             unsplit output, the AGE launched per non-empty half (counted
             on the host from the plans), every exchange split; halo_ms,
             halo_wait_ms and halo_overlap;
    sharded mincut — a 200,000-node clustered graph (communities shuffled
             in node order), 4 shards under ``edges`` and ``mincut``, each
             with and without overlap: the halo volumes, the reduction and
             the partition seconds, overlap bitwise unsplit, each within the
             mixed tolerance of unsharded;
    sharded gat — after the GAT path, FULL ``ample-gat`` over 4 shards:
             the multi-head AGE on every request (the denominators and the
             weighted aggregate), no fused attention, warm == cold, within
             the mixed tolerance of unsharded, peak under 20 GiB;
    qat gcn — after sharded mincut, Degree-Quant training of FULL
             ``ample-gcn`` on the Yelp graph with self-loops (planted labels
             over 100 classes, half the nodes for training, weights from
             seed 0, a numpy protection mask a step): the transposed plan's
             compile seconds, 10 steps of ``examples/train_gcn_degreequant_torch``'s
             loss and AdamW with forward, backward and optimiser ms (CUDA
             events), 3 AGE launches each (two forward, one backward on the
             transposed plan), peak memory, one profiled step; two runs of
             3 steps bitwise equal; the float and deployed int8 test
             accuracies (6 AGE and 2 GEMM launches); the backward AGE at
             D 256 bitwise the CPU's plain version and run to run, timed
             beside the plain version, ``torch.sparse.mm`` on the CSR of Aᵀ
             and the bound; on pubmed (19,717 nodes, full width) the step-0
             loss and gradients and the mixed-precision scale gradient on
             the card against the CPU (atol 5e-4, rtol 1e-3); the example at
             its defaults (800 nodes, 300 steps) on the card and the CPU,
             each accuracy within 0.03;
18. summary — a JSON line of kernels (the AGE and the int8 matmul with their
             launches per GNN path, per streamed request and per sharded
             request, the AGE's per QAT step and its backward's times; the
             multi-head AGE per sharded GAT request; flash
             attention and the SSD per LM path, each backward per training
             step), the card's name and power limit, and the result line.

The int8 matmul is also held bitwise at GIN's and SAGE's K x N (300 x 300,
256 x 256, 100 x 100). Each phase prints its seconds.

Details of every measurement also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
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
# The widest router-probability margin (k-th - (k+1)-th expert) at which the
# no-drop forward may route a token otherwise than the serving path: a near-tie
# that the bf16 rounding differing between decode and the forward can flip,
# also in the layers above an earlier flip of the same token. About twice the
# widest flip on an H100 (0.011, Jamba) and under the median margin of
# Jamba's 16-expert router (0.027).
ROUTE_TIE = 0.02
LM_CPU_ATOL, LM_CPU_RTOL = 5e-4, 1e-3  # f32 paths, tests/test_gnn_models.py:46
# VLM traffic (numpy seed 0): B 4 prompts of unit-normal f32 embeds over
# Qwen2-VL's M-RoPE streams: 64 text positions, one 32 x 32 image grid (1,024
# patches: t fixed, h and w advancing) and 960 text positions (2,048 in all).
VLM_TEXT0, VLM_GRID, VLM_TEXT1 = 64, 32, 960
VLM_TEXT_PROMPT = 256  # the text-only ServeEngine.generate: B 4 x 256 tokens, 8 new
# Enc-dec traffic (numpy seed 0): B 4, 1,024 unit-normal f32 source frames,
# a 4-token target prefix, 32 new tokens (36 target tokens in all).
ENC_SRC, ENC_PREFIX = 1024, 4


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
# (AGE and GAT), the SSD's two kernels, its backward's two and both pairs
# of flash's backward kernels (CUDA cores, tensor cores).
NO_SPILL = ("flash_tc_kernel", "quant_matmul_kernel", "heads_walk_kernel", "ssd_cb_kernel",
            "ssd_tc_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
            "flash_bwd_tc_dq_kernel", "flash_bwd_tc_dkdv_kernel", "ssd_bwd_dwdx_kernel",
            "ssd_bwd_dcdb_kernel")
# The rows the GNN paths' int8 group hands the AGE at D 300 (phase_age's row
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


def _device_profile(fn, warmup: int = 0):
    """Run ``fn`` once under torch.profiler: (wall ms, result, rows of
    (device op, ms, count) sorted by device time). Rows are device-side events
    only (kernels, copies, memsets): an operator's own entry repeats the
    device time of the kernels it launched. ``warmup`` earlier calls of
    ``fn`` run under the profiler unrecorded: a session whose device work
    starts at once loses its first kernels otherwise."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    warm = dict(schedule=schedule(wait=0, warmup=warmup, active=1)) if warmup else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **warm) as prof:
        for _ in range(warmup):
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    return wall_ms, result, _device_rows(prof)


def _device_rows(prof):
    """(device op, ms, count) of a finished torch.profiler session's
    device-side events (kernels, copies, memsets), summed by name, longest
    first. Read from the profiler's raw events: building its event tree
    (``key_averages``) costs Python work for every event, and a profiled LM
    generate records one for each operator and kernel of every decode step.
    A schedule's step span ("ProfilerStep*") and user annotations on the
    device only cover other events."""
    from torch.autograd import DeviceType

    totals = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or name.startswith("ProfilerStep")):
            continue
        ms, count = totals.get(name, (0.0, 0))
        totals[name] = (ms + (e.end_ns() - e.start_ns()) / 1e6, count + 1)
    return sorted(((name, ms, count) for name, (ms, count) in totals.items() if ms > 0),
                  key=lambda r: -r[1])


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
    # GCN and GAT's shapes, an unaligned K, GIN's and SAGE's new shapes
    # (SAGE's φ 300 x 300 and 256 x 256, GIN's last linear 100 x 100), then
    # the extremes
    for k, n, fill in ((300, 256, None), (256, 100, None), (256, 400, None), (130, 256, None),
                       (300, 300, None), (256, 256, None), (100, 100, None),
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
        # torch._int_mm on zero-padded copies: cuBLASLt refused K 104 and
        # K 112 (with N 104, 112) and took every K >= 128 the paths use
        kp, np_ = max(-(-k // 16) * 16, 128), -(-n // 16) * 16
        a8 = torch.zeros((m, kp), dtype=torch.int8, device="cuda")
        a8[:, :k] = a
        w8 = torch.zeros((kp, np_), dtype=torch.int8, device="cuda")
        w8[:k, :n] = w
        lib_ms = cuda_ms(lambda: torch._int_mm(a8, w8), reps=5)
        nbytes = m * k + k * n + m * n * 4
        b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS)
        row = dict(m=m, k=k, n=n, fill=fill, max_abs_err=err, bitwise=exact, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, library_shape=(m, kp, np_),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        rows.append(row)
        log(f"[kernels] quant_matmul M={m} K={k} N={n}"
            f"{' all -128' if fill is not None else ''}: bitwise={exact} ms={ms:.3f} "
            f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} (K {kp} N {np_}) bound_ms="
            f"{b_ms:.3f} ({b_by}); {ms / lib_ms:.3f}x torch._int_mm, {ms / b_ms:.2f}x the bound")
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


def phase_baseline(gin_engine):
    """The event-driven AGE against the double-buffered baseline on the full
    pubmed graph (19,717 nodes, 128 features, as benchmarks/run.py:126-155
    does), then the occupancy reports."""
    import numpy as np
    import torch

    from repro_torch.core.aggregation import (
        aggregate_edge_tiles,
        aggregate_padded_plan,
        to_device_plan,
    )
    from repro_torch.core.message_passing import AmpleEngine
    from repro_torch.core.scheduler import build_edge_tile_plan, build_padded_plan
    from repro_torch.graphs.datasets import make_dataset

    g = make_dataset("pubmed", max_feature_dim=128, seed=0)
    x = torch.from_numpy(g.features).cuda()
    plan = build_edge_tile_plan(g, edges_per_tile=256)
    dplan = to_device_plan(plan, x.device)
    padded = build_padded_plan(g, batch_size=64)
    event = aggregate_edge_tiles(x, dplan, num_nodes=g.num_nodes)
    base = aggregate_padded_plan(x, padded)
    torch.cuda.synchronize()
    err = float((event - base).abs().max())
    ev_ms = cuda_ms(lambda: aggregate_edge_tiles(x, dplan, num_nodes=g.num_nodes), reps=5)
    pad_ms = cuda_ms(lambda: aggregate_padded_plan(x, padded), reps=2)
    occ, gap = plan.lane_occupancy, padded.pipeline_gap_ratio
    log(f"[baseline] pubmed N={g.num_nodes} E={g.num_edges} D=128: aggregate_edge_tiles "
        f"{ev_ms:.3f} ms (lane_occupancy {occ:.4f}), aggregate_padded_plan {pad_ms:.3f} ms "
        f"({len(padded.batches)} batches of 64, pipeline_gap_ratio {gap:.4f}); baseline / "
        f"event-driven {pad_ms / ev_ms:.2f}x; max abs diff {err:.3g} (atol {AGE_ATOL})")
    if not err <= AGE_ATOL:
        raise RuntimeError(f"baseline and event-driven aggregation differ by {err}")
    row = dict(nodes=g.num_nodes, edges=g.num_edges, d=128, event_ms=ev_ms, padded_ms=pad_ms,
               ratio=pad_ms / ev_ms, lane_occupancy=occ, pipeline_gap_ratio=gap,
               max_abs_diff=err)

    pub = AmpleEngine(g, gin_engine.cfg).occupancy_report()
    log(f"[baseline] occupancy_report, pubmed: {pub}")
    row["occupancy_pubmed"] = pub
    # The padded plan's host arrays (int32 gather + f32 coeff per lane)
    # for the Yelp GIN engine's graph, reckoned before building them.
    deg = gin_engine.graph.degrees
    batches = np.maximum.reduceat(deg, np.arange(0, deg.size, 64)).clip(min=1)
    sizes = np.diff(np.append(np.arange(0, deg.size, 64), deg.size))
    host_bytes = int((batches * sizes).sum()) * 8
    log(f"[baseline] Yelp GIN padded plan: {host_bytes / 1e9:.2f} GB of host arrays")
    row["yelp_padded_host_bytes"] = host_bytes
    if host_bytes > 4e9:
        log("[baseline] over 4 GB: Yelp's occupancy_report not built; pubmed's stands alone")
    else:
        t0 = time.perf_counter()
        yelp = gin_engine.occupancy_report()
        log(f"[baseline] occupancy_report, Yelp GIN engine ({time.perf_counter() - t0:.1f} s): "
            f"{yelp}")
        row["occupancy_yelp_gin"] = yelp
    return row


def phase_trace(srv, g, want):
    """One warm Yelp GCN request with the trace recorder enabled: spans
    against the response, and where the request's wall time goes."""
    import numpy as np
    import torch

    from repro_torch.observe import trace as otrace
    from repro_torch.serve.gnn_engine import request_stamp

    rec = otrace.enable()
    try:
        t0 = request_stamp()
        resp = srv.infer(g, g.features, admitted_at=t0)
        t_end = request_stamp()
    finally:
        otrace.disable()
    wall_ms = (t_end - t0) * 1e3
    spans = {s.name: s for s in rec.spans() if s.trace_id == resp.trace_id}
    missing = sorted({"queue", "plan", "execute"} - set(spans))
    bitwise = bool(np.array_equal(resp.outputs, want))
    ms = {k: spans[k].dur_ms for k in ("queue", "plan", "execute") if k in spans}
    rest = wall_ms - sum(ms.values())
    # Parts of the split, timed alone on the same inputs: the padding to the
    # size class (the padded-union path pads inside the plan span, as the
    # reference does) and the pageable download of the output (after the
    # execute span).
    entry = _yelp_engine(srv, g)
    t = request_stamp()
    srv._pad_features(g.features, entry.graph.num_nodes)
    pad_ms = (request_stamp() - t) * 1e3
    y = torch.zeros((entry.graph.num_nodes, resp.outputs.shape[1]), device="cuda")
    torch.cuda.synchronize()
    t = request_stamp()
    y.cpu().numpy()
    down_ms = (request_stamp() - t) * 1e3
    path = os.path.join(ROOT, "chiprun_out", "trace_gcn_request.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec.export(path)
    log(f"[trace] warm GCN request {resp.trace_id}: wall {wall_ms:.3f} ms = queue "
        f"{ms.get('queue', float('nan')):.3f} + plan {ms.get('plan', float('nan')):.3f} + "
        f"execute {ms.get('execute', float('nan')):.3f} + remainder {rest:.3f}; run_ms "
        f"{resp.run_ms:.3f}, plan_ms {resp.plan_ms:.3f}; timed alone: the padding to the size "
        f"class {pad_ms:.3f} ms (inside the plan span), the output download {down_ms:.3f} ms "
        f"(inside the remainder); bitwise equal to the untraced request: {bitwise}; "
        f"{len(rec.spans())} spans written to {os.path.relpath(path, ROOT)}")
    if missing:
        raise RuntimeError(f"traced request is missing spans {missing}")
    if not bitwise:
        raise RuntimeError("the traced request's outputs differ from the untraced one's")
    # Against this script's own clock: the spans lie in the request's window,
    # in order and without overlap (so they sum to no more than its wall time).
    order = [spans[k] for k in ("queue", "plan", "execute")]
    bounds = [t0] + [t for sp in order for t in (sp.t0, sp.t1)] + [t_end]
    if any(b < a for a, b in zip(bounds, bounds[1:])):
        raise RuntimeError(f"spans out of order or outside the request's {wall_ms:.3f} ms: "
                           f"{[(sp.name, sp.t0 - t0, sp.t1 - t0) for sp in order]}")
    # Consistency: the engine takes run_ms and plan_ms from the span stamps.
    if abs(ms["execute"] - resp.run_ms) > 1.0 or ms["plan"] < resp.plan_ms:
        raise RuntimeError(f"spans do not reconcile: execute {ms['execute']} vs run_ms "
                           f"{resp.run_ms}, plan {ms['plan']} vs plan_ms {resp.plan_ms}")
    return dict(wall_ms=wall_ms, spans_ms=ms, remainder_ms=rest, run_ms=resp.run_ms,
                plan_ms=resp.plan_ms, padding_ms=pad_ms, download_ms=down_ms,
                plan_args=spans["plan"].args, trace=os.path.relpath(path, ROOT))


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



def _streamed_line(tag, label, resp, stats, counts, peak, mem_peak):
    from repro_torch.kernels.quant_matmul import ops as qm_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops

    log(f"[{tag}] {label}: AGE {counts.get(seg_ops.KERNEL, 0)} GEMM "
        f"{counts.get(qm_ops.KERNEL, 0)} launches; bytes_streamed {stats.bytes_streamed} "
        f"({stats.bytes_streamed / 2**30:.2f} GiB) hit_rate {stats.hit_rate:.4f} "
        f"uploads {stats.uploads} (chunk misses {stats.chunk_misses}, prefetched "
        f"{stats.prefetched}, evictions {stats.evictions}) sparse rows {stats.sparse_rows} "
        f"instr_bytes {stats.instr_bytes}; copy_ms {stats.copy_ms:.1f} stall_ms "
        f"{stats.stall_ms:.1f} prefetch_overlap {stats.prefetch_overlap:.4f} run_ms "
        f"{resp.run_ms:.1f}; peak device memory {peak / 2**30:.3f} GiB (in-memory "
        f"{mem_peak / 2**30:.3f} GiB)")


def phase_h2d():
    """Host-to-device copy rates of one f32 and one int8 chunk of the Yelp
    store (4,096 x 300 rows) from page-locked and from pageable memory."""
    import torch

    rows = {}
    for nbytes in (4096 * 300 * 4, 4096 * 300):
        dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        for name, src in (("pinned", torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)),
                          ("pageable", torch.empty(nbytes, dtype=torch.uint8))):
            def copy():
                dst.copy_(src, non_blocking=True)

            ms = cuda_ms(copy, 200, warmup=3)
            rows[f"{name} {nbytes}"] = nbytes / ms / 1e6
            log(f"[h2d] {name} {nbytes} B: {ms * 1e3:.1f} us a copy, "
                f"{nbytes / ms / 1e6:.1f} GB/s")
    return rows


def phase_outofcore(srv, g, want, arch, depths):
    """Serve the Yelp request on ``srv`` (whose in-memory run gave ``want``)
    with its features on the host: budget ``features.nbytes // 8``, one
    request per prefetch depth in ``depths``; each bitwise ``want``, with a
    lower peak device memory than the in-memory request's."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.memory.prefetcher import stream_slots

    tag = f"outofcore {arch}"
    srv.feature_budget_bytes = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem = srv.infer(g, g.features)
    mem_peak = torch.cuda.max_memory_allocated()
    if mem.streamed or not np.array_equal(mem.outputs, want):
        raise RuntimeError("the in-memory request changed")
    srv.feature_budget_bytes = g.features.nbytes // 8
    rows = []
    for i, depth in enumerate(depths):
        srv.stream_prefetch_depth = depth
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        resp = srv.infer(g, g.features)
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stats = srv._last_stream
        label = f"request {i} depth {depth}" + (" (stream cold)" if stats.instr_bytes else "")
        _streamed_line(tag, label, resp, stats, counts, peak, mem_peak)
        if not resp.streamed or not np.array_equal(resp.outputs, want):
            raise RuntimeError(f"{tag}: {label} differs from the in-memory request")
        if peak >= mem_peak:
            raise RuntimeError(f"{tag}: streamed peak {peak} >= in-memory peak {mem_peak}")
        if depth == 0 and (stats.copy_ms or stats.stall_ms):
            raise RuntimeError(f"{tag}: the synchronous stream claimed overlap")
        if not 0.0 <= resp.prefetch_overlap <= 1.0:
            raise RuntimeError(f"{tag}: prefetch_overlap {resp.prefetch_overlap}")
        if arch in ("gcn", "gin") and not (counts.get("segment_agg")
                                           and counts.get("quant_matmul")):
            raise RuntimeError(f"{tag}: {label} launched {counts}")
        rows.append(dict(depth=depth, launches=counts, peak_bytes=peak, run_ms=resp.run_ms,
                         cache_hit=resp.cache_hit, **stats.as_dict()))
    store = next(iter(srv._stores.values()))[1]
    slots = {s: stream_slots(store, s, srv.feature_budget_bytes, store.num_chunks)
             for s in ("f32", "i8")}
    log(f"[{tag}] budget {srv.feature_budget_bytes} B = features.nbytes // 8; chunk rows "
        f"{store.chunk_rows}, chunks {store.num_chunks}, slots {slots}; pinned {store.pinned}; "
        "every streamed output bitwise the in-memory one")
    return dict(budget=srv.feature_budget_bytes, chunk_rows=store.chunk_rows,
                chunks=store.num_chunks, slots=slots, in_memory_peak_bytes=mem_peak,
                requests=rows)


def phase_fronts(cfg):
    """The continuous-batching and multi-tenant fronts on FULL ``cfg``."""
    import numpy as np
    import torch

    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.serve.async_gnn import AsyncGNNEngine
    from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine
    from repro_torch.serve.tenancy import TenantRouter

    traffic = []
    for s in range(8):
        traffic.append(("gold", make_dataset("pubmed", max_feature_dim=cfg.d_model, seed=s)))
        traffic.append(("bronze", make_dataset("cora", max_feature_dim=cfg.d_model, seed=s)))
    srv = GNNServeEngine(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    front = AsyncGNNEngine(srv)
    if front.window != 8:
        raise RuntimeError(f"window {front.window}, expected the config's 8")
    tickets = [front.submit(g, g.features) for _, g in traffic]
    order, windows = [], []
    t0 = time.perf_counter()
    while front.pending:
        build.reset_launch_counts()
        done = front.step()
        windows.append(([t.seq for t in done], build.launch_counts()))
        order += [t.seq for t in done]
    async_s = time.perf_counter() - t0
    if order != list(range(len(traffic))):
        raise RuntimeError(f"completion order {order} is not the submission order")
    for seqs, counts in windows:
        replay = srv.infer_batch([tickets[i].request for i in seqs])
        if not all(np.array_equal(tickets[i].response.outputs, r.outputs)
                   for i, r in zip(seqs, replay)):
            raise RuntimeError("an async window differs from infer_batch of its composition")
        nodes = sum(tickets[i].request.graph.num_nodes for i in seqs)
        log(f"[fronts] async window {seqs}: {nodes} nodes, launches {counts}, run_ms "
            f"{tickets[seqs[0]].response.run_ms:.2f}; bitwise infer_batch")
    nodes = sum(g.num_nodes for _, g in traffic)
    log(f"[fronts] async: {len(traffic)} requests ({nodes} nodes) in {async_s * 1e3:.1f} ms, "
        f"{len(traffic) / async_s:.1f} requests/s; completions in submission order")

    router = TenantRouter(AsyncGNNEngine(srv))
    router.add_tenant("gold", weight=3.0, priority=1)
    router.add_tenant("bronze", weight=1.0)
    routed = [router.submit(t, g, g.features) for t, g in traffic]
    router.drain()
    for window in router.window_log:
        members = [routed[seq] for _, seq in window]
        replay = srv.infer_batch([GNNRequest(graph=rt.graph, features=rt.features)
                                  for rt in members])
        if not all(np.array_equal(rt.response.outputs, r.outputs)
                   for rt, r in zip(members, replay)):
            raise RuntimeError("a routed window differs from its direct replay")
        log(f"[fronts] routed window {[f'{t}:{s}' for t, s in window]}: replayed bitwise")
    snap = router.telemetry.snapshot()
    for tenant, row in snap.items():
        lat = row["latency_ms"]
        log(f"[fronts] tenant {tenant}: {row['completed']} requests, latency p50 "
            f"{lat['p50']:.2f} ms p99 {lat['p99']:.2f} ms, {row['throughput_rps']:.1f} "
            f"requests/s, {row['node_throughput']:.0f} nodes/s")
    return dict(async_windows=[dict(seqs=s, launches=c) for s, c in windows],
                async_seconds=async_s, requests=len(traffic), nodes=nodes,
                window_log=[list(w) for w in router.window_log], tenants=snap)

SHARDS = 4  # the sharded phases' shard count


def _launches(fn):
    """(fn(), the kernel launches it made)."""
    from repro_torch.kernels import build

    before = build.launch_counts()
    out = fn()
    after = build.launch_counts()
    return out, {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def _mixed_close(got, want) -> float:
    """Max |got - want|; raises outside the mixed-precision tolerance."""
    import numpy as np

    err = np.abs(got - want)
    flips = float((err > MIXED_FLIP).mean())
    if not np.allclose(got, want, atol=MIXED_ATOL, rtol=MIXED_RTOL) or flips >= 0.05:
        raise RuntimeError(f"outside the mixed tolerance: max {err.max():.3e}, share of "
                           f"entries off by > {MIXED_FLIP}: {flips:.4f}")
    return float(err.max())


def _sharded_entry(srv):
    """(plan, engine) of the sharded request ``srv`` planned last."""
    from repro_torch.distributed.graph_shard import ShardedAmpleEngine

    return next((p, e) for _, p, e in reversed(list(srv._cache.values()))
                if isinstance(e, ShardedAmpleEngine))


def _age_launches(splan, mode, layers, split):
    """AGE launches of one request, counted on the host from the plans: one
    per shard, precision group and layer; split, one per non-empty half of
    each group of a shard with halo rows."""
    from repro_torch.core.scheduler import split_plan_by_halo

    n = 0
    for sp in splan.shards:
        for plan in sp.plan.mode_plans[mode].values():
            if split and sp.halo_size:
                n += sum(h.num_tiles > 0 for h in split_plan_by_halo(plan, sp.num_owned))
            else:
                n += 1
    return n * layers


def _halo_wait(srv, fn):
    """(fn(), the halo_wait_ms the engine's stats gained meanwhile)."""
    before = srv.stats["halo_wait_ms"]
    out = fn()
    return out, srv.stats["halo_wait_ms"] - before


def _serve3(srv, g, feats, tag, label):
    """Cold, warm, warm: [(response, launches, halo_wait_ms)]; warm == cold."""
    import numpy as np

    rows = []
    for i in range(3):
        (resp, counts), wait = _halo_wait(srv, lambda: _launches(lambda: srv.infer(g, feats)))
        rows.append((resp, counts, wait))
        log(f"[{tag}] {label} infer {i}: cache_hit={resp.cache_hit} plan_ms={resp.plan_ms:.1f} "
            f"run_ms={resp.run_ms:.3f} halo_bytes={resp.halo_bytes} halo_ms={resp.halo_ms:.3f} "
            f"halo_wait_ms={wait:.3f} halo_overlap={resp.halo_overlap:.3f} launches={counts}")
    for resp, _, _ in rows[1:]:
        if not resp.cache_hit or resp.plan_ms != 0.0 or not np.array_equal(
                resp.outputs, rows[0][0].outputs):
            raise RuntimeError(f"{tag}: a warm {label} request differs from the cold one")
    return rows


def _request_rows(rows):
    return [dict(cache_hit=r.cache_hit, plan_ms=r.plan_ms, run_ms=r.run_ms, halo_ms=r.halo_ms,
                 halo_wait_ms=w, halo_bytes=r.halo_bytes, halo_overlap=r.halo_overlap,
                 launches=c) for r, c, w in rows]


def phase_sharded_gcn(cfg, params, g, want, base_run_ms):
    """FULL ample-gcn on Yelp over 4 edge-balanced shards: warm == cold, the
    AGE once per shard, group and layer, within the mixed tolerance of the
    unsharded output."""
    import torch

    from repro_torch.serve.gnn_engine import GNNServeEngine

    tag = "sharded gcn"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = GNNServeEngine(cfg, params, num_shards=SHARDS, partitioner="edges", device="cuda")
    rows = _serve3(srv, g, g.features, tag, "unsplit")
    peak = torch.cuda.max_memory_allocated()
    want_age = _age_launches(_sharded_entry(srv)[0], "gcn", 2, split=False)
    for _, counts, _ in rows:
        if counts.get("segment_agg") != want_age or counts.get("quant_matmul") != 2:
            raise RuntimeError(f"{tag}: launched {counts}, expected {want_age} AGE and 2 GEMM")
    err = _mixed_close(rows[0][0].outputs, want)
    rep = srv.shard_report()
    warm_ms = [r.run_ms for r, _, _ in rows[1:]]
    log(f"[{tag}] {rep['num_shards']} shards ({rep['partitioner']}): edge_balance "
        f"{rep['edge_balance']:.4f}, halo_total {rep['halo_total']} rows "
        f"{rep['halo_per_shard']}, edges {rep['edges_per_shard']}, owned "
        f"{rep['owned_per_shard']}, plan_ms per shard "
        f"{[round(m, 1) for m in rep['plan_ms_per_shard']]}")
    log(f"[{tag}] warm run_ms {warm_ms} vs unsharded warm {base_run_ms}; halo_bytes "
        f"{rows[1][0].halo_bytes} a request; AGE {want_age} + GEMM 2 launches a request; "
        f"peak {peak / 2**30:.2f} GiB; vs unsharded max |diff| {err:.3e} (mixed tolerance); "
        "warm == cold bitwise")
    return srv, rows[0][0].outputs, dict(requests=_request_rows(rows), shard_report=rep,
                     base_warm_run_ms=base_run_ms, peak_bytes=peak,
                     max_abs_err_vs_unsharded=err, age_launches=want_age,
                     launches_request=rows[-1][1])


def phase_plan_store(cfg, params, g, cases, plan_dir):
    """Save each engine's plan cache, load it into a fresh engine with the
    same params: its first request is a cache hit with plan_ms 0.0, bitwise
    the original output. ``cases``: (label, engine, its output, engine
    kwargs, its cold plan_ms). The files stay in ``plan_dir/<label>``."""
    import os
    import shutil

    import numpy as np

    from repro_torch.serve.gnn_engine import GNNServeEngine

    rows = {}
    for label, srv, want, kw, cold_ms in cases:
        d = os.path.join(plan_dir, label)
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        paths = srv.save_plan_cache(d)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(p) for p in paths)
        fresh = GNNServeEngine(cfg, params, device="cuda", **kw)
        t0 = time.perf_counter()
        loaded = fresh.load_plan_cache(d)
        load_s = time.perf_counter() - t0
        resp = fresh.infer(g, g.features)
        log(f"[plan store] {label}: {loaded} plans ({nbytes / 2**20:.1f} MiB) saved in "
            f"{save_s:.2f} s, loaded in {load_s:.2f} s (cold plan_ms {cold_ms:.1f}); first "
            f"request cache_hit={resp.cache_hit} plan_ms={resp.plan_ms} run_ms="
            f"{resp.run_ms:.3f}, planner_calls {fresh.stats['planner_calls']}")
        if not resp.cache_hit or resp.plan_ms != 0.0 or fresh.stats["planner_calls"]:
            raise RuntimeError(f"plan store: the {label} engine warmed from disk planned again")
        if not np.array_equal(resp.outputs, want):
            raise RuntimeError(f"plan store: the {label} warm-started output differs")
        rows[label] = dict(plans=loaded, file_bytes=nbytes, save_s=save_s, load_s=load_s,
                           cold_plan_ms=cold_ms, run_ms=resp.run_ms)
        del fresh
    log("[plan store] every disk-warmed first request bitwise its engine's output")
    return rows


def phase_sharded_overlap(cfg, params, g, want, plan_dir):
    """The sharded Yelp GCN with the halo exchange overlapped, its shard
    plans warmed from the unsplit engine's saved cache: the AGE runs both
    halves of every split group, the output is bitwise the unsplit one."""
    import numpy as np

    from repro_torch.serve.gnn_engine import GNNServeEngine

    tag = "sharded gcn"
    ov = GNNServeEngine(cfg, params, num_shards=SHARDS, partitioner="edges", halo_overlap=True,
                        device="cuda")
    ov.load_plan_cache(plan_dir)
    rows = _serve3(ov, g, g.features, tag, "overlap")
    split_age = _age_launches(_sharded_entry(ov)[0], "gcn", 2, split=True)
    stats = _sharded_entry(ov)[1].halo_stats
    for resp, counts, _ in rows:
        if not np.array_equal(resp.outputs, want):
            raise RuntimeError(f"{tag}: the overlapped output differs from the unsplit one")
        if not resp.cache_hit or resp.plan_ms != 0.0:
            raise RuntimeError(f"{tag}: the shard plans loaded from disk were not hit")
        if not 0.0 <= resp.halo_overlap <= 1.0 or resp.halo_ms <= 0.0:
            raise RuntimeError(f"{tag}: halo_ms {resp.halo_ms} overlap {resp.halo_overlap}")
        if counts.get("segment_agg") != split_age:
            raise RuntimeError(f"{tag}: launched {counts}, expected {split_age} AGE (split)")
    if stats["split_exchanges"] != stats["halo_exchanges"]:
        raise RuntimeError(f"{tag}: an overlapped exchange ran unsplit: {stats}")
    log(f"[{tag}] overlap: bitwise the unsplit output; {split_age} AGE launches a request "
        f"(both halves of every shard's groups); every exchange split: {stats}")
    return dict(requests=_request_rows(rows), split_age_launches=split_age, halo_stats=stats)


def phase_sharded_mincut(cfg, params):
    """FULL ample-gcn on a 200,000-node clustered graph whose communities are
    shuffled in node order, 4 shards under ``edges`` and ``mincut``, each
    with the halo exchange overlapped and not. Min-cut is not run on Yelp:
    its synthetic graph has no communities, so min-cut costs ~110 s of host
    time there for a halo 1.3% smaller."""
    import numpy as np

    from repro_torch.graphs.datasets import make_clustered_graph
    from repro_torch.graphs.partition import make_partition, partition_halo_volume
    from repro_torch.models.gnn import api as gnn_api
    from repro_torch.serve.gnn_engine import GNNServeEngine

    tag = "sharded mincut"
    g = make_clustered_graph(200_000, 8, seed=1, shuffle=True, inter_degree=0.5)
    feats = np.random.default_rng(0).standard_normal((g.num_nodes, cfg.d_model)).astype(
        np.float32)
    want = GNNServeEngine(cfg, params, device="cuda").infer(g, feats).outputs
    prepared = gnn_api.prepare_graph(cfg, g)
    out = dict(nodes=g.num_nodes, edges=g.num_edges)
    for kind in ("edges", "mincut"):
        t0 = time.perf_counter()
        part = make_partition(prepared, SHARDS, kind)
        part_s = time.perf_counter() - t0
        halo = partition_halo_volume(prepared, part)
        ys, reqs = {}, {}
        for overlap in (False, True):
            srv = GNNServeEngine(cfg, params, partition=part, halo_overlap=overlap, device="cuda")
            srv.infer(g, feats)
            (resp, counts), wait = _halo_wait(srv, lambda: _launches(lambda: srv.infer(g, feats)))
            ys[overlap] = resp.outputs
            splan, eng = _sharded_entry(srv)
            stats = eng.halo_stats
            expect = _age_launches(splan, "gcn", 2, split=overlap)
            if counts.get("segment_agg") != expect or (
                    overlap and stats["split_exchanges"] != stats["halo_exchanges"]):
                raise RuntimeError(f"{tag}: {kind} overlap={overlap} launched {counts}, "
                                   f"expected {expect} AGE; {stats}")
            reqs["overlap" if overlap else "unsplit"] = dict(
                run_ms=resp.run_ms, halo_ms=resp.halo_ms, halo_wait_ms=wait,
                halo_bytes=resp.halo_bytes, halo_overlap=resp.halo_overlap, launches=counts)
            log(f"[{tag}] {kind} overlap={overlap}: warm run_ms={resp.run_ms:.3f} "
                f"halo_ms={resp.halo_ms:.3f} halo_wait_ms={wait:.3f} "
                f"halo_overlap={resp.halo_overlap:.3f} halo_bytes={resp.halo_bytes} "
                f"launches={counts}")
            del srv, eng
        if not np.array_equal(ys[True], ys[False]):
            raise RuntimeError(f"{tag}: {kind}: the overlapped output differs from the unsplit")
        err = _mixed_close(ys[False], want)
        out[kind] = dict(partition_s=part_s, halo_rows=halo, max_abs_err_vs_unsharded=err,
                         requests=reqs)
        log(f"[{tag}] {kind}: partition {part_s:.2f} s, halo {halo} rows; overlap bitwise "
            f"unsplit; vs unsharded max |diff| {err:.3e} (mixed tolerance)")
    out["halo_reduction"] = 1.0 - out["mincut"]["halo_rows"] / out["edges"]["halo_rows"]
    log(f"[{tag}] {g.num_nodes} nodes {g.num_edges} edges: min-cut halo "
        f"{out['mincut']['halo_rows']} vs edges {out['edges']['halo_rows']} rows "
        f"({out['halo_reduction'] * 100:.1f}% fewer) for "
        f"{out['mincut']['partition_s']:.2f} s of partitioning")
    return out


def phase_sharded_gat(cfg, params, g, want):
    """FULL ample-gat on Yelp over 4 shards: the decomposed layer, its
    softmax denominators and weighted aggregate on the multi-head AGE per
    shard and group (launched on every request), warm == cold, within the
    mixed tolerance of the unsharded output, peak under 20 GiB."""
    import torch

    from repro_torch.serve.gnn_engine import GNNServeEngine

    tag = "sharded gat"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = GNNServeEngine(cfg, params, num_shards=SHARDS, device="cuda")
    rows = _serve3(srv, g, g.features, tag, "unsplit")
    peak = torch.cuda.max_memory_allocated()
    groups = sum(len(sp.plan.mode_plans["runtime"]) for sp in _sharded_entry(srv)[0].shards)
    for _, counts, _ in rows:
        if not counts.get("segment_agg_mh") or counts.get("attention") or \
                counts.get("quant_matmul") != 2:
            raise RuntimeError(f"{tag}: launched {counts}")
    err = _mixed_close(rows[0][0].outputs, want)
    if peak >= 20 * 2**30:
        raise RuntimeError(f"{tag}: peak device memory {peak / 2**30:.2f} GiB >= 20 GiB")
    log(f"[{tag}] segment_agg_mh {rows[-1][1]['segment_agg_mh']} launches a request "
        f"({groups} shard groups x 2 layers x (denominators + aggregate)); warm run_ms "
        f"{[round(r.run_ms, 3) for r, _, _ in rows[1:]]}; peak {peak / 2**30:.2f} GiB; vs "
        f"unsharded max |diff| {err:.3e} (mixed tolerance); warm == cold bitwise")
    return dict(requests=_request_rows(rows), shard_report=srv.shard_report(), peak_bytes=peak,
                max_abs_err_vs_unsharded=err, launches_request=rows[-1][1])


# --------------------------------------------------------------- QAT (training)
QAT_STEPS = 10  # Yelp QAT steps timed (cut steps, never width, past ~90 s)
QAT_REPEAT_STEPS = 3  # steps of each of the two runs held bitwise
QAT_ATOL, QAT_RTOL = 5e-4, 1e-3  # f32 paths, tests/test_gnn_models.py:46
QAT_ACC_TOL = 0.03  # the example's accuracies, card against CPU
EXAMPLE_STEPS, EXAMPLE_NODES, EXAMPLE_LR = 300, 800, 5e-3  # the example's defaults


def _qat_example():
    """``examples/train_gcn_degreequant_torch.py`` as a module."""
    import importlib.util

    path = os.path.join(ROOT, "examples", "train_gcn_degreequant_torch.py")
    spec = importlib.util.spec_from_file_location("train_gcn_degreequant_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qat_inputs(ex, g, num_classes, dev):
    """(x, labels, train mask) of a prepared graph on ``dev``."""
    import torch

    labels, train = ex.node_task(g, num_classes)
    return (torch.from_numpy(g.features).to(dev), torch.from_numpy(labels).long().to(dev),
            torch.from_numpy(train).to(dev))


def _close_report(name, got, want):
    """Max abs difference of two tensors; raise beyond the f32 tolerance."""
    import numpy as np

    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, atol=QAT_ATOL, rtol=QAT_RTOL, err_msg=name)
    return err


def phase_qat(g):
    """Degree-Quant QAT of FULL ``ample-gcn`` on the Yelp graph (self-loops
    added), through ``AmpleEngine.aggregate``'s backward on the card, then
    the gates and the example. Returns the phase's row."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.aggregation import aggregate_autograd
    from repro_torch.core.message_passing import AmpleEngine, EngineConfig
    from repro_torch.core.quantization import QuantParams, compute_scale_zp
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_matmul import ops as qm_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg.ref import aggregate_tiles_ref
    from repro_torch.models.api import params_to
    from repro_torch.models.gnn import api as gnn_api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    ex = _qat_example()
    cfg = get_config("ample-gcn")
    dev = torch.device("cuda")
    row = {}
    t0 = time.perf_counter()
    gs = gnn_api.prepare_graph(cfg, g)
    x, labels, train = _qat_inputs(ex, gs, cfg.vocab_size, dev)
    row["setup_s"] = time.perf_counter() - t0
    eng = AmpleEngine(gs, EngineConfig(mixed_precision=False))
    t0 = time.perf_counter()
    eng._device_plans("gcn", eng.plans("gcn"), dev)
    row["plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tdp = eng._transposed_plan("gcn", "float", dev)
    row["transposed_plan_s"] = time.perf_counter() - t0
    tplan = eng._tplans[("gcn", "float")]
    log(f"[qat gcn] yelp + self-loops: {gs.num_nodes} nodes {gs.num_edges} edges, "
        f"{int(train.sum())} training nodes, {cfg.vocab_size} classes; setup "
        f"{row['setup_s']:.1f} s, float plan {row['plan_s']:.1f} s, transposed plan "
        f"{row['transposed_plan_s']:.1f} s ({tplan.num_tiles} tiles, "
        f"{tdp.split.num_slots} split slots)")

    # S steps, each timed by CUDA events: forward, backward, optimiser.
    params0 = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device=dev)
    params = ex.trainable(params0)
    opt_cfg = AdamWConfig(lr=EXAMPLE_LR, weight_decay=ex.WEIGHT_DECAY)
    opt = adamw_init(params)
    rng = np.random.default_rng(3)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    for s in range(QAT_STEPS):
        mask = torch.from_numpy(ex.sample_protection_mask(gs, ex.DQ, rng)).to(dev)
        before = build.launch_counts().get(seg_ops.KERNEL, 0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = ex.qat_loss(params, eng, x, labels, train, mask)
        ev[1].record()
        grads = torch.autograd.grad(loss, [lyr["w"] for lyr in params["layers"]])
        ev[2].record()
        params, opt, metrics = adamw_update({"layers": [{"w": gw} for gw in grads]}, opt,
                                            params, opt_cfg)
        ev[3].record()
        torch.cuda.synchronize()
        st = dict(loss=float(loss.detach()), forward_ms=ev[0].elapsed_time(ev[1]),
                  backward_ms=ev[1].elapsed_time(ev[2]), optimizer_ms=ev[2].elapsed_time(ev[3]),
                  age_launches=build.launch_counts().get(seg_ops.KERNEL, 0) - before,
                  grad_norm=float(metrics["grad_norm"]))
        steps.append(st)
        log(f"[qat gcn] step {s}: loss {st['loss']:.5f} forward {st['forward_ms']:.3f} ms "
            f"backward {st['backward_ms']:.3f} ms optimizer {st['optimizer_ms']:.3f} ms "
            f"AGE launches {st['age_launches']} grad_norm {st['grad_norm']:.4g}")
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    row["steps"] = steps
    row["launches"] = build.launch_counts()
    log(f"[qat gcn] {QAT_STEPS} steps: peak device memory {row['peak_bytes'] / 2**30:.2f} GiB; "
        f"launches {row['launches']}")
    if any(st["age_launches"] != 3 for st in steps):  # (a)
        raise RuntimeError(f"QAT steps launched the AGE {[st['age_launches'] for st in steps]} "
                           "times, not 3 each")
    if not all(np.isfinite(st["loss"]) for st in steps):
        raise RuntimeError("a QAT loss is not finite")

    # Where a step's time goes: a step under the profiler after one warm-up
    # step (both discarded).
    def profiled_step():
        mask = torch.from_numpy(ex.sample_protection_mask(gs, ex.DQ, rng)).to(dev)
        loss = ex.qat_loss(params, eng, x, labels, train, mask)
        grads = torch.autograd.grad(loss, [lyr["w"] for lyr in params["layers"]])
        return adamw_update({"layers": [{"w": gw} for gw in grads]}, opt, params, opt_cfg)

    wall_ms, _, prof = _device_profile(profiled_step, warmup=1)
    busy = sum(ms for _, ms, _ in prof)
    row["profile"] = dict(wall_ms=wall_ms, device_ms=busy if prof else None,
                          top=[dict(name=n, ms=ms, count=c) for n, ms, c in prof[:24]])
    if prof:
        log(f"[qat gcn] profiled step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
            f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})")
        for name, ms, count in prof[:12]:
            log(f"[qat gcn]   {ms:9.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log(f"[qat gcn] profiled step: wall {wall_ms:.3f} ms; device time not measured")

    # (b) Two runs of the same steps from the same seed: bitwise the same.
    runs = [ex.train(params0, eng, x, labels, train, steps=QAT_REPEAT_STEPS, lr=EXAMPLE_LR)[0]
            for _ in range(2)]
    row["repeat_bitwise"] = all(torch.equal(a["w"], b["w"]) for a, b in
                                zip(runs[0]["layers"], runs[1]["layers"]))
    log(f"[qat gcn] two runs of {QAT_REPEAT_STEPS} steps bitwise equal: {row['repeat_bitwise']}")
    if not row["repeat_bitwise"]:
        raise RuntimeError("two QAT runs from one seed gave different parameters")
    del runs

    # Deployment: the trained weights through the float engine and int8.
    build.reset_launch_counts()
    t0 = time.perf_counter()
    acc_float, acc_mixed = ex.evaluate(cfg, params, eng, x, labels, ~train)
    row.update(deploy_s=time.perf_counter() - t0, acc_float=acc_float, acc_mixed=acc_mixed,
               deploy_launches=build.launch_counts())
    log(f"[qat gcn] after {QAT_STEPS} steps: test accuracy float {acc_float:.4f}, deployed int8 "
        f"{acc_mixed:.4f}, difference {acc_float - acc_mixed:+.4f} (launches "
        f"{row['deploy_launches']}: the float forward 2 AGE, the int8 one 4 AGE + 2 GEMM)")
    if row["deploy_launches"] != {seg_ops.KERNEL: 6, qm_ops.KERNEL: 2}:
        raise RuntimeError(f"deployment launched {row['deploy_launches']}")

    # (c) The backward's launch at Yelp's size against its plain version:
    # the CPU's, bitwise (both sum each segment in lane order), and the
    # card's within AGE_ATOL (its index_add_ sums in another order).
    n = gs.num_nodes
    gr = torch.randn((n, cfg.d_ff), generator=_cuda_gen(5), device=dev)
    args = (tdp.gather_idx, tdp.coeff, tdp.seg_ids, tdp.out_node, tdp.split)
    out = seg_ops.aggregate_tiles(gr, *args, num_nodes=n)
    again = seg_ops.aggregate_tiles(gr, *args, num_nodes=n)
    plain = aggregate_tiles_ref(gr, *args, num_nodes=n)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    cpu_plan = eng._transposed_plan("gcn", "float", torch.device("cpu"))
    t0 = time.perf_counter()
    cpu_plain = aggregate_tiles_ref(
        gr.cpu(), cpu_plan.gather_idx, cpu_plan.coeff, cpu_plan.seg_ids, cpu_plan.out_node,
        cpu_plan.split, num_nodes=n)
    cpu_s = time.perf_counter() - t0
    bitwise = bool(torch.equal(out, again)) and bool(torch.equal(out.cpu(), cpu_plain))
    del out, again, plain, cpu_plain, cpu_plan
    ms = cuda_ms(lambda: seg_ops.aggregate_tiles(gr, *args, num_nodes=n), reps=10)
    plain_ms = cuda_ms(lambda: aggregate_tiles_ref(gr, *args, num_nodes=n), reps=2)
    lib_a = _group_csr(tplan, n)
    lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, gr), reps=10)
    del lib_a
    live = tplan.edge_ids >= 0
    lanes, uniq = int(live.sum()), np.unique(tplan.gather_idx[live]).size
    plan_bytes = sum(t.numel() * t.element_size() for t in args[:4]) + sum(
        t.numel() * t.element_size()
        for t in (tdp.split.slot_of, tdp.split.split_ptr, tdp.split.split_node))
    nbytes = uniq * cfg.d_ff * 4 + plan_bytes + n * cfg.d_ff * 4
    b_ms, b_by = bound(nbytes, 2.0 * lanes * cfg.d_ff, FP32_FLOPS)
    row["backward_kernel"] = dict(
        tiles=tplan.num_tiles, lanes=tplan.edges_per_tile, edges=lanes, n=n, d=cfg.d_ff,
        split_slots=tdp.split.num_slots, bitwise_plain=bitwise, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        cpu_plain_s=cpu_s)
    log(f"[qat gcn] backward AGE on the transposed plan T={tplan.num_tiles} D={cfg.d_ff}: "
        f"bitwise the CPU's plain version and run to run {bitwise} (CPU {cpu_s:.1f} s), "
        f"err vs the card's plain {err:.3g}; ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"library_ms={lib_ms:.3f} (torch.sparse.mm, CSR of Aᵀ) bound_ms={b_ms:.3f} ({b_by})")
    if not bitwise or not err <= AGE_ATOL:
        raise RuntimeError(f"the backward AGE: bitwise {bitwise}, err {err}")
    del gr, eng, tdp, x, labels, train, params, opt, grads, params0
    gc.collect()
    torch.cuda.empty_cache()

    # (d), (e) At pubmed's size, full width: the card against CPU autograd.
    pub = gnn_api.prepare_graph(cfg, make_dataset("pubmed", max_feature_dim=cfg.d_model, seed=0))
    pparams = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    pmask = torch.from_numpy(ex.sample_protection_mask(pub, ex.DQ, np.random.default_rng(3)))
    rr = np.random.default_rng(7).standard_normal((pub.num_nodes, cfg.d_model)).astype(np.float32)
    got = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        e = AmpleEngine(pub, EngineConfig(mixed_precision=False))
        loss, grads = ex.qat_grads(ex.trainable(params_to(pparams, d)), e,
                                   *_qat_inputs(ex, pub, cfg.vocab_size, d), pmask.to(d))
        em = AmpleEngine(pub, EngineConfig(mixed_precision=True))
        xp = torch.from_numpy(pub.features).to(d).requires_grad_()
        (em.aggregate(xp, mode="gcn") * torch.from_numpy(rr).to(d)).sum().backward()
        scale = compute_scale_zp(xp.detach()).scale.requires_grad_()
        qp = QuantParams(scale, torch.zeros_like(scale.detach()))
        dps = em._device_plans("gcn", em.plans("gcn"), d)
        ys = aggregate_autograd(xp.detach(), dps, lambda: em._transposed_plan("gcn", "float", d),
                                num_nodes=pub.num_nodes, qp=qp)
        (ys * torch.from_numpy(rr).to(d)).sum().backward()
        got[key] = dict(loss=loss, w0=grads["layers"][0]["w"], w1=grads["layers"][1]["w"],
                           x=xp.grad, scale=scale.grad)
    errs = {k: _close_report(k, got["card"][k], got["cpu"][k]) for k in got["cpu"]}
    row["pubmed"] = dict(nodes=pub.num_nodes, edges=pub.num_edges, max_abs_err=errs,
                         loss_card=float(got["card"]["loss"].detach()),
                         loss_cpu=float(got["cpu"]["loss"].detach()),
                         scale_grad_card=float(got["card"]["scale"]),
                         scale_grad_cpu=float(got["cpu"]["scale"]))
    log(f"[qat gcn] pubmed {pub.num_nodes} nodes, step 0 card vs CPU: loss "
        f"{row['pubmed']['loss_card']:.6f} / {row['pubmed']['loss_cpu']:.6f}; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; mixed scale gradient {row['pubmed']['scale_grad_card']:.6g} / "
        f"{row['pubmed']['scale_grad_cpu']:.6g} (atol {QAT_ATOL}, rtol {QAT_RTOL})")
    del got, pub

    # The example at its defaults on the card and on the CPU.
    ex_rows = {}
    for key, d in (("card", "cuda"), ("cpu", "cpu")):
        t0 = time.perf_counter()
        ex_rows[key] = ex.run(steps=EXAMPLE_STEPS, nodes=EXAMPLE_NODES, lr=EXAMPLE_LR, device=d)
        ex_rows[key]["seconds"] = time.perf_counter() - t0
        log(f"[qat gcn] example ({EXAMPLE_NODES} nodes, {EXAMPLE_STEPS} steps) on the {key}: "
            f"accuracy float {ex_rows[key]['acc_float']:.4f}, deployed int8 "
            f"{ex_rows[key]['acc_mixed']:.4f}, loss {ex_rows[key]['first_loss']:.4f} -> "
            f"{ex_rows[key]['last_loss']:.4f}, {ex_rows[key]['seconds']:.1f} s")
    row["example"] = ex_rows
    for k in ("acc_float", "acc_mixed"):
        if abs(ex_rows["card"][k] - ex_rows["cpu"][k]) > QAT_ACC_TOL:
            raise RuntimeError(f"example {k}: card {ex_rows['card'][k]} vs CPU "
                               f"{ex_rows['cpu'][k]}, beyond {QAT_ACC_TOL}")
    return row


def _lm_launches(cfg):
    """The kernel launches of one prefill of ``cfg``, from its layer roles:
    flash attention once per attention layer (also counted as a tensor-core
    launch where the variant is the tensor-core one), the SSD intra-chunk
    kernel once per Mamba layer."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.lm.transformer import mixer_counts

    n = mixer_counts(cfg)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tc = fa_ops.flash_variant(dt, cfg.resolved_head_dim) == "tensor_cores"
    want = {fa_ops.KERNEL: n["attn"], fa_ops.TC_KERNEL: n["attn"] if tc else 0,
            ssd_ops.KERNEL: n["mamba"]}
    return {name: c for name, c in want.items() if c}


@contextlib.contextmanager
def _moe_calls(pinned=None):
    """Record the stats of every MoE layer call the transformer makes while
    the block runs (``return_stats=True``: loads, drops, capacity, the routes
    ``gate_idx`` [T, k] and the router's ``probs`` [T, E]; the output is
    unchanged). With ``pinned`` (one [T, k] id tensor per call, in call
    order), each call routes its tokens to those experts instead, with its own
    probabilities there as the gates."""
    import torch

    from repro_torch.models.lm import transformer

    orig, topk = transformer.moe_apply, torch.topk
    calls = []

    def hooked(p, h, **kwargs):
        if pinned is not None:
            idx = pinned[len(calls)]
            torch.topk = lambda x, k, dim=-1: (x.gather(-1, idx), idx)
        try:
            out, aux, stats = orig(p, h, return_stats=True, **kwargs)
        finally:
            torch.topk = topk
        calls.append(stats)
        return out, aux

    transformer.moe_apply = hooked
    try:
        yield calls
    finally:
        transformer.moe_apply = orig


def _stats_summary(calls, tokens):
    """Per-layer MoE stats of ``_moe_calls`` records as host numbers:
    capacity, dropped fraction (mean, min, max over the layers) and the
    busiest expert's load over the mean."""
    import numpy as np

    rows = calls
    drop = [float(r["dropped_fraction"]) for r in rows]
    loads = np.stack([r["expert_load"].cpu().numpy() for r in rows])
    return dict(layers=len(rows), tokens=tokens, capacity=rows[0]["capacity"],
                dropped_fraction_mean=float(np.mean(drop)), dropped_fraction_min=min(drop),
                dropped_fraction_max=max(drop),
                load_max_over_mean=float((loads.max(1) / loads.mean(1)).max()),
                expert_load_layer0=loads[0].tolist())


def phase_lm_path(arch, tag, num_layers=None, cut_reason="", tf_shape=None, tf_reason=""):
    """Serve ``arch`` at its published widths with ``ServeEngine.generate`` (B 4
    x 2048-token prompts, 32 new tokens, random weights from a CUDA generator
    of seed 0), at ``num_layers`` when its depth is cut (whole units): twice
    (each kernel of the path launched as ``block_roles`` says, per call; the
    repeat bitwise), once with one new token (the prefill alone); for a MoE
    config the layers' routing stats of one prefill and one decode step;
    then the teacher-forced check and a profiled ``generate``.

    The teacher-forced check compares the serving path (prefill, then decode
    steps) with one forward over the whole sequences. A MoE layer's capacity
    depends on the tokens in the call, so decode (B tokens) and the forward
    (B x S) drop different slots at the config's capacity factor; the check
    runs on an engine at ``capacity_factor = E / k``, where nothing drops, on
    the tokens that engine generates, at ``tf_shape`` (B, P) when given: the
    free forward up to each sequence's first route that differs from the
    served one (every such flip a near-tie), then the forward routed as
    served."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models.api import model_decode_step, model_forward, model_prefill
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    if num_layers is not None:
        log(f"[{tag}] depth cut: {num_layers} of {cfg.num_layers} layers, widths as published "
            f"({cut_reason})")
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    b, p, new, vocab = LM_BATCH, LM_PROMPT, LM_NEW, cfg.vocab_size
    eng, init_ms = _timed(lambda: ServeEngine(cfg, max_len=LM_MAX_LEN, device="cuda",
                                              generator=_cuda_gen(0)))
    leaves = _leaves(eng.params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    # A decode step reads every weight once (the MoE layers run every expert
    # on its [C, D] buffer) but gathers only B rows of an untied embedding
    # table (a tied one is also the LM head, which every step reads).
    embed = eng.params["embed"]
    untied = 0 if cfg.tie_embeddings else 1
    floor_ms = (weight_bytes - untied * embed.numel() * embed.element_size()) / HBM_BPS * 1e3
    # The prefill's least work: two operations per active parameter and token
    # (the routed experts only; attention's scores and the capacity padding
    # left out), at the bf16 tensor-core peak. An untied embedding table is a
    # lookup, no product; the LM head's V x d stays in.
    flop_params = cfg.active_param_count() - untied * cfg.vocab_size * cfg.d_model
    prefill_floor_ms = 2.0 * flop_params * LM_BATCH * LM_PROMPT / BF16_FLOPS * 1e3
    log(f"[{tag}] {arch}: {cfg.num_layers} layers, d {cfg.d_model}, {n_params:,} params "
        f"(param_count {cfg.param_count():,}, {cfg.active_param_count():,} active a token), "
        f"{weight_bytes / 1e9:.2f} GB of weights, made in {init_ms:.0f} ms; "
        f"{flop_params:,} active params a token in products")
    prompts = np.random.default_rng(0).integers(0, vocab, (b, p))
    want = _lm_launches(cfg)
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
    log(f"[{tag}] prefill {prefill_ms:.1f} ms ({b * p / prefill_ms * 1e3:,.0f} tokens/s; "
        f"2 x active product params x tokens at the bf16 peak: {prefill_floor_ms:.2f} ms), "
        f"decode {decode_ms:.2f} ms per token (batch {b}; weight-read floor {floor_ms:.2f} ms, "
        f"{decode_ms / floor_ms:.2f}x), peak device memory {peak / 2**30:.2f} GiB (weights "
        f"{weight_bytes / 2**30:.2f} GiB, cache {kv_bytes / 2**30:.2f} GiB, prefill logits "
        f"{logit_bytes / 2**30:.2f} GiB)")

    routing = None
    if cfg.is_moe:
        tokens = torch.as_tensor(prompts, device="cuda")
        with torch.inference_mode():
            with _moe_calls() as rows:
                logits, cache, n = model_prefill(eng.params, cfg, {"tokens": tokens},
                                                 LM_MAX_LEN)
            step = logits[:, -1, :vocab].argmax(-1)[:, None]
            del logits
            with _moe_calls() as drows:
                model_decode_step(eng.params, cfg, {"tokens": step}, cache, n)
            del cache
        routing = dict(prefill=_stats_summary(rows, b * p), decode=_stats_summary(drows, b))
        for when, r in routing.items():
            log(f"[{tag}] moe {when} ({r['tokens']} tokens, {r['layers']} MoE layers, "
                f"{cfg.num_experts} experts top-{cfg.experts_per_token}, cf "
                f"{cfg.capacity_factor}): capacity {r['capacity']}, dropped fraction mean "
                f"{r['dropped_fraction_mean']:.4f} (min {r['dropped_fraction_min']:.4f}, max "
                f"{r['dropped_fraction_max']:.4f}), busiest expert {r['load_max_over_mean']:.2f}x "
                f"the mean load; layer 0 loads {r['expert_load_layer0']}")

    # Teacher forcing: the serving path's logits, fed the generated tokens
    # (prefill + decode steps, which reproduce generate's argmax exactly),
    # against one forward over the whole sequences.
    tf_cfg, tf_eng, tb, tp, seqs = cfg, eng, b, p, out.long()
    if cfg.is_moe:
        tb, tp = tf_shape or (b, p)
        tf_cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
        tf_eng = ServeEngine(tf_cfg, eng.params, max_len=LM_MAX_LEN, device="cuda")
        seqs = tf_eng.generate(prompts[:tb, :tp], max_new_tokens=new).long()
        log(f"[{tag}] teacher-forced check on an engine at capacity factor "
            f"{tf_cfg.capacity_factor:g} (no slot drops), B {tb} x {tp}"
            + (f" ({tf_reason})" if tf_reason else ""))
    with torch.inference_mode(), _moe_calls() as served_calls:
        logits, cache, n = model_prefill(tf_eng.params, tf_cfg, {"tokens": seqs[:, :tp]},
                                         LM_MAX_LEN)
        finite = bool(torch.isfinite(logits).all())
        steps = [logits[:, -1, :vocab].clone()]
        del logits  # [B, P, V] f32
        for i in range(new - 1):
            lg, cache = model_decode_step(tf_eng.params, tf_cfg,
                                          {"tokens": seqs[:, tp + i : tp + i + 1]}, cache, n + i)
            steps.append(lg[:, :vocab])
        served = torch.stack(steps, dim=1)  # [B, new, V]
        del cache
    finite = finite and bool(torch.isfinite(served).all())
    reproduced = bool(torch.equal(served.argmax(-1), seqs[:, tp:]))

    def compare(pinned=None):
        """(argmax agreement, max relative difference, the relative difference
        at each served position [B, new], the forward's MoE calls, finite) of
        one forward over the sequences against the served logits."""
        with torch.inference_mode(), _moe_calls(pinned) as calls:
            fwd = model_forward(tf_eng.params, tf_cfg, {"tokens": seqs[:, :-1]})[0]
            ok = bool(torch.isfinite(fwd).all())
            tf = fwd[:, tp - 1 :, :vocab]
            agree = float((tf.argmax(-1) == seqs[:, tp:]).float().mean())
            err = (tf - served).abs().amax(-1) / served.abs().max()
            del fwd, tf
        return agree, float(err.max()), err, calls, ok

    agree, rel, err, fwd_calls, ok = compare()
    finite = finite and ok
    routes = None
    if cfg.is_moe:
        # A MoE layer's top-k is a step function of its input: where two of a
        # token's expert probabilities nearly tie, the bf16 rounding that
        # differs between decode and the forward picks other experts (random
        # routers are flat: their probabilities tie often), and the logits of
        # that position and every later one part. So the free forward is held
        # where no route has flipped yet: each sequence's positions before its
        # first flip (any layer, prompt included) within TF_REL, and every
        # flip at a near-tie (margin under ROUTE_TIE). The forward then runs
        # once more with every token routed to the experts the serving path
        # chose for it (the gates its own probabilities there), and the
        # agreement and difference bounds below hold that run.
        k, layers = cfg.experts_per_token, len(fwd_calls)
        pinned = [torch.cat([served_calls[r]["gate_idx"].view(tb, tp, k)]
                            + [served_calls[layers * (i + 1) + r]["gate_idx"].view(tb, 1, k)
                               for i in range(new - 1)], dim=1).reshape(-1, k)
                  for r in range(layers)]
        differs = torch.stack([(c["gate_idx"].sort(-1).values != q.sort(-1).values).any(-1)
                               .view(tb, -1) for c, q in zip(fwd_calls, pinned)])  # [L, B, S]
        top = [c["probs"].topk(k + 1, dim=-1).values for c in fwd_calls]
        margins = torch.stack([(t[:, k - 1] - t[:, k]).view(tb, -1) for t in top])
        flipped = differs.any(0)  # [B, S]
        first = torch.where(flipped.any(1), flipped.float().argmax(1), flipped.shape[1])
        before = torch.arange(tp - 1, tp - 1 + new, device=first.device)[None] < first[:, None]
        routes = dict(flips=int(differs.sum()), routes=differs.numel(),
                      max_margin=float(margins[differs].max()) if bool(differs.any()) else 0.0,
                      positions_before_first_flip=int(before.sum()),
                      rel_diff_before_first_flip=float(torch.where(before, err, 0.0).max()),
                      agreement=agree, rel_diff=rel)
        del fwd_calls, top, margins, differs
        log(f"[{tag}] free forward: argmax agreement {agree:.4f}, max relative difference "
            f"{rel:.4g}; it routes {routes['flips']} of {routes['routes']} (layer, token) routes "
            f"otherwise than the serving path, at probability margins (k-th - (k+1)-th) up to "
            f"{routes['max_margin']:.3g} (< {ROUTE_TIE}); max relative difference over the "
            f"{routes['positions_before_first_flip']} of {tb * new} served positions before "
            f"their sequence's first flip {routes['rel_diff_before_first_flip']:.4g} "
            f"(< {TF_REL}); the check below routes as served")
        if not (routes["max_margin"] < ROUTE_TIE and routes["rel_diff_before_first_flip"] < TF_REL):
            raise RuntimeError(f"{tag}: the free forward parts from the served path beyond "
                               f"route near-ties: {routes}")
        agree, rel, _, _, ok = compare(pinned)
        finite = finite and ok
    del served, tf_eng
    log(f"[{tag}] teacher-forced forward vs served logits: argmax agreement {agree:.4f} "
        f"(>= {TF_AGREE}), max relative difference {rel:.4g} (< {TF_REL}); served argmax "
        f"== generated tokens: {reproduced}; all logits finite: {finite}")
    if not (reproduced and finite and agree >= TF_AGREE and rel < TF_REL):
        raise RuntimeError(f"{tag}: teacher-forced check failed")

    build.reset_launch_counts()
    profile = _profiled(tag, lambda: eng.generate(prompts, max_new_tokens=new))
    detail = dict(arch=arch, num_layers=cfg.num_layers, params=n_params,
                  weight_bytes=weight_bytes, init_ms=init_ms,
                  generate_ms=[r[1] for r in runs], launches=runs[0][2], prefill_ms=prefill_ms,
                  prefill_tokens_per_s=b * p / prefill_ms * 1e3,
                  prefill_flop_floor_ms=prefill_floor_ms, decode_ms_per_token=decode_ms,
                  decode_weight_floor_ms=floor_ms, peak_bytes=peak, kv_cache_bytes=kv_bytes,
                  moe=routing, teacher_forced_shape=[tb, tp], teacher_forced_routes=routes,
                  teacher_forced_agreement=agree, teacher_forced_rel_diff=rel,
                  profile=profile)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return detail


def _vlm_positions(batch, text0, grid, text1):
    """int32[3, B, S] M-RoPE streams: ``text0`` text positions, one grid x
    grid image (t fixed at ``text0``, h and w advancing over the grid), then
    ``text1`` text positions from the largest position + 1."""
    import numpy as np

    t = np.arange(text0)
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.full(grid * grid, text0), text0 + hh.ravel(), text0 + ww.ravel()])
    t1 = np.arange(img.max() + 1, img.max() + 1 + text1)
    pos = np.concatenate([np.stack([t, t, t]), img, np.stack([t1, t1, t1])], 1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, pos.shape[1])))


def _greedy(params, cfg, batch, new, max_len):
    """``model_prefill`` of ``batch``, then ``new - 1`` greedy
    ``model_decode_step``s on tokens (``generate``'s loop, on any batch the
    prefill takes): (tokens [B, new], logits [B, new, V] f32 each token was
    picked from, cache_len after the prefill)."""
    import torch

    from repro_torch.models.api import model_decode_step, model_prefill

    vocab = cfg.vocab_size
    with torch.inference_mode():
        logits, cache, n = model_prefill(params, cfg, batch, max_len)
        served = [logits[:, -1, :vocab].clone()]
        del logits  # [B, P, V] f32
        for i in range(new - 1):
            tok = served[-1].argmax(-1)[:, None]
            lg, cache = model_decode_step(params, cfg, {"tokens": tok}, cache, n + i)
            served.append(lg[:, :vocab])
        served = torch.stack(served, 1)
        del cache
    return served.argmax(-1), served, n


def _repeat_twice(tag, params, cfg, batch, new, max_len, want):
    """Two runs of ``_greedy`` (each kernel launched as ``want`` says, the
    repeat bitwise, tokens and logits) and one of the prefill alone: (tokens,
    served logits, cache_len, run ms, prefill ms, prefill launches, peak
    bytes)."""
    import torch

    from repro_torch.kernels import build

    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        build.reset_launch_counts()
        out, ms = _timed(lambda: _greedy(params, cfg, batch, new, max_len))
        counts = build.launch_counts()
        runs.append((out, ms))
        log(f"[{tag}] run {i}: prefill + {new - 1} decode steps: {ms:.1f} ms, launches {counts}")
        if counts != want:
            raise RuntimeError(f"{tag}: run launched {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    (toks, served, n), (toks2, served2, _) = runs[0][0], runs[1][0]
    if not (torch.equal(toks, toks2) and torch.equal(served, served2)):
        raise RuntimeError(f"{tag}: the repeated run differs")
    build.reset_launch_counts()
    _, prefill_ms = _timed(lambda: _greedy(params, cfg, batch, 1, max_len))
    return toks, served, n, [r[1] for r in runs], prefill_ms, build.launch_counts(), peak


def _profiled(tag, fn):
    """Wall ms, device ms (None when the profiler saw no device time), the
    idle share and the top device ops of one ``fn`` run under torch.profiler."""
    wall_ms, _, rows = _device_profile(fn)
    busy = sum(ms for _, ms, _ in rows)
    if rows:
        log(f"[{tag} profile] wall_ms={wall_ms:.1f}, device busy {busy:.1f} ms "
            f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})")
        for name, ms, count in rows[:14]:
            log(f"[{tag} profile]   {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    else:
        log(f"[{tag} profile] wall_ms={wall_ms:.1f}; device time not measured")
    # the SSD backward's kernels, wherever they rank (training the ssm and hybrid families)
    ssd_bwd = [(ms, c) for nm, ms, c in rows if "ssd_bwd" in nm]
    if ssd_bwd:
        log(f"[{tag} profile] the SSD backward's kernels: {sum(ms for ms, _ in ssd_bwd):.3f} ms "
            f"in {sum(c for _, c in ssd_bwd)} launches")
    return dict(wall_ms=wall_ms, device_ms=busy if rows else None,
                idle_share=max(0.0, 1 - busy / wall_ms) if rows else None,
                ssd_bwd_ms=sum(ms for ms, _ in ssd_bwd) if rows else None,
                top=[dict(name=nm, ms=ms, count=c) for nm, ms, c in rows[:24]])


def phase_vlm_path(tag="vlm path"):
    """FULL ``qwen2-vl-7b`` (28 layers, d 3584, GQA 28/4, hd 128, bf16, random
    weights from a CUDA generator of seed 0) on embeds: B 4 prompts of 2,048
    f32 embeds with the image-grid M-RoPE streams, ``model_prefill`` then 31
    greedy decode steps on tokens (32 new tokens), twice (28 flash launches
    each, all on the tensor-core kernel; the repeat bitwise), once the
    prefill alone; then the served logits against one teacher-forced
    ``model_forward`` over the prompt's embeds followed by the generated
    tokens' embedding rows, their positions extended at ``cache_len`` on all
    three streams (as decode gives them); a profiled run; and one short
    text-only ``ServeEngine.generate`` (text M-RoPE)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models.api import model_forward, model_init
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("qwen2-vl-7b")
    b, new, vocab = LM_BATCH, LM_NEW, cfg.vocab_size
    p = VLM_TEXT0 + VLM_GRID * VLM_GRID + VLM_TEXT1
    params, init_ms = _timed(lambda: model_init(cfg, _cuda_gen(0), device="cuda"))
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    embed = params["embed"]
    # Decode reads every weight but the untied embedding table (B rows of it).
    floor_ms = (weight_bytes - embed.numel() * embed.element_size()) / HBM_BPS * 1e3
    # The prefill's products: every parameter but the embedding table (the
    # prompt arrives as embeds), twice a token, at the bf16 peak.
    flop_params = cfg.param_count() - vocab * cfg.d_model
    prefill_floor_ms = 2.0 * flop_params * b * p / BF16_FLOPS * 1e3
    log(f"[{tag}] qwen2-vl-7b: {cfg.num_layers} layers, d {cfg.d_model}, GQA "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.resolved_head_dim}, {n_params:,} params "
        f"(param_count {cfg.param_count():,}), {weight_bytes / 1e9:.2f} GB of weights, made in "
        f"{init_ms:.0f} ms")
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(rng.standard_normal((b, p, cfg.d_model)).astype(np.float32)).cuda()
    positions = torch.from_numpy(_vlm_positions(b, VLM_TEXT0, VLM_GRID, VLM_TEXT1)).cuda()
    batch = {"embeds": embeds, "positions": positions}
    want = _lm_launches(cfg)
    toks, served, n, run_ms, prefill_ms, prefill_counts, peak = _repeat_twice(
        tag, params, cfg, batch, new, LM_MAX_LEN, want)
    if prefill_counts != want or n != p or tuple(toks.shape) != (b, new):
        raise RuntimeError(f"{tag}: prefill launched {prefill_counts} (expected {want}), "
                           f"cache_len {n}, tokens {tuple(toks.shape)}")
    decode_ms = (min(run_ms) - prefill_ms) / (new - 1)
    log(f"[{tag}] prefill {prefill_ms:.1f} ms ({b * p / prefill_ms * 1e3:,.0f} positions/s; "
        f"2 x params x positions at the bf16 peak: {prefill_floor_ms:.2f} ms), decode "
        f"{decode_ms:.2f} ms per token (batch {b}; weight-read floor {floor_ms:.2f} ms, "
        f"{decode_ms / floor_ms:.2f}x), peak device memory {peak / 2**30:.2f} GiB (weights "
        f"{weight_bytes / 2**30:.2f} GiB); prefill launches {prefill_counts}")

    # Teacher forcing: the generated tokens' embedding rows after the
    # prompt's embeds; decode gave token j the position p + j on all three
    # streams (the reference's M-RoPE decode).
    with torch.inference_mode():
        fed = toks[:, :-1]
        x = torch.cat([embeds, params["embed"][fed].float()], 1)
        ext = (p + torch.arange(new - 1, device=positions.device, dtype=torch.int32))[None, None]
        pos = torch.cat([positions, ext.expand(3, b, new - 1)], -1)
        fwd = model_forward(params, cfg, {"embeds": x, "positions": pos})[0]
        finite = bool(torch.isfinite(fwd).all()) and bool(torch.isfinite(served).all())
        tf = fwd[:, p - 1:, :vocab]
        del fwd
        agree = float((tf.argmax(-1) == toks).float().mean())
        rel = float(((tf - served).abs().amax(-1) / served.abs().max()).max())
        del tf, x
    log(f"[{tag}] teacher-forced forward vs served logits: argmax agreement {agree:.4f} "
        f"(>= {TF_AGREE}), max relative difference {rel:.4g} (< {TF_REL}); all finite: "
        f"{finite}")
    if not (finite and agree >= TF_AGREE and rel < TF_REL):
        raise RuntimeError(f"{tag}: teacher-forced check failed")
    profile = _profiled(tag, lambda: _greedy(params, cfg, batch, new, LM_MAX_LEN))

    # The engine serves the VLM config on token prompts (text M-RoPE).
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, device="cuda")
    tp = VLM_TEXT_PROMPT
    prompts = rng.integers(0, vocab, (b, tp))
    build.reset_launch_counts()
    text, text_ms = _timed(lambda: eng.generate(prompts, max_new_tokens=8))
    text_counts = build.launch_counts()
    log(f"[{tag}] text-only ServeEngine.generate B={b} P={tp} new=8: {text_ms:.1f} ms, "
        f"launches {text_counts}")
    if (text_counts != want or tuple(text.shape) != (b, tp + 8)
            or not torch.equal(text[:, :tp].cpu(), torch.as_tensor(prompts).int())):
        raise RuntimeError(f"{tag}: text generate launched {text_counts}, shape "
                           f"{tuple(text.shape)}")
    detail = dict(arch="qwen2-vl-7b", num_layers=cfg.num_layers, params=n_params,
                  weight_bytes=weight_bytes, init_ms=init_ms, run_ms=run_ms,
                  launches=want, prefill_launches=prefill_counts, prefill_ms=prefill_ms,
                  prefill_flop_floor_ms=prefill_floor_ms, decode_ms_per_token=decode_ms,
                  decode_weight_floor_ms=floor_ms, peak_bytes=peak,
                  teacher_forced_agreement=agree, teacher_forced_rel_diff=rel,
                  profile=profile, text_generate_ms=text_ms, text_launches=text_counts)
    del params, eng, embeds, served
    gc.collect()
    torch.cuda.empty_cache()
    return detail


def phase_encdec_path(tag="encdec path"):
    """FULL ``seamless-m4t-medium`` (12 + 12 layers, d 1024, 16 heads of 64,
    bf16, random weights from a CUDA generator of seed 0): B 4 x 1,024 f32
    source frames and a 4-token target prefix through ``model_prefill``,
    then 31 greedy ``model_decode_step``s (32 new tokens), twice (flash
    causal 12 and unmasked 24 per prefill, unmasked 12 per decode step; the
    repeat bitwise), once the prefill alone. The check: decoding the 36
    target tokens from ``model_init_cache`` (cache_len 0) against one
    teacher-forced ``model_forward``; the served path's gap to that forward
    (its decode attends to the prefill cache's zero self-attention rows, the
    reference's quirk) is logged, not gated."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.api import (
        model_decode_step,
        model_forward,
        model_init,
        model_init_cache,
    )

    cfg = get_config("seamless-m4t-medium")
    b, new, vocab, d = LM_BATCH, LM_NEW, cfg.vocab_size, cfg.d_model
    max_len = ENC_PREFIX + new
    params, init_ms = _timed(lambda: model_init(cfg, _cuda_gen(0), device="cuda"))
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    dec = params["decoder"]
    cross_w = dec["cross"]["wk"].numel() + dec["cross"]["wv"].numel()
    enc_w = sum(t.numel() for t in _leaves(params["encoder"]) if t.dim() == 3)
    dec_w = sum(t.numel() for t in _leaves(dec) if t.dim() == 3) - cross_w
    head = params["lm_head"]
    # The prefill's products, twice a token at the bf16 peak: the encoder and
    # the cross K/V projections over the source frames, the rest of the
    # decoder and the LM head over the target prefix (attention's scores
    # left out).
    prefill_floor_ms = 2.0 * ((enc_w + cross_w) * b * ENC_SRC
                              + (dec_w + head.numel()) * b * ENC_PREFIX) / BF16_FLOPS * 1e3
    kv_bytes = 2 * cfg.num_layers * b * ENC_SRC * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    dec_bytes = sum(t.numel() * t.element_size() for t in _leaves(dec))
    # A decode step reads the decoder's weights, the LM head and the cross K/V.
    floor_ms = (dec_bytes + head.numel() * head.element_size() + kv_bytes) / HBM_BPS * 1e3
    log(f"[{tag}] seamless-m4t-medium: {cfg.encoder_layers} + {cfg.num_layers} layers, d {d}, "
        f"{n_params:,} params (param_count {cfg.param_count():,}), {weight_bytes / 1e9:.2f} GB "
        f"of weights, made in {init_ms:.0f} ms; cross K/V {kv_bytes / 1e6:.1f} MB")
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((b, ENC_SRC, d)).astype(np.float32)).cuda()
    prefix = torch.from_numpy(rng.integers(0, vocab, (b, ENC_PREFIX))).cuda()
    batch = {"src_embeds": src, "tgt_tokens": prefix}
    layers, enc_layers = cfg.num_layers, cfg.encoder_layers
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tc = fa_ops.flash_variant(dt, cfg.resolved_head_dim) == "tensor_cores"
    # causal: the decoder's self-attention; unmasked: the encoder and the
    # cross-attention, and the cross-attention of each decode step
    per_prefill = {fa_ops.KERNEL: 2 * layers + enc_layers,
                   fa_ops.NONCAUSAL_KERNEL: layers + enc_layers}
    per_step = {fa_ops.KERNEL: layers, fa_ops.NONCAUSAL_KERNEL: layers}
    if tc:
        per_prefill[fa_ops.TC_KERNEL], per_step[fa_ops.TC_KERNEL] = 2 * layers + enc_layers, layers
    want = {k: c + (new - 1) * per_step[k] for k, c in per_prefill.items()}
    toks, served, n, run_ms, prefill_ms, prefill_counts, peak = _repeat_twice(
        tag, params, cfg, batch, new, max_len, want)
    if prefill_counts != per_prefill or n != ENC_PREFIX:
        raise RuntimeError(f"{tag}: prefill launched {prefill_counts} (expected {per_prefill}), "
                           f"cache_len {n}")
    decode_ms = (min(run_ms) - prefill_ms) / (new - 1)
    log(f"[{tag}] prefill {prefill_ms:.1f} ms (its products at the bf16 peak: "
        f"{prefill_floor_ms:.3f} ms), decode {decode_ms:.2f} ms per token (batch {b}; floor "
        f"{floor_ms:.3f} ms: decoder weights, LM head and cross K/V at 3.35 TB/s, "
        f"{decode_ms / floor_ms:.2f}x), peak device memory {peak / 2**30:.2f} GiB; prefill "
        f"launches {prefill_counts}, {layers} unmasked a decode step")

    # The check: the 36 target tokens decoded from an empty cache against one
    # teacher-forced forward.
    seq = torch.cat([prefix, toks], 1)
    with torch.inference_mode():
        fwd = model_forward(params, cfg, {"src_embeds": src, "tgt_tokens": seq})[0][..., :vocab]
        cache = model_init_cache(cfg, params, batch, max_len)
        steps = []
        for i in range(seq.shape[1]):
            lg, cache = model_decode_step(params, cfg, {"tokens": seq[:, i:i + 1]}, cache, i)
            steps.append(lg[:, :vocab])
        dec_logits = torch.stack(steps, 1)
        del cache, steps
    finite = bool(torch.isfinite(fwd).all()) and bool(torch.isfinite(dec_logits).all())
    agree = float((fwd.argmax(-1) == dec_logits.argmax(-1)).float().mean())
    rel = float(((fwd - dec_logits).abs().amax(-1) / dec_logits.abs().max()).max())
    tf = fwd[:, ENC_PREFIX - 1:ENC_PREFIX - 1 + new]
    quirk_agree = float((tf.argmax(-1) == toks).float().mean())
    quirk_rel = float(((tf - served).abs().amax(-1) / served.abs().max()).max())
    log(f"[{tag}] decode from model_init_cache over {seq.shape[1]} target tokens vs the "
        f"teacher-forced forward: argmax agreement {agree:.4f} (>= {TF_AGREE}), max relative "
        f"difference {rel:.4g} (< {TF_REL}); all finite: {finite}")
    log(f"[{tag}] the reference's quirk (decode after prefill attends to zero self K/V rows): "
        f"served vs forward argmax agreement {quirk_agree:.4f}, max relative difference "
        f"{quirk_rel:.4g} (logged, not gated)")
    if not (finite and agree >= TF_AGREE and rel < TF_REL):
        raise RuntimeError(f"{tag}: decode from an empty cache parts from the forward")
    profile = _profiled(tag, lambda: _greedy(params, cfg, batch, new, max_len))
    detail = dict(arch="seamless-m4t-medium", layers=[enc_layers, layers], params=n_params,
                  weight_bytes=weight_bytes, init_ms=init_ms, run_ms=run_ms, launches=want,
                  prefill_launches=prefill_counts, decode_step_launches=per_step,
                  prefill_ms=prefill_ms, prefill_flop_floor_ms=prefill_floor_ms,
                  decode_ms_per_token=decode_ms, decode_floor_ms=floor_ms,
                  cross_kv_bytes=kv_bytes, peak_bytes=peak, empty_cache_agreement=agree,
                  empty_cache_rel_diff=rel, quirk_agreement=quirk_agree,
                  quirk_rel_diff=quirk_rel, profile=profile)
    del params, src, fwd, dec_logits, served
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
    # (label, B, S, T, H, KV, hd, dtype, causal): Qwen3-8B, SmolLM-360M,
    # Granite-MoE (GQA group 3), Llama-4 Maverick (group 5) and Qwen2-VL-7B
    # (group 7) prefill, and a sequence ragged against the kernel's 64-row
    # blocks, in f32; unmasked: the SeamlessM4T-medium encoder (S = T =
    # 1,024), its cross-attention in prefill (36 target rows over 1,024
    # frames) and in a decode step (S = 1), and a ragged f32 case.
    for label, b, s, t, h, kv, hd, dt, causal in (
        ("qwen3-8b prefill bf16", 4, 2048, 2048, 32, 8, 128, torch.bfloat16, True),
        ("smollm-360m prefill bf16", 4, 2048, 2048, 15, 5, 64, torch.bfloat16, True),
        ("ragged S=1000 f32", 4, 1000, 1000, 32, 8, 128, torch.float32, True),
        ("granite-moe-3b prefill bf16", 4, 2048, 2048, 24, 8, 64, torch.bfloat16, True),
        ("llama4-maverick prefill bf16", 4, 2048, 2048, 40, 8, 128, torch.bfloat16, True),
        ("qwen2-vl-7b prefill bf16", 4, 2048, 2048, 28, 4, 128, torch.bfloat16, True),
        ("seamless encoder unmasked bf16", 4, 1024, 1024, 16, 16, 64, torch.bfloat16, False),
        ("seamless cross unmasked bf16", 4, 36, 1024, 16, 16, 64, torch.bfloat16, False),
        ("seamless cross decode unmasked bf16", 4, 1, 1024, 16, 16, 64, torch.bfloat16, False),
        ("ragged unmasked f32", 4, 100, 1000, 16, 16, 64, torch.float32, False),
    ):
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dt)
        bf16 = dt == torch.bfloat16
        variant = fa_ops.flash_variant(dt, hd)
        before = build.launch_counts().get(fa_ops.TC_KERNEL, 0)
        out = fa_ops.flash_attention(q, k, v, causal=causal)
        tc_ran = build.launch_counts().get(fa_ops.TC_KERNEL, 0) - before
        equal = float((out == flash_attention_ref(q, k, v, causal=causal)).float().mean())
        del out
        # (query, key) pairs the mask keeps: the causal triangle (S == T) or all
        pairs = s * (s + 1) // 2 if causal else s * t
        row = _kernel_case(
            f"flash_attention {label} B={b} S={s} T={t} H={h} KV={kv} hd={hd}",
            lambda: fa_ops.flash_attention(q, k, v, causal=causal),
            lambda: flash_attention_ref(q, k, v, causal=causal),
            # top-left causal == end-aligned causal when S == T
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
                enable_gqa=True).transpose(1, 2),
            FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL, 0.0 if bf16 else FLASH_F32_ATOL,
            nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(),
            ops=4.0 * b * h * hd * pairs, peak=BF16_FLOPS if bf16 else FP32_FLOPS)
        row.update(b=b, s=s, t=t, h=h, kv=kv, hd=hd, dtype=str(dt), causal=causal,
                   variant=variant, equal_share=equal, vs_library=row["ms"] / row["library_ms"],
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
    # Mamba2-370M prefill, a ragged chunk, and Jamba's prefill (N 16: half of
    # one 32-column staging chunk; 128 heads).
    for label, b, nc, q_, n, h, p in (("mamba2-370m prefill", 4, 8, 256, 128, 32, 64),
                                      ("ragged chunk Q=200", 4, 2, 200, 128, 32, 64),
                                      ("jamba prefill", 4, 8, 256, 16, 128, 64)):
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


# LM training (queue 1 item 4): FULL Qwen2-1.5B through the Trainer.
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_PARAMS = 1_543_714_304  # embedding 233,373,696 + 28 x 46,797,824 + 1,536
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4  # the LM cells' shape; 4 steps
TRAIN_REPEAT_STEPS = 2  # steps of each of the two runs held bitwise
TRAIN_LR = 1e-3  # launch/train.py's default
# The card against the CPU: full width cut to 2 layers, B 1 x 256, bf16 on
# both. Each gradient leaf within GRAD_REL of its largest CPU magnitude: bf16
# rounds activations and gradients at ~10 places a layer, which moves a leaf
# from its f32 value by 1-2.5% of that magnitude (printed beside, from the
# same params run in f32 on the CPU); two bf16 computations that round at
# other places may each be that far.
CPU_LAYERS, CPU_SHAPE, GRAD_REL, LOSS_REL = 2, (1, 256), 5e-2, 1e-2
# Crash and resume: full width cut to 2 layers, B 2 x 512, a checkpoint every
# 3 steps, 6 steps straight against a crash after step 3 and a resume.
RESUME_LAYERS, RESUME_SHAPE, RESUME_EVERY, RESUME_STEPS = 2, (2, 512), 3, 6
LAUNCHER_STEPS = 3  # the launcher's default run (REDUCED, f32: the CUDA-core backward)
# The ssm family's training through the same phase: FULL Mamba2-370M, no cut
# (its saved activations, ~1.3 GB a layer at B 4 x 2,048, fit the card).
SSM_TRAIN_ARCH = "mamba2-370m"
SSM_TRAIN_PARAMS = 368_338_432  # embedding 51,486,720 + 48 x 6,601,056 + 1,024
SSM_TRAIN_BATCH = 4
# The hybrid family: REDUCED Jamba (f32, 8 layers: 7 SSD, 1 flash on the
# CUDA-core pair, MoE every 2nd) through the Trainer, B 4 x 512 (two chunks
# of 256), and its gradients against the CPU's at the f32 tolerance.
HYBRID_TRAIN_ARCH = "jamba-v0.1-52b"
HYBRID_STEPS, HYBRID_SHAPE = 3, (4, 512)
F32_ATOL, F32_RTOL = 5e-4, 1e-3  # tests/test_gnn_models.py:46
# The SSD backward against its plain version (1e-4 of each gradient's max,
# as the forward's SSD_ATOL): (label, B, NC, Q, N, H, P).
# Calls of a profiled run that times a kernel a call: a profiling session
# that starts with device work loses its first kernels, and a session of a
# few calls recorded none in a whole run of this script.
PROFILED_CALLS = 20
SSD_BWD_CASES = (
    ("mamba2-370m training", 4, 8, 256, 128, 32, 64),
    ("jamba training", 4, 8, 256, 16, 128, 64),
    ("ragged chunk Q=200", 4, 2, 200, 128, 32, 64),
    ("REDUCED launcher P=16", 8, 1, 64, 16, 8, 16),
)


def _train_cfg(tcfg_kw):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainerConfig

    return TrainerConfig(opt=AdamWConfig(lr=TRAIN_LR), log_every=1, **tcfg_kw)


def _tree_leaves(tree):
    """Leaves of a params or train-state tree (dict keys sorted, lists,
    tuples and AdamWState in order), as the port's optimiser orders them."""
    from repro_torch.optim.adamw import _leaves as leaves

    return leaves(tree)


def _param_leaves(state):
    return _tree_leaves(state["params"])


def _timed_steps(trainer, records, snap_at):
    """Wrap ``trainer.step_fn``: CUDA events around each step, the kernels'
    launch counts and the peak allocated bytes of each step, and a host copy
    of the params after step ``snap_at``. The Trainer calls the wrapper as it
    calls its own step."""
    import torch

    from repro_torch.kernels import build

    step_fn, snap = trainer.step_fn, {}

    def timed(state, batch):
        before = dict(build.launch_counts())
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, metrics = step_fn(state, batch)
        ev[1].record()
        records.append(dict(events=ev, peak=torch.cuda.max_memory_allocated(), launches={
            k: v - before.get(k, 0) for k, v in build.launch_counts().items()
            if v - before.get(k, 0)}))
        if len(records) == snap_at:
            snap["params"] = [t.detach().cpu() for t in _param_leaves(state)]
        return state, metrics

    trainer.step_fn = timed
    return snap


def _phase_split(cfg, tcfg, state, batch):
    """One more step in the train step's three phases, each timed by CUDA
    events: ``loss_fn``, ``torch.autograd.grad`` and ``adamw_update`` at the
    schedule's lr. Returns (the new state, forward, backward, optimizer ms)."""
    import torch

    from repro_torch.models.api import loss_fn
    from repro_torch.optim.adamw import _rebuild, adamw_update
    from repro_torch.optim.schedule import warmup_cosine

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    leaves = [p.detach().requires_grad_(p.is_floating_point()) for p in _param_leaves(state)]
    loss, _ = loss_fn(_rebuild(state["params"], iter(leaves)), cfg, batch)
    ev[1].record()
    got = iter(torch.autograd.grad(loss, [p for p in leaves if p.requires_grad]))
    ev[2].record()
    grads = _rebuild(state["params"], iter(
        [next(got) if p.requires_grad else torch.zeros_like(p) for p in leaves]))
    lr = warmup_cosine(state["step"] + 1, peak_lr=tcfg.opt.lr, warmup=tcfg.warmup,
                       total=tcfg.steps)
    params, opt, _ = adamw_update(grads, state["opt"], state["params"], tcfg.opt, lr=lr)
    ev[3].record()
    torch.cuda.synchronize()
    return ({"params": params, "opt": opt, "step": state["step"] + 1},
            *(a.elapsed_time(b) for a, b in zip(ev, ev[1:])))


def _train_launches(cfg):
    """Each kernel counter's launches in one train step of ``cfg``: the
    forward's (``_lm_launches``) and its backward's, once per layer of their
    mixer (a counter listed at 0 must not run: flash off the tensor cores)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    want = _lm_launches(cfg)
    if fa_ops.KERNEL in want:
        tc = want.setdefault(fa_ops.TC_KERNEL, 0)
        want.update({fa_ops.BWD_DQ_KERNEL: want[fa_ops.KERNEL],
                     fa_ops.BWD_DKDV_KERNEL: want[fa_ops.KERNEL], fa_ops.BWD_TC_KERNEL: tc})
    if ssd_ops.KERNEL in want:
        want[ssd_ops.KERNEL_BWD] = want[ssd_ops.KERNEL]
    return want


def phase_lm_train(arch=TRAIN_ARCH, n_expected=TRAIN_PARAMS, batch=TRAIN_BATCH,
                   tag="lm train", batch_reason=""):
    """FULL ``arch`` (Qwen2-1.5B; Mamba2-370M in ``ssm train``) trained
    through ``Trainer`` (the code under ``launch.train``) on B ``batch`` x
    2,048 tokens: two runs bitwise, 4 timed steps with their launches (the
    forward and backward kernels once per layer of their mixer), a profiled
    step; the card against the CPU at 2 layers; crash and resume at 2
    layers, bitwise; the launcher's REDUCED default."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import analytic
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.api import param_shapes
    from repro_torch.models.lm.transformer import mixer_counts
    from repro_torch.train.loop import Trainer
    from repro_torch.train.train_step import _grads

    cfg = get_config(arch)
    n_params = sum(math.prod(s) for s in _leaves(param_shapes(cfg)))
    tokens = batch * TRAIN_SEQ
    row = dict(arch=arch, params=n_params, batch=batch, seq=TRAIN_SEQ, batch_reason=batch_reason)
    mixer = (f"GQA {cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}"
             if cfg.family != "ssm" else
             f"state {cfg.ssm_state}, {cfg.ssm_heads} heads of {cfg.ssm_headdim}, chunk "
             f"{cfg.ssm_chunk}")
    log(f"[{tag}] FULL {arch}: {cfg.num_layers} layers, d {cfg.d_model}, {mixer}, vocab "
        f"{cfg.vocab_size}: {n_params:,} params; B {batch} x {TRAIN_SEQ}"
        f"{f' ({batch_reason})' if batch_reason else ''}; {card_line()}")
    if n_params != n_expected:
        raise RuntimeError(f"{arch} has {n_params} params, not {n_expected}")

    # (a) The timed run: launch counts set to 0 just before, read just after;
    # a host copy of its params after TRAIN_REPEAT_STEPS steps.
    tcfg = _train_cfg(dict(steps=TRAIN_STEPS, batch=batch, seq=TRAIN_SEQ))
    trainer = Trainer(cfg, tcfg)
    step_fn, timed = trainer.step_fn, []
    snap = _timed_steps(trainer, timed, TRAIN_REPEAT_STEPS)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.run()
    torch.cuda.synchronize()
    row["run_s"] = time.perf_counter() - t0
    row["launches"] = build.launch_counts()
    state, records = out["state"], out["metrics"]
    del out

    # (b) The warm steps' phases: as many more steps, continuing the run, by
    # this script's own calls of the train step's three parts.
    split = []
    for i in range(TRAIN_STEPS - 1):
        state, *ms = _phase_split(cfg, tcfg, state, trainer.batch(TRAIN_STEPS + i))
        split.append(ms)
    want = _train_launches(cfg)
    fwd_flops = 4.0 * batch * cfg.num_heads * cfg.resolved_head_dim * (
        TRAIN_SEQ * (TRAIN_SEQ + 1) // 2) * mixer_counts(cfg)["attn"]
    model_flops = 6.0 * n_params * tokens
    # The analytic model's step (3 x the forward, the SSD's quadratic terms in).
    step_flops = analytic.step_flops(cfg, ShapeSpec(tag, TRAIN_SEQ, batch, "train"))
    steps = []
    for i, (t, rec) in enumerate(zip(timed, records)):
        cnt, peak = t["launches"], t["peak"]
        st = dict(step=rec["step"], loss=rec["loss"], ce=rec["ce"], grad_norm=rec["grad_norm"],
                  lr=rec["lr"], step_ms=t["events"][0].elapsed_time(t["events"][1]),
                  peak_bytes=peak, launches=cnt)
        if i:
            st["forward_ms"], st["backward_ms"], st["optimizer_ms"] = split[i - 1]
        st["tokens_per_s"] = tokens / st["step_ms"] * 1e3
        st["model_flop_share"] = model_flops / (st["step_ms"] / 1e3) / BF16_FLOPS
        st["with_attention_share"] = (model_flops + 3 * fwd_flops) / (st["step_ms"] / 1e3) / BF16_FLOPS
        st["analytic_share"] = step_flops / (st["step_ms"] / 1e3) / BF16_FLOPS
        steps.append(st)
        phases = (f"; step {TRAIN_STEPS + i}'s phases: forward {st['forward_ms']:.1f} ms "
                  f"backward {st['backward_ms']:.1f} ms optimizer {st['optimizer_ms']:.1f} ms"
                  if i else "")
        log(f"[{tag}] step {st['step']}{' (cold)' if i == 0 else ''}: loss {st['loss']:.4f} "
            f"ce {st['ce']:.4f} grad_norm {st['grad_norm']:.4f} lr {st['lr']:.3g}; step "
            f"{st['step_ms']:.1f} ms, {st['tokens_per_s']:,.0f} tokens/s; peak "
            f"{peak / 2**30:.2f} GiB; launches {cnt}{phases}")
        if any(cnt.get(k, 0) != v for k, v in want.items()):
            raise RuntimeError(f"{tag} step {st['step']}: launches {cnt}, expected {want}")
        if not all(math.isfinite(st[k]) for k in ("loss", "ce", "grad_norm")):
            raise RuntimeError(f"{tag} step {st['step']}: not finite: {st}")

    warm = steps[1:]
    row["steps"] = steps
    row["warm_step_ms"] = sum(s["step_ms"] for s in warm) / len(warm)
    row["model_flop_share"] = model_flops / (row["warm_step_ms"] / 1e3) / BF16_FLOPS
    row["with_attention_share"] = (model_flops + 3 * fwd_flops) / (row["warm_step_ms"] / 1e3) / BF16_FLOPS
    row["analytic_step_flops"] = step_flops
    row["analytic_share"] = step_flops / (row["warm_step_ms"] / 1e3) / BF16_FLOPS
    row["tokens_per_s"] = tokens / row["warm_step_ms"] * 1e3
    row["peak_bytes"] = max(s["peak_bytes"] for s in steps)
    attention = (f", with attention (3 x {fwd_flops / 1e12:.2f} TFLOP causal) "
                 f"{row['with_attention_share']:.3f}" if fwd_flops else "")
    log(f"[{tag}] {TRAIN_STEPS} steps: launches {row['launches']}; warm step "
        f"{row['warm_step_ms']:.1f} ms, {row['tokens_per_s']:,.0f} tokens/s: model-flop share "
        f"6 x {n_params:,} x {tokens} / step / {BF16_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{row['model_flop_share']:.3f}{attention}; analytic.step_flops "
        f"{step_flops / 1e12:.2f} TFLOP / step: {row['analytic_share']:.3f}; {card_line()}")
    if any(row["launches"].get(k, 0) != v * TRAIN_STEPS for k, v in want.items()):
        raise RuntimeError(f"{tag}: launches {row['launches']}")

    # (c) Where a warm step's time goes: one more step of the same run under
    # the profiler.
    row["profile"] = _profiled(tag, lambda: step_fn(state, trainer.batch(2 * TRAIN_STEPS - 1)))
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # (d) A second run from the same seed, TRAIN_REPEAT_STEPS steps: bitwise
    # the timed run's params at that step (both inside the 10-step warmup,
    # where the lr does not depend on the run's length).
    params = _param_leaves(Trainer(cfg, _train_cfg(dict(
        steps=TRAIN_REPEAT_STEPS, batch=batch, seq=TRAIN_SEQ))).run()["state"])
    row["repeat_bitwise"] = all(torch.equal(a, b.cpu()) for a, b in zip(snap["params"], params))
    del params, snap
    log(f"[{tag}] a second {TRAIN_REPEAT_STEPS}-step run from seed 0: params bitwise the "
        f"timed run's at step {TRAIN_REPEAT_STEPS}: {row['repeat_bitwise']}")
    if not row["repeat_bitwise"]:
        raise RuntimeError(f"{tag}: two runs from the same seed differ")
    gc.collect()
    torch.cuda.empty_cache()

    # (e) The card against the CPU: loss, ce and every gradient leaf, 2 layers.
    small = dataclasses.replace(cfg, num_layers=CPU_LAYERS)
    tr = Trainer(small, _train_cfg(dict(steps=1, batch=CPU_SHAPE[0], seq=CPU_SHAPE[1])))
    params = tr.init_state()["params"]
    batch = tr.batch(0)
    build.reset_launch_counts()
    loss, metrics, grads = _grads(params, small, batch)
    card_counts = build.launch_counts()
    g_card = [g.cpu() for g in _tree_leaves(grads)]
    cpu_params = _rebuild_like(params, "cpu", None)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    closs, cmetrics, cgrads = _grads(cpu_params, small, cpu_batch)
    f32 = dataclasses.replace(small, dtype="float32")
    floss, _, fgrads = _grads(_rebuild_like(params, "cpu", torch.float32), f32, cpu_batch)
    rel = [float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
           for a, b in zip(g_card, _tree_leaves(cgrads))]
    rel_f32 = [float((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(_tree_leaves(cgrads), _tree_leaves(fgrads))]
    loss_rel = abs(float(loss) - float(closs)) / abs(float(closs))
    ce_rel = abs(float(metrics["ce"]) - float(cmetrics["ce"])) / abs(float(cmetrics["ce"]))
    row["cpu"] = dict(layers=CPU_LAYERS, shape=list(CPU_SHAPE), loss=float(loss),
                      cpu_loss=float(closs), f32_loss=float(floss), loss_rel=loss_rel,
                      ce_rel=ce_rel, grad_rel_max=max(rel), grad_rel=rel,
                      cpu_bf16_vs_f32_rel_max=max(rel_f32), launches=card_counts)
    log(f"[{tag}] card vs CPU, {CPU_LAYERS} layers at full width, B {CPU_SHAPE[0]} x "
        f"{CPU_SHAPE[1]}: loss {float(loss):.5f} vs {float(closs):.5f} (f32 {float(floss):.5f}), "
        f"relative {loss_rel:.2e}, ce {ce_rel:.2e} (<= {LOSS_REL}); {len(rel)} gradient leaves, "
        f"max |card - CPU| / max |CPU| = {max(rel):.4f} (<= {GRAD_REL}); the CPU's bf16 against "
        f"its f32: {max(rel_f32):.4f}; card launches {card_counts}")
    if not (loss_rel <= LOSS_REL and ce_rel <= LOSS_REL and max(rel) <= GRAD_REL):
        raise RuntimeError(f"{tag}: card vs CPU loss {loss_rel}, ce {ce_rel}, grads {rel}")
    if any(card_counts.get(k, 0) != v for k, v in _train_launches(small).items()):
        raise RuntimeError(f"{tag}: the card's gradient launched {card_counts}")
    del params, grads, g_card, cpu_params, cgrads, fgrads, tr
    gc.collect()
    torch.cuda.empty_cache()

    # (f) Crash and resume, bitwise; each checkpoint's bytes, save and restore s.
    small = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
    kw = dict(steps=RESUME_STEPS, batch=RESUME_SHAPE[0], seq=RESUME_SHAPE[1],
              ckpt_every=RESUME_EVERY)
    tmp = tempfile.mkdtemp(prefix="lm_train_ckpt_")
    try:
        straight = [t.detach() for t in _param_leaves(Trainer(small, _train_cfg(kw)).run()["state"])]
        d = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        try:
            Trainer(small, _train_cfg(dict(kw, ckpt_dir=d))).run(crash_at=RESUME_EVERY)
            raise RuntimeError(f"{tag}: the injected fault did not fire")
        except RuntimeError as e:
            if "injected fault" not in str(e):
                raise
        crashed_s = time.perf_counter() - t0
        saved = ckpt.latest_step(d)
        t0 = time.perf_counter()
        resumed = Trainer(small, _train_cfg(dict(kw, ckpt_dir=d))).run()
        resumed_s = time.perf_counter() - t0
        state = resumed["state"]
        same = all(torch.equal(a, b) for a, b in zip(straight, _param_leaves(state)))
        sizes = {}
        for name in sorted(os.listdir(d)):
            p = os.path.join(d, name)
            sizes[name] = sum(os.path.getsize(os.path.join(p, f)) for f in os.listdir(p))
        d2 = os.path.join(tmp, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(state, d2, RESUME_STEPS)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.restore(d2, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_equal = all(torch.equal(a, b) for a, b in zip(_tree_leaves(back),
                                                               _tree_leaves(state)))
        nbytes = sizes[f"step_{RESUME_STEPS:09d}"]
        row["resume"] = dict(layers=RESUME_LAYERS, shape=list(RESUME_SHAPE), every=RESUME_EVERY,
                             steps=RESUME_STEPS, saved_step=saved, bitwise=same,
                             checkpoint_bytes=sizes, save_s=save_s, restore_s=restore_s,
                             restored_equal=restored_equal, crashed_run_s=crashed_s,
                             resumed_run_s=resumed_s)
        log(f"[{tag}] crash after step {RESUME_EVERY} (checkpoint at step {saved}) and resume "
            f"to {RESUME_STEPS}, {RESUME_LAYERS} layers at full width, B {RESUME_SHAPE[0]} x "
            f"{RESUME_SHAPE[1]}: params bitwise the straight run's {same}; checkpoints "
            f"{ {k: f'{v / 1e9:.3f} GB' for k, v in sizes.items()} }; save {save_s:.2f} s "
            f"({nbytes / save_s / 1e9:.2f} GB/s), restore {restore_s:.2f} s "
            f"({nbytes / restore_s / 1e9:.2f} GB/s), restored bitwise {restored_equal}")
        if not (same and restored_equal and saved == RESUME_EVERY):
            raise RuntimeError(f"{tag}: crash-resume {row['resume']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (g) The launcher as a user calls it by default: REDUCED (f32; Qwen2's
    # hd 20 runs flash's backward on the CUDA-core pair); counts set to 0
    # just before, read just after.
    reduced = get_config(arch, reduced=True)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_launcher.main(["--arch", arch, "--steps", str(LAUNCHER_STEPS)])
    torch.cuda.synchronize()
    counts = build.launch_counts()
    row["launcher"] = dict(arch=arch, reduced=True, dtype=reduced.dtype,
                           steps=LAUNCHER_STEPS, s=time.perf_counter() - t0, launches=counts,
                           loss=[r["loss"] for r in out["metrics"]])
    log(f"[{tag}] the launcher's default (REDUCED {arch}, {reduced.dtype}), {LAUNCHER_STEPS} "
        f"steps: losses {[round(x, 4) for x in row['launcher']['loss']]}, launches {counts}")
    if (any(counts.get(k, 0) != v * LAUNCHER_STEPS for k, v in _train_launches(reduced).items())
            or not all(math.isfinite(x) for x in row["launcher"]["loss"])):
        raise RuntimeError(f"{tag}: the launcher's default run launched {counts}")
    return row


def _rebuild_like(params, device, dtype):
    """A copy of ``params`` on ``device`` (in ``dtype`` when given)."""
    from repro_torch.optim.adamw import _rebuild

    return _rebuild(params, iter([t.detach().to(device=device, dtype=dtype or t.dtype)
                                  for t in _tree_leaves(params)]))


def _bwd_entry_points(q, k, v, out, lse, do, causal, variant, splits=None):
    """(dq kernel call, dk/dv kernel call, (dq, dk, dv)) of one variant's C
    entry points on the case's inputs, with the scratch the wrapper would
    allocate (the tensor-core pair with the wrapper's head splits, or
    ``splits``)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty_like(lse)
    scale = 1.0 / math.sqrt(hd)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tail = (b, s, t, h, kv, hd, int(causal), scale)
    if variant == "cuda_cores":
        flag = int(q.dtype == torch.bfloat16)
        return (lambda: build.call("ample_flash_attention_bwd_dq", q.device, *ptrs, out.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
                                   flag, *tail),
                lambda: build.call("ample_flash_attention_bwd_dkdv", q.device, *ptrs,
                                   do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), flag, *tail),
                (dq, dk, dv))
    if splits is None:
        splits = fa_ops.bwd_head_splits(
            b, t, kv, h // kv, torch.cuda.get_device_properties(q.device).multi_processor_count)
    part = (torch.empty((2, splits, b, t, kv, hd), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    return (lambda: build.call("ample_flash_attention_bwd_tc_dq", q.device, *ptrs, out.data_ptr(),
                               do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
                               *tail),
            lambda: build.call("ample_flash_attention_bwd_tc_dkdv", q.device, *ptrs,
                               do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), None if part is None else part.data_ptr(), splits,
                               *tail),
            (dq, dk, dv))


def phase_flash_bwd():
    """The backward through its wrapper against ``flash_attention_bwd_ref``
    at the training shapes (bf16 on the tensor-core pair, f32 on the
    CUDA-core pair), each kernel of each pair the case runs timed, the pairs
    in turns, beside the plain version, the bound and one
    ``torch.autograd.grad`` of ``scaled_dot_product_attention``; the
    forward's lse against ``flash_attention_lse_ref``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_lse_ref,
    )

    gen = _cuda_gen(7)
    rows = []
    # (label, B, S, T, H, KV, hd, dtype, causal): Qwen2-1.5B's training shape,
    # SmolLM-360M's, the REDUCED configs' hd 20 in f32, an unmasked cross
    # shape (36 target rows over 1,024 frames), and a ragged T of 1,000 keys.
    for label, b, s, t, h, kv, hd, dt, causal in (
        ("qwen2-1.5b train bf16", 4, 2048, 2048, 12, 2, 128, torch.bfloat16, True),
        ("smollm-360m train bf16", 4, 2048, 2048, 15, 5, 64, torch.bfloat16, True),
        ("reduced hd 20 f32", 4, 2048, 2048, 3, 1, 20, torch.float32, True),
        ("cross unmasked bf16", 4, 36, 1024, 16, 16, 64, torch.bfloat16, False),
        ("ragged T=1000 bf16", 4, 1000, 1000, 12, 2, 128, torch.bfloat16, True),
    ):
        q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
        bf16 = dt == torch.bfloat16
        out, lse = fa_ops._forward(q, k, v, causal, with_lse=True)
        want_out, want_lse = flash_attention_lse_ref(q, k, v, causal=causal)
        lse_err = float((lse - want_lse).abs().max())
        lse_out_equal = bool(torch.equal(out, fa_ops.flash_attention(q, k, v, causal=causal)))
        out_err = float((out.float() - want_out.float()).abs().max())
        del want_out, want_lse
        variant = fa_ops.flash_variant(dt, hd)
        before = build.launch_counts().get(fa_ops.BWD_TC_KERNEL, 0)
        got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        again = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        tc_launches = build.launch_counts().get(fa_ops.BWD_TC_KERNEL, 0) - before
        want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
        tol = 2.0 ** -7 if bf16 else 1e-4  # share of the tensor's largest magnitude
        errs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
        rels = [e / float(w.float().abs().max()) for e, w in zip(errs, want)]
        del again, want
        pairs = s * (s + 1) // 2 + s * (t - s) if causal else s * t  # (query, key) pairs seen
        fwd_ops = 4.0 * b * h * hd * pairs
        peak = BF16_FLOPS if bf16 else FP32_FLOPS
        el = q.element_size()
        qb, kb, lb = q.numel() * el, k.numel() * el, lse.numel() * 4

        # Each pair the case can run, by its C entry points; the pairs in
        # turns (CUDA-core, tensor-core, tensor-core, CUDA-core).
        calls = {"cuda_cores": _bwd_entry_points(q, k, v, out, lse, do, causal, "cuda_cores")}
        if variant == "tensor_cores":
            calls["tensor_cores"] = _bwd_entry_points(q, k, v, out, lse, do, causal, variant)
        for dq_call, dkdv_call, _ in calls.values():
            dq_call()
            dkdv_call()
        torch.cuda.synchronize()
        pair = {}
        for name in ("cuda_cores", "tensor_cores", "tensor_cores", "cuda_cores"):
            if name in calls:
                dq_call, dkdv_call, _ = calls[name]
                pair.setdefault(name, []).append(
                    cuda_ms(lambda: (dq_call(), dkdv_call()), reps=5))
        kernel_ms = {name: (cuda_ms(dq_call, reps=5), cuda_ms(dkdv_call, reps=5))
                     for name, (dq_call, dkdv_call, _) in calls.items()}
        # the pairs against each other, share of each gradient's largest magnitude
        pair_diff = None
        if len(calls) == 2:
            pair_diff = max(float((a.float() - c.float()).abs().max() / c.float().abs().max())
                            for a, c in zip(calls["tensor_cores"][2], calls["cuda_cores"][2]))
        bwd_ms = cuda_ms(lambda: fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal),
                         reps=3)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal),
                           reps=2)
        # The library: one torch.autograd.grad of SDPA (top-left causal is the
        # end-aligned mask when S == T; every causal case here has S == T).
        lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal, enable_gqa=True)
        ldo = do.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True),
                         reps=5)
        lib = torch.autograd.grad(lout, (lq, lk, lv), ldo)
        lib_err = max(float((a.transpose(1, 2).float() - c.float()).abs().max())
                      for a, c in zip(lib, got))
        del lout, lib, lq, lk, lv, got, calls
        # bounds: bytes each input read once and each output written once;
        # operations: dQ's kernel S, dP and dS K (3 of the forward's 2 products'
        # worth, 1.5x), dK/dV's S, dP, P^T dO and dS^T Q (2x), the pair 2.5x.
        # The tensor-core pair's own products: P and dS are two bf16 terms
        # each, so dQ's kernel runs 4 products and dK/dV's 6 (5x the forward's).
        dq_bound = bound(4 * qb + 2 * kb + 2 * lb, 1.5 * fwd_ops, peak)
        dkdv_bound = bound(2 * qb + 2 * kb + 2 * lb + 2 * kb, 2.0 * fwd_ops, peak)
        pair_bound = bound(4 * qb + 4 * kb + lb, 2.5 * fwd_ops, peak)
        cc, tc = pair["cuda_cores"], pair.get("tensor_cores")
        ran = tc if variant == "tensor_cores" else cc
        dq_ms, dkdv_ms = kernel_ms[variant]
        row = dict(case=label, b=b, s=s, t=t, h=h, kv=kv, hd=hd, dtype=str(dt), causal=causal,
                   variant=variant, tc_launches=tc_launches,
                   splits=fa_ops.bwd_head_splits(
                       b, t, kv, h // kv, torch.cuda.get_device_properties(0).multi_processor_count)
                   if variant == "tensor_cores" else None,
                   max_abs_err=max(errs), err_dq=errs[0], err_dk=errs[1], err_dv=errs[2],
                   rel_to_max=rels, tol=tol, bitwise=bitwise, lse_err=lse_err,
                   lse_out_equal=lse_out_equal, out_err=out_err, dq_ms=dq_ms, dkdv_ms=dkdv_ms,
                   pair_ms=sum(ran) / len(ran), cc_pair_ms=cc, tc_pair_ms=tc,
                   cc_dq_ms=kernel_ms["cuda_cores"][0], cc_dkdv_ms=kernel_ms["cuda_cores"][1],
                   tc_vs_cc=pair_diff, ms=bwd_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   library_err=lib_err, dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                   dkdv_bound_ms=dkdv_bound[0], dkdv_bound_by=dkdv_bound[1],
                   bound_ms=pair_bound[0], bound_by=pair_bound[1], fwd_gflop=fwd_ops / 1e9,
                   tc_design_gflop=5 * fwd_ops / 1e9 if variant == "tensor_cores" else None)
        turns = (f"pairs in turns: CUDA-core {cc[0]:.3f}, tensor-core {tc[0]:.3f}, {tc[1]:.3f}, "
                 f"CUDA-core {cc[1]:.3f} ms; tensor-core vs CUDA-core {pair_diff:.2e} of max; "
                 f"the tensor-core design's products {5 * fwd_ops / 1e9:.1f} GFLOP"
                 if tc else f"CUDA-core pair {cc[0]:.3f}, {cc[1]:.3f} ms")
        log(f"[flash bwd] {label} B={b} S={s} T={t} H={h} KV={kv} hd={hd}: {variant} "
            f"({tc_launches // 2} tensor-core launch a call), err dq {errs[0]:.3g} dk "
            f"{errs[1]:.3g} dv {errs[2]:.3g} (share of max {max(rels):.2e} <= {tol:.2e}), "
            f"bitwise {bitwise}; lse err {lse_err:.2e}, out with lse bitwise without "
            f"{lse_out_equal}; dq kernel {dq_ms:.3f} ms (bound {dq_bound[0]:.3f}, "
            f"{dq_bound[1]}), dkdv kernel {dkdv_ms:.3f} ms (bound {dkdv_bound[0]:.3f}, "
            f"{dkdv_bound[1]}); {turns}; backward {bwd_ms:.3f} ms, bound {pair_bound[0]:.3f} ms "
            f"({pair_bound[1]}: {2.5 * fwd_ops / 1e9:.1f} GFLOP), plain {plain_ms:.3f} ms, SDPA "
            f"backward {lib_ms:.3f} ms (diff {lib_err:.3g}); {bwd_ms / lib_ms:.2f}x SDPA, "
            f"{bwd_ms / pair_bound[0]:.1f}x the bound; {card_line()}")
        if not (bitwise and max(rels) <= tol and lse_err <= 1e-4 and lse_out_equal
                and tc_launches == (2 if variant == "tensor_cores" else 0)):
            raise RuntimeError(f"flash bwd {label}: {row}")
        rows.append(row)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return rows


def phase_hybrid_train():
    """REDUCED Jamba (the hybrid family: SSD, flash and MoE layers) trained
    through ``Trainer`` for HYBRID_STEPS steps on the card, its launches per
    step, and one gradient of ``loss_fn`` on the card against the CPU's (the
    plain versions) at the f32 tolerance, every leaf."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.train.loop import Trainer
    from repro_torch.train.train_step import _grads

    full = get_config(HYBRID_TRAIN_ARCH)
    cfg = get_config(HYBRID_TRAIN_ARCH, reduced=True)
    log(f"[hybrid train] REDUCED {HYBRID_TRAIN_ARCH} ({cfg.dtype}, {cfg.num_layers} layers, d "
        f"{cfg.d_model}, state {cfg.ssm_state}, {cfg.num_experts} experts); FULL cannot train on "
        f"one card: {full.param_count() / 1e9:.1f} B params are "
        f"{full.param_count() * 2 / 1e9:.1f} GB of bf16 weights, with f32 AdamW moments and "
        f"bf16 grads ~{full.param_count() * 12 / 1e9:.0f} GB; B {HYBRID_SHAPE[0]} x "
        f"{HYBRID_SHAPE[1]}")
    tr = Trainer(cfg, _train_cfg(dict(steps=HYBRID_STEPS, batch=HYBRID_SHAPE[0],
                                      seq=HYBRID_SHAPE[1])))
    records = []
    _timed_steps(tr, records, 0)
    build.reset_launch_counts()
    out = tr.run()
    torch.cuda.synchronize()
    want = _train_launches(cfg)
    steps = [dict(step=m["step"], loss=m["loss"], step_ms=r["events"][0].elapsed_time(
        r["events"][1]), launches=r["launches"]) for m, r in zip(out["metrics"], records)]
    for st in steps:
        log(f"[hybrid train] step {st['step']}: loss {st['loss']:.4f}, {st['step_ms']:.1f} ms, "
            f"launches {st['launches']}")
        if any(st["launches"].get(k, 0) != v for k, v in want.items()) or not math.isfinite(
                st["loss"]):
            raise RuntimeError(f"hybrid train step {st['step']}: {st}, expected {want}")
    params = tr.init_state()["params"]
    batch = tr.batch(0)
    loss, _, grads = _grads(params, cfg, batch)
    g_card = [g.cpu() for g in _tree_leaves(grads)]
    closs, _, cgrads = _grads(_rebuild_like(params, "cpu", None), cfg,
                              {k: v.cpu() for k, v in batch.items()})
    worst = max(float(((a - b).abs() - F32_RTOL * b.abs()).max())
                for a, b in zip(g_card, _tree_leaves(cgrads)))
    err = max(float((a - b).abs().max()) for a, b in zip(g_card, _tree_leaves(cgrads)))
    row = dict(arch=HYBRID_TRAIN_ARCH, reduced=True, shape=list(HYBRID_SHAPE), steps=steps,
               loss=float(loss), cpu_loss=float(closs), grad_max_abs_err=err,
               grad_leaves=len(g_card), want=want)
    log(f"[hybrid train] card vs CPU: loss {float(loss):.6f} vs {float(closs):.6f}; "
        f"{len(g_card)} gradient leaves, max |card - CPU| {err:.3g}, worst excess over "
        f"rtol {F32_RTOL}: {worst:.3g} (<= atol {F32_ATOL})")
    if not (worst <= F32_ATOL and abs(float(loss) - float(closs)) <= F32_ATOL + F32_RTOL * abs(
            float(closs))):
        raise RuntimeError(f"hybrid train: card vs CPU {row}")
    return row


def ssd_bwd_inputs(b, nc, q, n, h, p, seed):
    """(cc, bc, xdt, acum, dy) on the card from ``seed``: unit-normal C, B,
    Xdt and dY and a realistic decreasing log-decay, as the lm kernels phase."""
    import torch

    gen = _cuda_gen(seed)
    cc = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    bc = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    xdt = torch.randn((b, nc, h, q, p), generator=gen, device="cuda")
    dy = torch.randn((b, nc, h, q, p), generator=gen, device="cuda")
    acum = -torch.cumsum(torch.rand((b, nc, h, q), generator=gen, device="cuda") * 0.05, -1)
    return cc, bc, xdt, acum, dy


def ssd_bwd_work(b, nc, q, n, h, p):
    """(operations, bytes) the SSD backward needs: dXdt and dW per head, dC
    and dB, and C Bᵀ again, on the lower triangle; each input read once and
    each gradient written once."""
    pairs = q * (q + 1) // 2
    ops = 2.0 * b * nc * pairs * (2 * h * p + 3 * n)
    nbytes = 4.0 * b * nc * (4 * q * n + 3 * h * q * p + 2 * h * q)
    return ops, nbytes


def phase_ssd_bwd():
    """The SSD backward (``csrc/ssd_scan_bwd.cu``) through its wrapper against
    ``ssd_intra_chunk_bwd_ref`` on the card at SSD_BWD_CASES: each gradient
    within 1e-4 of its largest magnitude, run-to-run bitwise, all finite,
    and bitwise the same when dY comes as the layer's permuted view; timed
    beside the plain backward, both bounds (bytes against the three TF32
    products, ``bound_ms``; against f32 FMAs on the CUDA cores,
    ``f32_bound_ms``) and one ``torch.autograd.grad`` of the plain forward,
    each kernel's ms a call from a profiled run; no one PyTorch call
    computes it, so no library time."""
    import re

    import torch

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref

    rows = []
    for label, b, nc, q, n, h, p in SSD_BWD_CASES:
        args = ssd_bwd_inputs(b, nc, q, n, h, p, seed=7)
        cc, bc, xdt, acum, dy = args
        got = ssd_ops.ssd_intra_chunk_bwd(*args)
        again = ssd_ops.ssd_intra_chunk_bwd(*args)
        # dY as the layer hands it: a permuted view of a [B, NC, Q, H, P] gradient
        view = dy.permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
        strided = ssd_ops.ssd_intra_chunk_bwd(cc, bc, xdt, acum, view)
        want = ssd_intra_chunk_bwd_ref(*args)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, g) for a, g in zip(got, again))
        strided_bitwise = all(torch.equal(a, g) for a, g in zip(got, strided))
        errs, rels = {}, {}
        for name, g, w in zip(("dcc", "dbc", "dxdt", "dacum"), got, want):
            errs[name] = float((g - w).abs().max())
            rels[name] = errs[name] / max(float(w.abs().max()), 1e-30)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        del got, again, strided, want
        ms = cuda_ms(lambda: ssd_ops.ssd_intra_chunk_bwd(*args), reps=5)
        # the layer's dY read at its strides, against copying it contiguous first
        strided_ms = cuda_ms(lambda: ssd_ops.ssd_intra_chunk_bwd(cc, bc, xdt, acum, view), reps=5)
        copied_ms = cuda_ms(
            lambda: ssd_ops.ssd_intra_chunk_bwd(cc, bc, xdt, acum, view.contiguous()), reps=5)
        del view
        plain_ms = cuda_ms(lambda: ssd_intra_chunk_bwd_ref(*args), reps=2)

        def autograd_plain():
            leaves = [t.detach().requires_grad_() for t in (cc, bc, xdt, acum)]
            return torch.autograd.grad(ssd_intra_chunk_ref(*leaves), leaves, dy)

        autograd_ms = cuda_ms(autograd_plain, reps=2)
        # each kernel's ms a call, from a profiled run of PROFILED_CALLS calls
        _, _, prof_rows = _device_profile(
            lambda: [ssd_ops.ssd_intra_chunk_bwd(*args) for _ in range(PROFILED_CALLS)])
        kernel_ms = {re.search(r"ssd_bwd_\w+", name).group(0): k_ms / count
                     for name, k_ms, count in prof_rows if "ssd_bwd_" in name}
        ops, nbytes = ssd_bwd_work(b, nc, q, n, h, p)
        b_ms, b_by = bound(nbytes, 3 * ops, TF32_FLOPS)
        f32_ms, f32_by = bound(nbytes, ops, FP32_FLOPS)
        row = dict(case=label, b=b, nc=nc, q=q, n=n, h=h, p=p, max_abs_err=max(errs.values()),
                   errors=errs, rel_errors=rels, run_to_run_bitwise=bitwise,
                   strided_dy_bitwise=strided_bitwise, finite=finite, ms=ms,
                   strided_dy_ms=strided_ms, copied_dy_ms=copied_ms,
                   kernel_ms=kernel_ms or "not measured", plain_ms=plain_ms,
                   autograd_plain_ms=autograd_ms, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by, f32_bound_ms=f32_ms, f32_bound_by=f32_by, bytes=nbytes,
                   ops=ops, tflops=ops / ms / 1e9)
        log(f"[ssd bwd] {label} B={b} NC={nc} Q={q} N={n} H={h} P={p}: max |err| / max |g| "
            f"{ {k: f'{v:.2e}' for k, v in rels.items()} } (<= {SSD_ATOL}); bitwise {bitwise}; "
            f"permuted dY bitwise {strided_bitwise} ({strided_ms:.4f} ms read at its strides, "
            f"{copied_ms:.4f} copied first); finite {finite}; ms={ms:.4f} (a call of "
            f"{PROFILED_CALLS} profiled: {', '.join(f'{k} {v:.4f}' for k, v in kernel_ms.items()) or 'not measured'}) "
            f"plain_ms={plain_ms:.3f} (autograd through the plain forward {autograd_ms:.3f}) "
            f"bound_ms={b_ms:.4f} ({b_by}: 3 x {ops / 1e9:.2f} GFLOP at "
            f"{TF32_FLOPS / 1e12:.1f} TFLOP/s, {nbytes / 1e6:.1f} MB) f32_bound_ms={f32_ms:.4f} "
            f"({f32_by}, {FP32_FLOPS / 1e12:.0f} TFLOP/s); {row['tflops']:.1f} TFLOP/s, "
            f"{ms / b_ms:.2f}x the bound; library: none, no one PyTorch call computes it")
        if not (bitwise and strided_bitwise and finite and max(rels.values()) <= SSD_ATOL):
            raise RuntimeError(f"ssd bwd {label}: {row}")
        rows.append(row)
        del cc, bc, xdt, dy, acum, args
        torch.cuda.empty_cache()
    return rows


def phase_serve_cli():
    """``python -m repro_torch.launch.serve`` as a user calls it, through
    ``main(argv)`` on the card: REDUCED ``ample-gcn`` (3 requests on one
    graph: one cold plan, then cache hits; a batch of 3) and FULL
    ``mamba2-370m`` (4 prompts of 16, 8 new tokens: one SSD launch a layer)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve as serve_launcher

    build.reset_launch_counts()
    t0 = time.perf_counter()
    gnn = serve_launcher.main(["--arch", "ample-gcn", "--requests", "3"])
    gnn_s = time.perf_counter() - t0
    gnn_counts = build.launch_counts()
    info = gnn["engine"].cache_info()
    hits = [r.cache_hit for r in gnn["responses"]]
    same = all(np.array_equal(r.outputs, gnn["responses"][0].outputs)
               for r in gnn["responses"][1:])
    build.reset_launch_counts()
    t0 = time.perf_counter()
    lm = serve_launcher.main(["--arch", "mamba2-370m", "--full", "--tokens", "8"])
    torch.cuda.synchronize()
    lm_s = time.perf_counter() - t0
    lm_counts = build.launch_counts()
    layers = get_config("mamba2-370m").num_layers
    row = dict(gnn_cache_hits=hits, gnn_planner_calls=info["planner_calls"],
               gnn_launches=gnn_counts, gnn_warm_equal_cold=same, gnn_s=gnn_s,
               lm_tokens=list(lm["tokens"].shape), lm_launches=lm_counts, lm_s=lm_s)
    log(f"[serve cli] ample-gcn: cache hits {hits}, planner calls {info['planner_calls']}, warm "
        f"== cold {same}, launches {gnn_counts}, {gnn_s:.1f} s; FULL mamba2-370m: tokens "
        f"{row['lm_tokens']}, launches {lm_counts}, {lm_s:.1f} s")
    if not (hits == [False, True, True] and info["planner_calls"] == 2 and same
            and gnn_counts.get("segment_agg", 0)):
        raise RuntimeError(f"serve cli: the GNN run {row}")
    if not (lm_counts == {ssd_ops.KERNEL: layers} and row["lm_tokens"] == [4, 16 + 8]):
        raise RuntimeError(f"serve cli: the LM run {row}")
    return row


LM_CPU_ARCHS = ("qwen3-8b", "mamba2-370m", "granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
                "jamba-v0.1-52b", "qwen2-vl-7b")


def _close_to(got, want):
    """(max abs difference, within atol 5e-4, rtol 1e-3) of a card tensor
    against a CPU one."""
    diff = (got.cpu() - want).abs()
    return float(diff.max()), bool((diff <= LM_CPU_ATOL + LM_CPU_RTOL * want.abs()).all())


def phase_lm_cpu():
    """The REDUCED LMs (dense, ssm, MoE, interleaved MoE, hybrid, VLM on token
    prompts) served on the CPU (plain versions) against the card: each kernel
    launched as ``block_roles`` says, the same tokens, prefill logits within
    atol 5e-4, rtol 1e-3; then REDUCED ``seamless-m4t-medium`` through
    ``model_prefill`` (flash once per decoder layer causal, once per encoder
    and cross layer unmasked) and two decode steps, logits and every cache
    leaf at the same tolerance."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.api import model_decode_step, model_init, model_prefill, params_to
    from repro_torch.serve.engine import ServeEngine

    rows = []
    for arch in LM_CPU_ARCHS:
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
        err, close = _close_to(model_prefill(card.params, cfg, {"tokens": toks.cuda()}, 64)[0],
                               want)
        log(f"[lm cpu] {arch} REDUCED: card launches {counts}, tokens equal {same}, prefill "
            f"logits max abs diff {err:.3g} (atol {LM_CPU_ATOL}, rtol {LM_CPU_RTOL}: {close})")
        if counts != _lm_launches(cfg) or not same or not close:
            raise RuntimeError(f"lm cpu {arch}: launches {counts}, tokens equal {same}, err {err}")
        rows.append(dict(arch=arch, launches=counts, tokens_equal=same, max_abs_diff=err))

    cfg = get_config("seamless-m4t-medium", reduced=True)
    card = model_init(cfg, _cuda_gen(0), device="cuda")
    cpu = params_to(card, "cpu")
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    want, wcache, n = model_prefill(cpu, cfg, {"src_embeds": src, "tgt_tokens": tgt}, 16)
    build.reset_launch_counts()
    got, gcache, gn = model_prefill(card, cfg, {"src_embeds": src.cuda(),
                                                "tgt_tokens": tgt.cuda()}, 16)
    counts = build.launch_counts()
    unmasked = cfg.encoder_layers + cfg.num_layers
    expect = {fa_ops.KERNEL: cfg.num_layers + unmasked, fa_ops.NONCAUSAL_KERNEL: unmasked}
    errs = [_close_to(got, want)] + [_close_to(gcache[k], wcache[k]) for k in sorted(wcache)]
    for i in range(2):
        tok = tgt[:, i:i + 1]
        w, wcache = model_decode_step(cpu, cfg, {"tokens": tok}, wcache, n + i)
        g, gcache = model_decode_step(card, cfg, {"tokens": tok.cuda()}, gcache, gn + i)
        errs.append(_close_to(g, w))
    err = max(e for e, _ in errs)
    close = all(c for _, c in errs)
    log(f"[lm cpu] seamless-m4t-medium REDUCED: prefill launches {counts}, prefill logits, "
        f"cache leaves and two decode steps max abs diff {err:.3g} (atol {LM_CPU_ATOL}, rtol "
        f"{LM_CPU_RTOL}: {close})")
    if counts != expect or gn != n or not close:
        raise RuntimeError(f"lm cpu seamless: launches {counts} (expected {expect}), err {err}")
    rows.append(dict(arch="seamless-m4t-medium", launches=counts, max_abs_diff=err))
    return rows


def kernel_row(name, source, replaces, launches, row, shape):
    """One entry of the ``kernels`` line."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"], shape=shape)


def flash_bwd_kernel_rows(train_row, bwd_rows):
    """The ``kernels`` line's entries of flash's backward: the tensor-core
    pair and the CUDA-core pair, from ``phase_lm_train``'s and
    ``phase_flash_bwd``'s rows."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    src = "src/repro_torch/csrc/flash_attention_bwd.cu"
    site = "src/repro/kernels/flash_attention/flash_attention.py:95"
    return [
        # The backward's tensor-core pair: launches in the FULL Qwen2-1.5B
        # training run (TRAIN_STEPS steps, one of each a layer a step), times
        # at its shape (B 4 x 2,048, GQA 12/2, hd 128, bf16, causal). The
        # plain version and SDPA's backward compute all three gradients at
        # once: their times are the whole backward's, in both rows.
        dict(kernel_row("flash_attention_bwd_tc_dq", src, site,
                        train_row["launches"].get(fa_ops.BWD_TC_KERNEL, 0),
                        dict(bwd_rows[0], max_abs_err=bwd_rows[0]["err_dq"],
                             ms=bwd_rows[0]["dq_ms"], bound_ms=bwd_rows[0]["dq_bound_ms"],
                             bound_by=bwd_rows[0]["dq_bound_by"]),
                        "B={b} S={s} H={h} KV={kv} hd={hd} {dtype} causal".format(**bwd_rows[0])),
             note="the gradient of the Pallas kernel at replaces, which has no VJP",
             launches_per_step=train_row["steps"][-1]["launches"].get(fa_ops.BWD_TC_KERNEL, 0),
             backward_ms=bwd_rows[0]["ms"], pair_ms=bwd_rows[0]["pair_ms"],
             backward_bound_ms=bwd_rows[0]["bound_ms"],
             design_gflop=bwd_rows[0]["tc_design_gflop"],
             cases={r["case"]: {k: r[k] for k in (
                 "causal", "err_dq", "dq_ms", "dq_bound_ms", "pair_ms", "ms", "plain_ms",
                 "bound_ms", "library_ms")} for r in bwd_rows[1:]
                 if r["variant"] == "tensor_cores"}),
        dict(kernel_row("flash_attention_bwd_tc_dkdv", src, site,
                        train_row["launches"].get(fa_ops.BWD_TC_KERNEL, 0),
                        dict(bwd_rows[0], max_abs_err=max(bwd_rows[0]["err_dk"],
                                                          bwd_rows[0]["err_dv"]),
                             ms=bwd_rows[0]["dkdv_ms"], bound_ms=bwd_rows[0]["dkdv_bound_ms"],
                             bound_by=bwd_rows[0]["dkdv_bound_by"]),
                        "B={b} S={s} H={h} KV={kv} hd={hd} {dtype} causal".format(**bwd_rows[0])),
             note="the gradient of the Pallas kernel at replaces, which has no VJP",
             launches_per_step=train_row["steps"][-1]["launches"].get(fa_ops.BWD_TC_KERNEL, 0),
             head_splits=bwd_rows[0]["splits"],
             cases={r["case"]: {k: r[k] for k in (
                 "causal", "err_dk", "err_dv", "dkdv_ms", "dkdv_bound_ms", "splits", "pair_ms",
                 "ms", "plain_ms", "bound_ms", "library_ms")} for r in bwd_rows[1:]
                 if r["variant"] == "tensor_cores"}),
        # The CUDA-core pair: launches in the launcher's default run (REDUCED
        # Qwen2-1.5B, f32, hd 20: the f32 and other-head-dim calls), times at
        # the f32 hd 20 case (B 4 x 2,048, H 3, KV 1, causal); its times at
        # Qwen2-1.5B's shape beside, timed in turns with the tensor-core pair.
        dict(kernel_row("flash_attention_bwd_dq", src, site,
                        train_row["launcher"]["launches"].get(fa_ops.BWD_DQ_KERNEL, 0),
                        dict(bwd_rows[2], max_abs_err=bwd_rows[2]["err_dq"],
                             ms=bwd_rows[2]["cc_dq_ms"], bound_ms=bwd_rows[2]["dq_bound_ms"],
                             bound_by=bwd_rows[2]["dq_bound_by"]),
                        "B={b} S={s} H={h} KV={kv} hd={hd} {dtype} causal".format(**bwd_rows[2])),
             note="the gradient of the Pallas kernel at replaces, which has no VJP",
             qwen2_shape_ms=bwd_rows[0]["cc_dq_ms"],
             qwen2_shape_pair_ms=bwd_rows[0]["cc_pair_ms"]),
        dict(kernel_row("flash_attention_bwd_dkdv", src, site,
                        train_row["launcher"]["launches"].get(fa_ops.BWD_DKDV_KERNEL, 0),
                        dict(bwd_rows[2], max_abs_err=max(bwd_rows[2]["err_dk"],
                                                          bwd_rows[2]["err_dv"]),
                             ms=bwd_rows[2]["cc_dkdv_ms"], bound_ms=bwd_rows[2]["dkdv_bound_ms"],
                             bound_by=bwd_rows[2]["dkdv_bound_by"]),
                        "B={b} S={s} H={h} KV={kv} hd={hd} {dtype} causal".format(**bwd_rows[2])),
             note="the gradient of the Pallas kernel at replaces, which has no VJP",
             qwen2_shape_ms=bwd_rows[0]["cc_dkdv_ms"]),
    ]


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

    seconds = {}

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        yield
        seconds[name] = time.perf_counter() - t0
        log(f"[time] {name}: {seconds[name]:.1f} s")

    with phase("build"):
        report = phase_build()
    cfg = get_config("ample-gcn")
    with phase("data"):
        g = make_dataset("yelp", max_feature_dim=cfg.d_model, seed=0)
        batch_graphs = [make_dataset("cora", max_feature_dim=cfg.d_model, seed=s)
                        for s in (1, 2, 3)]
    log(f"[data] yelp {g.num_nodes} nodes {g.num_edges} edges")
    paths = {}  # GNN path -> (outs, batch, counts, peak)
    with phase("path"), _count_calls("repro_torch.core.quantization",
                                     "dequantize") as dequantized:
        srv, outs, batch, counts, peak = phase_path(
            cfg, g, batch_graphs, {"segment_agg": 4, "quant_matmul": 2})
        paths["gcn"] = (outs, batch, counts, peak)
    with phase("profile"), _count_calls("repro_torch.core.quantization",
                                        "dequantize") as dequantized_profile:
        profile_row = phase_profile(srv, g)
    log(f"[path] dequantize calls during the requests: {dequantized[0] + dequantized_profile[0]}")
    if dequantized[0] or dequantized_profile[0]:
        raise RuntimeError("the GCN requests dequantized the int8 group before the AGE")
    check_gcn_profile(profile_row)
    with phase("trace"):
        trace_row = phase_trace(srv, g, outs[0].outputs)

    entry = _yelp_engine(srv, g)
    mode = gnn_api.agg_mode(cfg)
    with phase("kernels"):
        x300 = torch.from_numpy(srv._pad_features(g.features, entry.graph.num_nodes)).cuda()
        age_rows = phase_age(entry, mode, x300)
        m = int(entry.node_groups["int8"].size)
        del x300
        gemm_rows = phase_gemm(m)
    cora = make_dataset("cora", max_feature_dim=cfg.d_model, seed=4)
    with phase("cpu"):
        cpu_row = phase_cpu(srv, cfg, cora)
    # Out-of-core: the same engine (plans warm) with the features on the host;
    # one request per prefetch depth, each bitwise the in-memory output.
    ooc_rows = {}
    with phase("h2d"):
        h2d_row = phase_h2d()
    with phase("outofcore gcn"):
        ooc_rows["gcn"] = phase_outofcore(srv, g, outs[0].outputs, "gcn", (2, 2, 0))
    with phase("fronts"):
        fronts_row = phase_fronts(cfg)
    # Sharded serving and plan persistence, on the GCN path's params. The
    # plan files go under build/ (ignored by git) and are removed after.
    srv.feature_budget_bytes = 0
    plan_dir = os.path.join(ROOT, "build", "plan_cache_smoke")
    with phase("sharded gcn"):
        ssrv, sharded_y, sharded_row = phase_sharded_gcn(
            cfg, srv.params, g, outs[0].outputs, [r.run_ms for r in outs[1:]])
    with phase("plan store"):
        store_row = phase_plan_store(cfg, srv.params, g, [
            ("unsharded", srv, outs[0].outputs, {}, outs[0].plan_ms),
            ("sharded", ssrv, sharded_y, dict(num_shards=SHARDS, partitioner="edges"),
             sharded_row["requests"][0]["plan_ms"])], plan_dir)
    with phase("sharded overlap"):
        overlap_row = phase_sharded_overlap(cfg, srv.params, g, sharded_y,
                                            os.path.join(plan_dir, "sharded"))
    shutil.rmtree(plan_dir, ignore_errors=True)
    del ssrv
    with phase("sharded mincut"):
        mincut_row = phase_sharded_mincut(cfg, srv.params)
    del srv, entry
    gc.collect()
    torch.cuda.empty_cache()

    # Degree-Quant QAT through the AGE's backward on the transposed plan.
    with phase("qat gcn"):
        qat_row = phase_qat(g)
    gc.collect()
    torch.cuda.empty_cache()

    # GIN and SAGE: the same two kernels with sum and mean coefficients on
    # the raw graph; the Yelp GIN engine also gives the occupancy report.
    arch_rows = {}
    for arch, gemms in (("gin", 4), ("sage", 6)):
        acfg = get_config(f"ample-{arch}")
        with phase(f"{arch} path"), _count_calls("repro_torch.core.quantization",
                                                 "dequantize") as deq:
            asrv, aouts, abatch, acounts, apeak = phase_path(
                acfg, g, batch_graphs, {"segment_agg": 4, "quant_matmul": gemms},
                tag=f"{arch} path")
            arch_rows[f"{arch} profile"] = phase_profile(asrv, g, tag=f"{arch} profile")
        paths[arch] = (aouts, abatch, acounts, apeak)
        log(f"[{arch} path] dequantize calls during the requests: {deq[0]}")
        if deq[0]:
            raise RuntimeError(f"the {arch} requests dequantized the int8 group before the AGE")
        with phase(f"{arch} cpu"):
            arch_rows[arch] = phase_cpu(asrv, acfg, cora, tag=f"{arch} cpu")
        with phase(f"outofcore {arch}"):
            ooc_rows[arch] = phase_outofcore(asrv, g, aouts[0].outputs, arch, (2, 0))
        if arch == "gin":
            with phase("baseline"):
                baseline_row = phase_baseline(_yelp_engine(asrv, g))
        del asrv
        gc.collect()
        torch.cuda.empty_cache()

    gat_cfg = get_config("ample-gat")
    with phase("gat path"), _count_calls("repro_torch.core.aggregation",
                                         "tile_edge_coeff") as scatters:
        gsrv, gouts, gbatch, gcounts, gpeak = phase_path(
            gat_cfg, g, batch_graphs, {"attention": 4, "quant_matmul": 2}, tag="gat path")
        paths["gat"] = (gouts, gbatch, gcounts, gpeak)
        gprofile_row = phase_profile(gsrv, g, tag="gat profile")
    log(f"[gat path] per-edge operands scattered into tile layout: {scatters[0]} times")
    if scatters[0]:
        raise RuntimeError("the GAT requests gathered per-edge operands into tile layout")
    if gpeak >= 20 * 2**30:
        raise RuntimeError(f"GAT path peak device memory {gpeak / 2**30:.2f} GiB >= 20 GiB")
    gentry = _yelp_engine(gsrv, g)
    with phase("gat decomposed"):
        dec_row = phase_gat_decomposed(gentry)
    with phase("gat kernels"):
        attn_rows, mh_rows = phase_gat_kernels(gentry)
    with phase("gat cpu"):
        gcpu_row = phase_cpu(gsrv, gat_cfg, cora, tag="gat cpu")
    with phase("outofcore gat"):
        ooc_rows["gat"] = phase_outofcore(gsrv, g, gouts[0].outputs, "gat", (2, 0))
    gsrv.feature_budget_bytes = 0
    with phase("sharded gat"):
        sgat_row = phase_sharded_gat(gat_cfg, gsrv.params, g, gouts[0].outputs)
    del gsrv, gentry
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    with phase("lm path"):
        lm_row = phase_lm_path("qwen3-8b", "lm path")
    with phase("ssm path"):
        ssm_row = phase_lm_path("mamba2-370m", "ssm path")
    with phase("moe path"):
        moe_row = phase_lm_path("granite-moe-3b-a800m", "moe path")
    with phase("moe interleaved path"):
        moe2_row = phase_lm_path(
            "llama4-maverick-400b-a17b", "moe interleaved path", num_layers=2,
            cut_reason="one (attn, dense) + (attn, moe) unit; the 48 layers hold ~400 B "
                       "parameters, 800 GB in bf16, ten times the card",
            tf_shape=(1, 512),
            tf_reason="at no-drop capacity the expert buffers are [128, B·P, ·]: 10.7 GB of "
                      "input and 17 GB per hidden at B 4 x 2048, beside 37 GB of weights")
    with phase("hybrid path"):
        hybrid_row = phase_lm_path(
            "jamba-v0.1-52b", "hybrid path", num_layers=8,
            cut_reason="one unit of 8 roles (attention at offset 4, MoE every 2nd); the 32 "
                       "layers hold ~52 B parameters, 104 GB in bf16")
    with phase("vlm path"):
        vlm_row = phase_vlm_path()
    with phase("encdec path"):
        encdec_row = phase_encdec_path()
    with phase("lm kernels"):
        flash_rows, ssd_rows = phase_lm_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm train"):
        train_row = phase_lm_train()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("flash bwd"):
        bwd_rows = phase_flash_bwd()
    # The forward's lse output is a null pointer on the serving path: its
    # time at Qwen3-8B's shape beside the two times recorded before the lse
    # output existed (PERF.md).
    log(f"[flash bwd] the forward with lse=null at Qwen3-8B's shape: "
        f"{flash_rows[0]['ms']:.3f} ms (before the lse output: 0.596, 0.616 ms); {card}")
    gc.collect()
    torch.cuda.empty_cache()
    with phase("ssm train"):
        ssm_train_row = phase_lm_train(SSM_TRAIN_ARCH, SSM_TRAIN_PARAMS, SSM_TRAIN_BATCH,
                                       tag="ssm train")
    gc.collect()
    torch.cuda.empty_cache()
    with phase("hybrid train"):
        hybrid_train_row = phase_hybrid_train()
    with phase("ssd bwd"):
        ssd_bwd_rows = phase_ssd_bwd()
    with phase("serve cli"):
        serve_cli_row = phase_serve_cli()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm cpu"):
        lm_cpu_rows = phase_lm_cpu()

    lm_rows = {"qwen3-8b": lm_row, "mamba2-370m": ssm_row, "granite-moe-3b-a800m": moe_row,
               "llama4-maverick-400b-a17b unit": moe2_row, "jamba-v0.1-52b unit": hybrid_row,
               "qwen2-vl-7b": vlm_row, "seamless-m4t-medium": encdec_row}

    def lm_paths(kernel):
        """A kernel's launches in one generate of each LM path that runs it."""
        return {arch: r["launches"][kernel] for arch, r in lm_rows.items()
                if kernel in r["launches"]}

    def by_path(kernel):
        """A kernel's launches over each GNN path's run (3 Yelp infers + 1 batch)."""
        return {p: paths[p][2].get(kernel, 0) for p in ("gcn", "gin", "sage", "gat")}

    def streamed(kernel):
        """A kernel's launches in each arch's last depth-2 streamed Yelp request."""
        return {p: [r for r in ooc_rows[p]["requests"] if r["depth"] == 2][-1]["launches"]
                .get(kernel, 0) for p in ("gcn", "gin", "sage", "gat")}

    # Every kernel of the GNN paths ran on each path that uses it.
    for kernel, users in (("segment_agg", ("gcn", "gin", "sage")),
                          ("quant_matmul", ("gcn", "gin", "sage", "gat")),
                          ("attention", ("gat",))):
        idle = [p for p in users if not by_path(kernel)[p]]
        if idle:
            raise RuntimeError(f"{kernel} was not launched on the {idle} path(s)")

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
        dict(kernel_row("segment_agg", "src/repro_torch/csrc/segment_agg.cu",
                        "src/repro/kernels/segment_agg/segment_agg.py:135",
                        counts.get("segment_agg", 0), age,
                        f"int8 group T={age['tiles']} E={age['lanes']} N={age['n']} "
                        f"D={age['d']}, {age['rows']} rows"),
             launches_by_path=by_path("segment_agg"),
             launches_streamed_request=streamed("segment_agg"),
             launches_sharded_request=sharded_row["launches_request"].get("segment_agg", 0),
             # a Yelp QAT step: 2 forward, 1 backward on the transposed plan
             launches_qat_step=qat_row["steps"][0]["age_launches"],
             launches_qat_deploy=qat_row["deploy_launches"].get("segment_agg", 0),
             qat_backward={k: qat_row["backward_kernel"][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "d",
                 "tiles", "n")}),
        dict(kernel_row("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
                        "src/repro/kernels/quant_matmul/repack.py:108",
                        counts.get("quant_matmul", 0), gemm,
                        f"M={gemm['m']} K={gemm['k']} N={gemm['n']}"),
             launches_by_path=by_path("quant_matmul"),
             launches_streamed_request=streamed("quant_matmul"),
             launches_sharded_request=sharded_row["launches_request"].get("quant_matmul", 0)),
        kernel_row("attention", "src/repro_torch/csrc/attn_agg.cu",
                   "src/repro/kernels/segment_agg/attn_kernel.py:194",
                   gcounts.get("attention", 0), attn, gat_shape.format(**attn)),
        dict(kernel_row("segment_agg_mh", "src/repro_torch/csrc/attn_agg.cu",
                        "src/repro/kernels/segment_agg/attn_kernel.py:239",
                        dec_row["launches"].get("segment_agg_mh", 0), mh, gat_shape.format(**mh)),
             launches_sharded_request=sgat_row["launches_request"].get("segment_agg_mh", 0)),
        # Launches: one Qwen3-8B / Mamba2-370M generate (B 4 x 2048 + 32 tokens),
        # and per LM path beside it. Every launch of the bf16 paths went through
        # the tensor-core variant. The unmasked branch: its launches per LM
        # path (the enc-dec run: 24 a prefill, 12 a decode step) and its
        # times at the Seamless encoder's and cross-attention's shapes.
        dict(kernel_row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:95",
                        lm_row["launches"].get(fa_ops.KERNEL, 0), flash_rows[0],
                        "B={b} S={s} H={h} KV={kv} hd={hd} {dtype}".format(**flash_rows[0])),
             variant=flash_rows[0]["variant"],
             tensor_core_launches=lm_row["launches"].get(fa_ops.TC_KERNEL, 0),
             launches_by_lm_path=lm_paths(fa_ops.KERNEL),
             launches_lm_train_run=train_row["launches"].get(fa_ops.KERNEL, 0),
             noncausal_launches_by_lm_path=lm_paths(fa_ops.NONCAUSAL_KERNEL),
             noncausal_launches_per_prefill=encdec_row["prefill_launches"].get(
                 fa_ops.NONCAUSAL_KERNEL, 0),
             noncausal_launches_per_decode_step=encdec_row["decode_step_launches"][
                 fa_ops.NONCAUSAL_KERNEL],
             cases={r["case"]: {k: r[k] for k in (
                 "causal", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")} for r in flash_rows[1:]}),
        *flash_bwd_kernel_rows(train_row, bwd_rows),
        dict(kernel_row("ssd_intra_chunk", "src/repro_torch/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan/ssd_scan.py:52",
                        ssm_row["launches"].get(ssd_ops.KERNEL, 0), ssd_rows[0],
                        "B={b} NC={nc} Q={q} N={n} H={h} P={p} f32".format(**ssd_rows[0])),
             f32_bound_ms=ssd_rows[0]["f32_bound_ms"],
             launches_by_lm_path=lm_paths(ssd_ops.KERNEL),
             launches_ssm_train_run=ssm_train_row["launches"].get(ssd_ops.KERNEL, 0)),
        # The SSD's backward: launches in the FULL Mamba2-370M training run
        # (TRAIN_STEPS steps, one a layer a step), times at its shape.
        dict(kernel_row("ssd_intra_chunk_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
                        "src/repro/kernels/ssd_scan/ssd_scan.py:52",
                        ssm_train_row["launches"].get(ssd_ops.KERNEL_BWD, 0), ssd_bwd_rows[0],
                        "B={b} NC={nc} Q={q} N={n} H={h} P={p} f32".format(**ssd_bwd_rows[0])),
             note="the gradient of the Pallas kernel at replaces, which has no VJP",
             f32_bound_ms=ssd_bwd_rows[0]["f32_bound_ms"], kernel_ms=ssd_bwd_rows[0]["kernel_ms"],
             library="none: no one PyTorch call computes it",
             launches_per_step=ssm_train_row["steps"][-1]["launches"].get(ssd_ops.KERNEL_BWD, 0),
             launches_hybrid_train_run=sum(st["launches"].get(ssd_ops.KERNEL_BWD, 0)
                                           for st in hybrid_train_row["steps"]),
             autograd_plain_ms=ssd_bwd_rows[0]["autograd_plain_ms"],
             cases={r["case"]: {k: r[k] for k in (
                 "max_abs_err", "ms", "kernel_ms", "plain_ms", "autograd_plain_ms", "bound_ms",
                 "bound_by", "f32_bound_ms")} for r in ssd_bwd_rows[1:]}),
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
        path=path_detail(*paths["gcn"]), profile=profile_row, trace=trace_row,
        segment_agg=age_rows, quant_matmul=gemm_rows, cpu=cpu_row,
        gin_path=path_detail(*paths["gin"]), gin_profile=arch_rows["gin profile"],
        gin_cpu=arch_rows["gin"],
        sage_path=path_detail(*paths["sage"]), sage_profile=arch_rows["sage profile"],
        sage_cpu=arch_rows["sage"],
        baseline=baseline_row,
        gat_path=path_detail(*paths["gat"]), gat_profile=gprofile_row,
        gat_decomposed=dec_row, attention=attn_rows, segment_agg_mh=mh_rows, gat_cpu=gcpu_row,
        lm_path=lm_row, ssm_path=ssm_row, moe_path=moe_row, moe_interleaved_path=moe2_row,
        hybrid_path=hybrid_row, vlm_path=vlm_row, encdec_path=encdec_row,
        flash_attention=flash_rows, ssd_intra_chunk=ssd_rows, lm_train=train_row,
        flash_attention_bwd=bwd_rows, ssm_train=ssm_train_row, hybrid_train=hybrid_train_row,
        ssd_intra_chunk_bwd=ssd_bwd_rows, serve_cli=serve_cli_row,
        lm_cpu=lm_cpu_rows, outofcore=ooc_rows, h2d_gbps=h2d_row, fronts=fronts_row,
        sharded_gcn=sharded_row, plan_store=store_row, sharded_overlap=overlap_row,
        sharded_mincut=mincut_row, sharded_gat=sgat_row, qat_gcn=qat_row,
        phase_seconds=seconds,
        seconds=time.perf_counter() - t_start,
    )
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    idle = [r["name"] for r in kernels if not r["launches"]]
    if idle:
        raise RuntimeError(f"kernels launched no time on their paths: {idle}")
    log(f"[done] {details['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
