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
             walk of the AGE and the GAT kernels, the GAT backward, the SSD
             kernels and both pairs of flash backward kernels must not
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
   qat gat — Degree-Quant QAT of FULL ``ample-gat`` on Yelp with
             self-loops and planted labels (100 classes) through ``gat.apply``
             on a float engine, each layer's unprotected input rows
             fake-quantized: QAT_GAT_STEPS AdamW steps with forward, backward
             and optimiser ms (CUDA events) and per step 2 attention, 2
             backward (``csrc/attn_agg_bwd.cu``) and 6 multi-head walk launches
             (dz and the two score sums a layer), asserted; the loss finite
             and falling; peak memory; a profiled step; two 2-step runs
             bitwise; the float and deployed int8 test accuracies; at FULL
             widths on cora, step 0's loss and gradients on the card within
             atol 5e-4, rtol 1e-3 of the CPU's;
   gat bwd — the backward kernel at both layers' shapes on that engine (H 4,
             dh 64 and 100, f32 rows and int8 codes) against its plain
             version on the card: alpha and ds within 1e-5 of each value and
             of the largest, run to run bitwise; each timed beside the plain
             version, the bound, the row floor and
             ``torch.sparse.sampled_addmm`` (once a head); at layer 0, given
             its alpha and ds, the dz walk on the transposed runtime plan and
             the score sums bitwise the CPU's plain versions, and the whole
             backward timed beside ``torch.sparse.mm`` on Aᵀ;
   qat sharded gat — after gat bwd, on its engine: as qat sharded gcn
             (below) for FULL ``ample-gat`` (``gat.apply`` with the QAT input
             fake-quantization; the decomposed layer per shard: no fused
             attention, the GAT backward and the multi-head walk a step);
   qat streamed — FULL ``ample-gat`` on a mixed engine on Yelp, layer 0's FTE
             streamed from page-locked host features at 1/QAT_STREAMED_FRAC
             of the matrix: step-0 loss and gradients against the in-memory
             features' (same engine), QAT_STREAMED_STEPS AdamW steps by phase
             with bytes streamed and launches (the int8 GEMM once a chunk);
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
             for 3 steps, its backward on the CUDA-core pair; after the
             profiled step, two steps with each gradient compressor
             (``--compress topk`` at 1% and ``int8``) from the phase's own
             state: step and compress ms, the error-feedback state's bytes,
             peak memory, the flash launches, and the embedding's and the
             unit's smaller leaves as compressed on the card against the
             CPU's ``compress_decompress`` of the card's own gradients and
             error state (top-k bitwise; int8 bitwise on the card's draws);
    remat — FULL-width ``qwen3-8b`` (its config sets ``remat="block"``) cut
             to REMAT_LAYERS layers, B REMAT_BATCH x 2,048: a training
             step's forward and backward with ``"none"`` and ``"block"``,
             warm step ms, each step's peak above what it found, flash
             launches (block: the forward twice), gradients bitwise;
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
    examples — ``examples/quickstart_torch.py`` (all of cora),
             ``serve_lm_torch.py`` and ``ample_simulation_torch.py``
             (20,000-node caps) once each on the card;
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
             the mixed tolerance of unsharded, peak under 20 GiB; its plan
             cache saved for the mesh phase;
    mesh reference gcn, mesh reference gat — the host loop's QAT step 0
             for the mesh phase: GCN on the sharded gcn phase's engine (all
             of Yelp); GAT on the subgraph induced by Yelp's first
             ``MESH_GAT_TRAIN_NODES`` nodes, served once by a 4-shard
             engine whose plans are saved for the ranks;
    mesh — the mesh backend: 4 ranks (``torch.multiprocessing``, a gloo
             group through a ``file://`` store, the 1-D ``("shard",)``
             ``DeviceMesh``) share the one card, each serving three Yelp
             requests through ``GNNServeEngine(..., num_shards=4,
             mesh=mesh)`` of FULL ``ample-gcn`` (edges, unsplit, its plans
             loaded from the sharded gcn phase's files) and FULL
             ``ample-gat`` (``halo_overlap``, the sharded gat phase's
             plans): every rank's output bitwise the host loop's output of
             the same phase run, warm == cold, the same bits on every rank,
             each request a plan-cache hit with plan_ms 0.0, and per rank
             and request the AGE once per group of its own shard and layer
             and the GEMM twice (GCN), the multi-head walk once per group of
             its own shard, layer and pass (GAT); each rank's run_ms, peak
             memory and all-gathers (CUDA events), halo_bytes. Then one
             Degree-Quant QAT step (loss, backward, AdamW; the example's GCN
             recipe on the same engine, ``_gat_qat_loss`` for GAT on the
             subgraph of ``MESH_GAT_TRAIN_NODES``; the planted labels and
             step 0's protection mask): the loss and every gradient bitwise
             the host loop's step 0 (computed by the parent in ``mesh
             reference gcn`` and ``mesh reference gat`` on the same plans)
             and the same on all ranks; the AGE (the halo-transpose
             sums included), the walk and the GAT backward launches a rank
             counted from its own shard's plans; forward, backward and
             optimiser ms, the backward's all-gathers (ms, bytes), the
             step's peak. Last, three GCN requests through
             ``AsyncGNNEngine`` and three through a two-tenant
             ``TenantRouter`` (window 1: each window a plan-cache hit),
             bitwise the host loop's output, rank 0's window log the same
             on every rank. A rank that fails or passes the deadline fails
             the phase;
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
             the card against the CPU (atol 5e-4, rtol 1e-3), and one step
             through ``gcn.apply`` on a mixed-precision engine (the int8 FTE
             under grad: 5 AGE and 2 GEMM launches) within the mixed
             tolerance of the CPU's; the example at
             its defaults (800 nodes, 300 steps) on the card and the CPU,
             each accuracy within 0.03;
    qat sharded gcn — the same training through ``ShardedAmpleEngine``
             (QAT_SHARDS host-loop shards, float): step-0 loss and
             gradients against the qat gcn engine's (atol 5e-4, rtol 1e-3);
             the shards' transposed plans and the halo-transpose plan built
             and timed; QAT_SHARDED_STEPS steps on each engine by phase with
             launches (the AGE 2 x 3 + 1 a step); two runs bitwise; the
             halo-transpose AGE against its plain version (AGE_ATOL,
             bitwise twice), ``index_add_`` and the bound;
18. summary — a JSON line of kernels (the AGE and the int8 matmul with their
             launches per GNN path, per streamed request and per sharded
             request, the AGE's per QAT step and its backward's times, both
             per mixed QAT step; the multi-head AGE per sharded GAT request
             and per GAT QAT step; the GAT backward per QAT step; flash
             attention and the SSD per LM path, each backward per training
             step; the AGE, the multi-head walk and the GAT backward per
             sharded QAT step, the GEMM and the GAT backward per streamed
             one, flash per remat step), the card's name and power limit,
             and the result line.

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
GAT_LSE_TOL = 1e-5  # the attention's lse, relative to max(1, |lse|): exp-sums in another order
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
            "ssd_bwd_dcdb_kernel", "gat_bwd_kernel")
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
    rows in both groups and int8 codes in the int8 group, H·dh 256 and 400.
    The attention also with its lse buffer: the output bitwise the call
    without it, and the lse of every node the plan writes (split nodes
    included) within GAT_LSE_TOL of the plain version's."""
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
        written = torch.from_numpy(np.unique(p.out_node[p.out_node < n])).to("cuda").long()
        split_nodes = dp.split.split_node.long()
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
                    if name == "attention":
                        rows[-1]["lse"] = _check_lse(x, a_args, n, qp, out, written, split_nodes,
                                                     f"{tag} {rows_kind} rows dh={dh}")
                    del out, again, plain
            del z, x, xf, xff
        del lib_a
    return attn_rows, mh_rows


def _check_lse(x, a_args, n, qp, out, written, split_nodes, label):
    """The attention with an lse buffer: its output bitwise ``out`` (the
    call without one), and the lse of the plan's nodes within GAT_LSE_TOL of
    the plain version's (the buffers start as NaN, so a row left unwritten
    fails)."""
    import torch

    from repro_torch.kernels.segment_agg import attn_ops
    from repro_torch.kernels.segment_agg.ref import attend_tiles_ref
    from repro_torch.models.gnn.gat import LEAKY_SLOPE

    h = a_args[2].shape[1]
    lse, lse_plain = (torch.full((n, h), float("nan"), device=x.device) for _ in range(2))
    with_lse = attn_ops.attend_tiles(x, *a_args, num_nodes=n, leaky_slope=LEAKY_SLOPE, qp=qp,
                                     lse=lse)
    attend_tiles_ref(x, *a_args, num_nodes=n, leaky_slope=LEAKY_SLOPE, qp=qp, lse=lse_plain)
    torch.cuda.synchronize()

    def err(rows):
        if rows.numel() == 0:
            return 0.0
        got, want = lse[rows], lse_plain[rows]
        return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())

    row = dict(out_bitwise=bool(torch.equal(with_lse, out)), nodes=int(written.numel()),
               split_nodes=int(split_nodes.numel()), max_err=err(written),
               split_max_err=err(split_nodes))
    log(f"[kernels] attention {label} with lse: output bitwise the call without "
        f"{row['out_bitwise']}; lse of {row['nodes']} nodes ({row['split_nodes']} split) max "
        f"err {row['max_err']:.3g} (split nodes {row['split_max_err']:.3g}; tol "
        f"{GAT_LSE_TOL} of max(1, |lse|))")
    if not (row["out_bitwise"] and row["split_nodes"] > 0
            and row["max_err"] <= GAT_LSE_TOL and row["split_max_err"] <= GAT_LSE_TOL):
        raise RuntimeError(f"attention {label} with lse: {row}")
    return row


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


def phase_sharded_gat(cfg, params, g, want, plan_dir):
    """FULL ample-gat on Yelp over 4 shards: the decomposed layer, its
    softmax denominators and weighted aggregate on the multi-head AGE per
    shard and group (launched on every request), warm == cold, within the
    mixed tolerance of the unsharded output, peak under 20 GiB. Its plan
    cache goes to ``plan_dir`` (for the mesh phase). Returns (row, the cold
    output)."""
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
    srv.save_plan_cache(plan_dir)
    return dict(requests=_request_rows(rows), shard_report=srv.shard_report(), peak_bytes=peak,
                max_abs_err_vs_unsharded=err, launches_request=rows[-1][1]), rows[0][0].outputs


# ------------------------------------------------------------ the mesh backend
MESH_DEADLINE_S = 600  # the whole mesh phase's ranks, start to end
MESH_TIMEOUT_S = 300  # one collective of the gloo group
MESH_TENANTS = (("gold", 2.0, 1), ("batch", 1.0, 0))  # the router's: name, weight, priority
# The GAT QAT step runs on the subgraph induced by Yelp's first three quarters
# of nodes: on all of Yelp a FULL GAT rank peaked at 17.20 GiB (four of them
# and the parent left the card 0.7 GiB short in one run, PERF.md).
MESH_GAT_TRAIN_NODES = 537_635


def induced_subgraph(g, n: int):
    """The subgraph of ``g`` induced by its first ``n`` nodes, features
    kept."""
    import dataclasses

    import numpy as np

    end = int(g.indptr[n])
    keep = g.indices[:end] < n
    kept = np.concatenate([[0], np.cumsum(keep, dtype=np.int64)])
    return dataclasses.replace(
        g, indptr=kept[g.indptr[: n + 1]], indices=g.indices[:end][keep], num_nodes=n,
        features=None if g.features is None else g.features[:n],
        edge_weights=None if g.edge_weights is None else g.edge_weights[:end][keep],
        name=f"{g.name}[:{n}]")


def _mesh_x(srv, eng, feats):
    """The request's features on the card, padded to the engine's graph."""
    import torch

    return torch.from_numpy(srv._pad_features(feats, eng.graph.num_nodes)).to(srv.device)


def _mesh_qat_loss(label, cfg, params, eng, x, inputs):
    """Degree-Quant QAT loss of ``params`` on ``eng``: the example's GCN
    recipe, or ``_gat_qat_loss``; ``inputs`` holds the planted labels, the
    training mask and step 0's protection mask as numpy."""
    import torch

    ex = _example("train_gcn_degreequant_torch")
    labels, train, mask = (torch.from_numpy(inputs[k]).to(x.device)
                           for k in ("labels", "train", "mask"))
    labels = labels.long()
    if label == "gcn":
        return ex.qat_loss(params, eng, x, labels, train, mask)
    return _gat_qat_loss(cfg, params, eng, x, labels, train, mask)


def mesh_train_reference(label, cfg, srv, g):
    """The host loop's QAT step 0 on the sharded engine that ``srv`` served
    Yelp with (its plans and params): the mesh phase's reference. Returns the
    inputs (planted labels, half the nodes for training, a protection mask
    from numpy seed 3), the loss and every gradient, as numpy."""
    import dataclasses

    import numpy as np
    import torch

    ex = _example("train_gcn_degreequant_torch")
    _, eng = _sharded_entry(srv)
    gs = eng.graph
    if gs.num_nodes != g.num_nodes:
        raise RuntimeError(f"mesh {label}: the engine's graph has {gs.num_nodes} nodes, Yelp "
                           f"{g.num_nodes}")
    labels, train = ex.node_task(dataclasses.replace(gs, features=g.features), cfg.vocab_size)
    inputs = dict(labels=labels, train=train,
                  mask=ex.sample_protection_mask(gs, ex.DQ, np.random.default_rng(3)))
    p = _trainable(srv.params)
    loss = _mesh_qat_loss(label, cfg, p, eng, _mesh_x(srv, eng, g.features), inputs)
    grads = torch.autograd.grad(loss, _gat_leaves(p))
    out = dict(inputs, loss=loss.detach().cpu().numpy())
    out.update((f"grad{i}", t.cpu().numpy()) for i, t in enumerate(grads))
    log(f"[mesh] {label}: the host loop's QAT step 0 (4 shards, {cfg.gnn_precision}): loss "
        f"{float(loss.detach()):.6f}, {len(grads)} gradients")
    return out


def mesh_gat_train_reference(cfg, params, g, plan_dir):
    """The GAT step's reference on its subgraph (``MESH_GAT_TRAIN_NODES``):
    a sharded engine serves it once (its shard plans, saved to ``plan_dir``
    for the ranks), then ``mesh_train_reference`` on that engine."""
    from repro_torch.serve.gnn_engine import GNNServeEngine

    sub = induced_subgraph(g, MESH_GAT_TRAIN_NODES)
    srv = GNNServeEngine(cfg, params, num_shards=SHARDS, partitioner="edges", device="cuda")
    resp = srv.infer(sub, sub.features)
    srv.save_plan_cache(plan_dir)
    log(f"[mesh] gat: the QAT step's subgraph, Yelp's first {sub.num_nodes} of {g.num_nodes} "
        f"nodes: {sub.num_edges} of {g.num_edges} edges; planned in {resp.plan_ms:.1f} ms")
    return mesh_train_reference("gat", cfg, srv, sub)


def _mesh_train_launches(sp, label, mode):
    """The AGE, walk and GAT-backward launches of one rank's QAT step,
    counted from its own shard's plans (G groups, F = 1 with a float group).
    GCN: layer 0 serves (its input needs no grad: G), layer 1 G forward, the
    transposed float plan and the halo-transpose sum backward. GAT, a layer:
    the denominators and the aggregate forward (G walks each); backward the
    score sums on the transposed and the forward plans (2G walks), the dz
    walk (F), ``edge_dot`` for the denominators and the aggregate (2G), and
    3 halo-transpose sums (the two score halves and z)."""
    groups = sp.plan.mode_plans[mode]
    n, f = len(groups), int("float" in groups)
    if label == "gcn":
        return {"segment_agg": 2 * n + f + 1}
    return {"segment_agg": 2 * 3, "segment_agg_mh": 2 * (4 * n + f),
            "attention_bwd": 2 * 2 * n, "attention": 0}


def _mesh_train(label, cfg, srv, eng, feats, ref, gathers, rank):
    """One rank's QAT step (loss, backward, AdamW) on the mesh engine
    ``eng``: every gradient bitwise the host loop's ``ref``; forward,
    backward and optimiser ms (CUDA events), the backward's all-gathers
    (ms, bytes), its launches against its own shard's plans, the peak."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    ex = _example("train_gcn_degreequant_torch")
    x = _mesh_x(srv, eng, feats)
    params = _trainable(srv.params)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=EXAMPLE_LR if label == "gcn" else QAT_GAT_LR,
                          weight_decay=ex.WEIGHT_DECAY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    del gathers[:]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = _mesh_qat_loss(label, cfg, params, eng, x, ref)
    ev[1].record()
    n_fwd = len(gathers)
    grads = torch.autograd.grad(loss, _gat_leaves(params))
    ev[2].record()
    adamw_update(_gat_tree(params, grads), opt, params, opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    counts = build.launch_counts()
    bwd = gathers[n_fwd:]
    got = [loss.detach()] + list(grads)
    want = [ref["loss"]] + [ref[f"grad{i}"] for i in range(len(grads))]
    for name, a, b in zip(["loss"] + [f"grad{i}" for i in range(len(grads))], got, want):
        a = a.cpu().numpy()
        if a.shape != b.shape or not np.array_equal(a, b):
            diff = np.abs(a - b).max() if a.shape == b.shape else float("nan")
            raise RuntimeError(f"rank {rank} {label} QAT step: {name} is not bitwise the host "
                               f"loop's (max |diff| {diff:.3e})")
    expect = _mesh_train_launches(eng.sharded_plan.shards[rank], label,
                                  "gcn" if label == "gcn" else "runtime")
    if any(counts.get(k, 0) != v for k, v in expect.items()):
        raise RuntimeError(f"rank {rank} {label} QAT step: launched {counts}, expected {expect}")
    return dict(nodes=eng.graph.num_nodes, edges=eng.graph.num_edges,
                forward_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
                optimizer_ms=ev[2].elapsed_time(ev[3]), step_ms=ev[0].elapsed_time(ev[3]),
                loss=float(loss.detach()), launches=counts, expected_launches=expect,
                backward_all_gather_ms=[a.elapsed_time(b) for a, b, _ in bwd],
                backward_all_gather_bytes=[n for _, _, n in bwd],
                forward_all_gathers=n_fwd, peak_bytes=torch.cuda.max_memory_allocated(),
                grad_hash=hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                                  for t in got)).hexdigest())


def _mesh_fronts(srv, g, feats, want, rank):
    """Three Yelp GCN requests through ``AsyncGNNEngine``, then through a
    two-tenant ``TenantRouter``, window 1 (each window a plan-cache hit of
    the loaded plans): every output bitwise the host loop's; the router's
    window log (rank 0's decisions) returned for the parent to compare."""
    import numpy as np

    from repro_torch.serve.async_gnn import AsyncGNNEngine
    from repro_torch.serve.tenancy.router import TenantRouter

    front = AsyncGNNEngine(srv, window=1)
    t0 = time.perf_counter()
    tickets = [front.submit(g, feats) for _ in range(3)]
    front.drain()
    async_s = time.perf_counter() - t0
    router = TenantRouter(AsyncGNNEngine(srv, window=1))
    for name, weight, prio in MESH_TENANTS:
        router.add_tenant(name, weight=weight, priority=prio)
    t0 = time.perf_counter()
    routed = [router.submit(t, g, feats) for t in ("gold", "batch", "gold")]
    router.drain()
    router_s = time.perf_counter() - t0
    for kind, ts in (("async", tickets), ("router", routed)):
        for i, t in enumerate(ts):
            r = t.response
            if t.error is not None or not r.cache_hit or r.batch_size != 1 or \
                    not np.array_equal(r.outputs, want):
                raise RuntimeError(f"rank {rank} fronts: {kind} request {i} failed, missed the "
                                   f"plan cache or is not bitwise the host loop "
                                   f"({t.error!r})")
    if front.stats["steps"] != 3 or router.stats["windows"] != 3:
        raise RuntimeError(f"rank {rank} fronts: {front.stats['steps']} async windows, "
                           f"{router.stats['windows']} routed")
    return dict(async_s=async_s, router_s=router_s,
                async_run_ms=[t.response.run_ms for t in tickets],
                router_run_ms=[t.response.run_ms for t in routed],
                window_log=[list(w) for w in router.window_log])


def _mesh_step_launches(row, kernel):
    """A kernel's launches in each rank's QAT step of each model."""
    return {m: [r["models"][m]["train"]["launches"].get(kernel, 0) for r in row["per_rank"]]
            for m in ("gcn", "gat")}


def _mesh_launches(sp, mode, layers, split, passes=0):
    """Launches of one rank a request, counted from its own shard's plans:
    per group and layer one aggregate (one per non-empty half when ``split``
    and the shard has halo rows) and ``passes`` more (GAT's denominators)."""
    from repro_torch.core.scheduler import split_plan_by_halo

    n = 0
    for plan in sp.plan.mode_plans[mode].values():
        halves = split_plan_by_halo(plan, sp.num_owned) if split and sp.halo_size else None
        n += passes + (1 if halves is None else sum(h.num_tiles > 0 for h in halves))
    return n * layers


def _mesh_rank(rank, world, directory, queue):
    """One rank of the mesh phase: join the gloo group; for each model serve
    three Yelp requests on its shard, then take one QAT step on the same
    engine; then three GCN requests through each front; check them all,
    report."""
    import datetime
    import hashlib
    import traceback

    try:
        # four processes share the card: growable segments fragment it less
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs.base import get_config
        from repro_torch.serve.gnn_engine import GNNServeEngine

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        t0 = time.perf_counter()
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(directory, 'store')}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("shard",))
        backend = dist.get_backend(mesh.get_group("shard"))
        g = torch.load(os.path.join(directory, "graph.pt"), weights_only=False)
        with open(os.path.join(directory, "plans.json")) as f:
            plan_dirs = json.load(f)
        feats = np.load(os.path.join(directory, "features.npy"))
        gathers = []  # (start event, end event, bytes gathered) of each all-gather
        all_gather = dist.all_gather

        def timed_all_gather(tensor_list, tensor, group=None, async_op=False):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            work = all_gather(tensor_list, tensor, group=group, async_op=async_op)
            rec = [ev[0], ev[1], tensor.nbytes * len(tensor_list)]
            gathers.append(rec)
            if not async_op:
                ev[1].record()
                return work

            class Timed:
                def wait(self):
                    out = work.wait()
                    ev[1].record()
                    return out

            return Timed()

        dist.all_gather = timed_all_gather
        out = dict(rank=rank, backend=backend, start_s=time.perf_counter() - t0, models={})
        for label, arch, overlap, mode, layers in (("gcn", "ample-gcn", False, "gcn", 2),
                                                   ("gat", "ample-gat", True, "runtime", 2)):
            cfg = get_config(arch)
            params = torch.load(os.path.join(directory, f"params_{label}.pt"), weights_only=False)
            want = np.load(os.path.join(directory, f"want_{label}.npy"), mmap_mode="r")
            ref = dict(np.load(os.path.join(directory, f"train_{label}.npz")))
            srv = GNNServeEngine(cfg, params, num_shards=world, partitioner="edges",
                                 halo_overlap=overlap, mesh=mesh, device="cuda")
            t1 = time.perf_counter()
            loaded = srv.load_plan_cache(plan_dirs[label])
            load_s = time.perf_counter() - t1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reqs, hashes = [], []
            for i in range(3):
                del gathers[:]
                resp, counts = _launches(lambda: srv.infer(g, feats))
                torch.cuda.synchronize()
                ag_ms = [a.elapsed_time(b) for a, b, _ in gathers]
                reqs.append(dict(cache_hit=resp.cache_hit, plan_ms=resp.plan_ms,
                                 run_ms=resp.run_ms, halo_bytes=resp.halo_bytes,
                                 launches=counts, all_gather_ms=ag_ms,
                                 all_gather_bytes=[n for _, _, n in gathers]))
                hashes.append(hashlib.sha256(resp.outputs.tobytes()).hexdigest())
                if not np.array_equal(resp.outputs, want):
                    diff = np.abs(resp.outputs - want)
                    raise RuntimeError(f"rank {rank} {label} request {i}: not bitwise the host "
                                       f"loop (max |diff| {diff.max():.3e})")
                if not resp.cache_hit or resp.plan_ms != 0.0:
                    raise RuntimeError(f"rank {rank} {label} request {i}: cache_hit "
                                       f"{resp.cache_hit} plan_ms {resp.plan_ms}")
            splan, eng = _sharded_entry(srv)
            sp = splan.shards[rank]
            if label == "gcn":
                want_launches = {"segment_agg": _mesh_launches(sp, mode, layers, False),
                                 "quant_matmul": 2}
            else:
                want_launches = {"segment_agg_mh": _mesh_launches(sp, mode, layers, overlap,
                                                                  passes=1),
                                 "quant_matmul": 2}
            for r in reqs:
                if r["launches"] != want_launches:
                    raise RuntimeError(f"rank {rank} {label}: launched {r['launches']}, "
                                       f"expected {want_launches}")
            out["models"][label] = dict(
                loaded=loaded, load_s=load_s, requests=reqs, hashes=hashes,
                peak_bytes=torch.cuda.max_memory_allocated(), launches=want_launches,
                owned=sp.num_owned, halo=sp.halo_size, groups=len(sp.plan.mode_plans[mode]),
                halo_stats=eng.halo_stats)
            train_feats = feats
            if label == "gat":  # the step runs on its subgraph's plans
                del srv, eng, splan
                gc.collect()
                torch.cuda.empty_cache()
                srv = GNNServeEngine(cfg, params, num_shards=world, partitioner="edges",
                                     halo_overlap=overlap, mesh=mesh, device="cuda")
                srv.load_plan_cache(plan_dirs["gat_train"])
                splan, eng = _sharded_entry(srv)
                train_feats = feats[:MESH_GAT_TRAIN_NODES]
            out["models"][label]["train"] = _mesh_train(label, cfg, srv, eng, train_feats, ref,
                                                        gathers, rank)
            if label == "gcn":
                out["fronts"] = _mesh_fronts(srv, g, feats, want, rank)
            del srv, eng, splan, params, ref
            gc.collect()
            torch.cuda.empty_cache()
        dist.all_gather = all_gather
        dist.barrier()
        dist.destroy_process_group()
        out["seconds"] = time.perf_counter() - t0
        queue.put(out)
    except BaseException:
        queue.put(dict(rank=rank, error=traceback.format_exc()))


def phase_mesh(inputs, plan_dirs):
    """The mesh backend: 4 ranks on the one card over a gloo group, each
    serving FULL ample-gcn and ample-gat on Yelp through its own shard.
    ``inputs``: label -> (params, the host loop's cold output) and "graph"
    -> the Yelp graph with its features; ``plan_dirs``: label -> the host
    loop's saved plan cache. The parent writes them under
    ``build/mesh_smoke`` and checks what each rank reports."""
    import dataclasses
    import queue as queue_mod

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from repro_torch.serve.gnn_engine import _to_device

    tag = "mesh"
    d = os.path.join(ROOT, "build", "mesh_smoke")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    with open(os.path.join(d, "plans.json"), "w") as f:
        json.dump(plan_dirs, f)
    g = inputs["graph"]
    np.save(os.path.join(d, "features.npy"), g.features)
    torch.save(dataclasses.replace(g, features=None), os.path.join(d, "graph.pt"))
    for label in ("gcn", "gat"):
        params, want, ref = inputs[label]
        torch.save(_to_device(params, torch.device("cpu")), os.path.join(d, f"params_{label}.pt"))
        np.save(os.path.join(d, f"want_{label}.npy"), want)
        np.savez(os.path.join(d, f"train_{label}.npz"), **ref)
    write_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[{tag}] before the ranks: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB; the card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(r, SHARDS, d, q)) for r in range(SHARDS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < SHARDS:
            left = MESH_DEADLINE_S - (time.perf_counter() - t0)
            if left <= 0:
                raise RuntimeError(f"{tag}: the ranks passed the {MESH_DEADLINE_S} s deadline "
                                   f"({sorted(got)} reported)")
            try:
                r = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and i not in got]
                if dead:
                    raise RuntimeError(f"{tag}: rank {dead[0]} exited {procs[dead[0]].exitcode}")
                continue
            if "error" in r:
                raise RuntimeError(f"{tag}: rank {r['rank']} failed:\n{r['error']}")
            got[r["rank"]] = r
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(d, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    row = dict(ranks=SHARDS, card=card_line(), write_s=write_s, ranks_s=ranks_s,
               backend=got[0]["backend"], per_rank=[got[r] for r in range(SHARDS)])
    for label in ("gcn", "gat"):
        hashes = {h for r in got.values() for h in r["models"][label]["hashes"]}
        if len(hashes) != 1:
            raise RuntimeError(f"{tag}: {label}: the ranks' outputs differ ({len(hashes)} hashes)")
        for r in range(SHARDS):
            m = got[r]["models"][label]
            reqs = m["requests"]
            log(f"[{tag}] {label} rank {r}: shard owns {m['owned']} rows, {m['halo']} halo rows, "
                f"{m['groups']} groups; plans loaded {m['loaded']} in {m['load_s']:.2f} s; "
                f"run_ms {[round(x['run_ms'], 3) for x in reqs]}; all-gathers a request "
                f"{len(reqs[-1]['all_gather_ms'])}: "
                f"{[round(x, 3) for x in reqs[-1]['all_gather_ms']]} ms of "
                f"{[round(n / 2**20, 1) for n in reqs[-1]['all_gather_bytes']]} MiB; "
                f"launches {reqs[-1]['launches']}; peak {m['peak_bytes'] / 2**30:.2f} GiB")
        log(f"[{tag}] {label}: halo_bytes {got[0]['models'][label]['requests'][0]['halo_bytes']} "
            f"a request; every rank's three requests bitwise the host loop's output, the same "
            f"on every rank, each a plan-cache hit with plan_ms 0.0")
        trains = [got[r]["models"][label]["train"] for r in range(SHARDS)]
        if len({t["grad_hash"] for t in trains}) != 1:
            raise RuntimeError(f"{tag}: {label}: the ranks' QAT gradients differ")
        for r, t in enumerate(trains):
            log(f"[{tag}] {label} rank {r} QAT step ({t['nodes']} nodes, {t['edges']} edges): "
                f"forward {t['forward_ms']:.1f} ms, backward "
                f"{t['backward_ms']:.1f} ms, optimizer {t['optimizer_ms']:.3f} ms (step "
                f"{t['step_ms']:.1f}); backward all-gathers {len(t['backward_all_gather_ms'])}: "
                f"{[round(x, 1) for x in t['backward_all_gather_ms']]} ms of "
                f"{[round(n / 2**20, 1) for n in t['backward_all_gather_bytes']]} MiB "
                f"({sum(t['backward_all_gather_bytes']) / 2**20:.1f} MiB, "
                f"{sum(t['backward_all_gather_ms']):.1f} ms); launches {t['launches']}; peak "
                f"{t['peak_bytes'] / 2**30:.2f} GiB")
        log(f"[{tag}] {label}: one QAT step (loss {trains[0]['loss']:.6f}) on every rank, its "
            f"loss and every gradient bitwise the host loop's step 0 and the same on all "
            f"{SHARDS} ranks; {card_line()}")
    logs = {json.dumps(got[r]["fronts"]["window_log"]) for r in range(SHARDS)}
    if len(logs) != 1:
        raise RuntimeError(f"{tag}: fronts: the ranks' window logs differ: {logs}")
    for r in range(SHARDS):
        fr = got[r]["fronts"]
        log(f"[{tag}] fronts rank {r}: 3 async windows in {fr['async_s']:.2f} s (run_ms "
            f"{[round(x, 1) for x in fr['async_run_ms']]}), 3 routed in {fr['router_s']:.2f} s "
            f"(run_ms {[round(x, 1) for x in fr['router_run_ms']]})")
    log(f"[{tag}] fronts: window 1, every window a plan-cache hit, every output bitwise the "
        f"host loop's; rank 0's window log on every rank: {got[0]['fronts']['window_log']}")
    log(f"[{tag}] {SHARDS} ranks share one H100 over a {row['backend']} group (NCCL refuses "
        f"two ranks on one device; gloo stages the CUDA blocks through host memory, so the "
        f"all-gathers are loopback through the host, not NVLink); inputs written in "
        f"{write_s:.1f} s, ranks started to done in {ranks_s:.1f} s; {card_line()}")
    return row


# --------------------------------------------------------------- QAT (training)
QAT_STEPS = 10  # Yelp QAT steps timed (cut steps, never width, past ~90 s)
QAT_REPEAT_STEPS = 3  # steps of each of the two runs held bitwise
QAT_ATOL, QAT_RTOL = 5e-4, 1e-3  # f32 paths, tests/test_gnn_models.py:46
QAT_ACC_TOL = 0.03  # the example's accuracies, card against CPU
EXAMPLE_STEPS, EXAMPLE_NODES, EXAMPLE_LR = 300, 800, 5e-3  # the example's defaults


def _example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     f"{name}.py"))
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
    the gates and the example. Returns (the phase's row, the Yelp training
    engine, for ``phase_qat_sharded``)."""
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
    from repro_torch.models.gnn import gcn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    ex = _example("train_gcn_degreequant_torch")
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
    del gr, tdp, x, labels, train, params, opt, grads, params0
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
    # One step through gcn.apply on a mixed-precision engine: the int8 FTE
    # (the GEMM) under grad, its backward on the GEMM's int32 output; the
    # weights' gradients within the mixed tolerance of the CPU's.
    mixed = {}
    rm = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (pub.num_nodes, cfg.vocab_size)).astype(np.float32))
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        em = AmpleEngine(pub, EngineConfig(mixed_precision=True))
        p = ex.trainable(params_to(pparams, d))
        build.reset_launch_counts()
        y = gcn.apply(cfg, p, em, torch.from_numpy(pub.features).to(d))
        mixed[key] = torch.autograd.grad((y * rm.to(d)).sum(), [lyr["w"] for lyr in p["layers"]])
        if key == "card":
            torch.cuda.synchronize()
            row["mixed_step_launches"] = build.launch_counts()
    mixed_errs = {f"w{i}": _mixed_close(a.cpu().numpy(), b.numpy()) for i, (a, b) in
                  enumerate(zip(mixed["card"], mixed["cpu"]))}
    row["mixed_step"] = dict(max_abs_err=mixed_errs, launches=row["mixed_step_launches"])
    log(f"[qat gcn] pubmed mixed-precision step through the int8 FTE: launches "
        f"{row['mixed_step_launches']}, card vs CPU max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in mixed_errs.items())
        + f" (mixed tolerance: atol {MIXED_ATOL}, rtol {MIXED_RTOL})")
    if row["mixed_step_launches"] != {seg_ops.KERNEL: 5, qm_ops.KERNEL: 2}:
        raise RuntimeError(f"the mixed QAT step launched {row['mixed_step_launches']}")
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
    return row, eng

# GAT training: FULL ample-gat's steps on Yelp (cut in steps, never width).
QAT_GAT_STEPS = 6  # timed Degree-Quant QAT steps
QAT_GAT_REPEAT_STEPS = 2  # steps of each of the two runs held bitwise
QAT_GAT_LR = 5e-3
GAT_BWD_TOL = 1e-5  # alpha and ds: relative to each value and to the largest
GAT_BWD_SLICE_TILES = 1024  # tiles at each end of a plan held bitwise against the CPU


def _gat_qat_loss(cfg, params, eng, x, labels, train, protect):
    """Degree-Quant QAT of GAT through the model API: ``gat.apply`` with the
    unprotected rows of each layer's input fake-quantized (the STE), the
    training nodes' mean NLL (``examples/train_gcn_degreequant_torch.py``'s
    recipe)."""
    import torch

    from repro_torch.core.quantization import compute_scale_zp, fake_quant
    from repro_torch.models.gnn import gat

    def fq(h):
        return torch.where(protect[:, None], h, fake_quant(h, compute_scale_zp(h)))

    logp = torch.log_softmax(gat.apply(cfg, params, eng, x, layer_input=fq), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return torch.where(train, nll, 0.0).sum() / train.sum()


def _gat_leaves(params):
    return [lyr[k] for lyr in params["layers"] for k in sorted(lyr)]


def _gat_tree(params, flat):
    it = iter(flat)
    return {"layers": [{k: next(it) for k in sorted(lyr)} for lyr in params["layers"]]}


def _tile_slice(plan, k):
    """The first and last ``k`` tiles of an ``EdgeTilePlan`` (its largest
    nodes, split hubs among them, and its smallest) as a plan that writes
    only the nodes all of whose segments lie in those tiles: (sub-plan,
    those nodes, how many of them are split across tiles)."""
    import dataclasses

    import numpy as np

    n, t = plan.num_nodes, plan.num_tiles
    tiles = np.unique(np.r_[0:min(k, t), max(t - k, 0):t])
    on = plan.out_node
    total = np.bincount(on[on < n], minlength=n + 1)
    sub_on = on[tiles]
    inside = np.bincount(sub_on[sub_on < n], minlength=n + 1)
    whole = (inside == total) & (total > 0)
    sub_on = np.where(whole[sub_on], sub_on, n).astype(np.int32)
    nodes = np.unique(sub_on[sub_on < n])
    sub = dataclasses.replace(plan, gather_idx=plan.gather_idx[tiles], coeff=plan.coeff[tiles],
                              seg_ids=plan.seg_ids[tiles], out_node=sub_on,
                              edge_ids=plan.edge_ids[tiles])
    return sub, nodes, int((total[nodes] > 1).sum())


def _sampled_dots(pattern, gr, z):
    """The per-head dots g_i,h . z_j,h at the CSR pattern's edges, one
    ``torch.sparse.sampled_addmm`` a head (library yardstick): (a function
    giving [E, H] values, for timing the calls alone)."""
    import torch

    h = z.shape[1]
    gk = [gr[:, k, :].contiguous() for k in range(h)]
    zkt = [z[:, k, :].contiguous().t() for k in range(h)]

    def sampled():
        return [torch.sparse.sampled_addmm(pattern, gk[k], zkt[k], beta=0.0) for k in range(h)]

    return sampled


def phase_gat_bwd(eng, zs):
    """The GAT backward at both FULL ample-gat layer shapes on Yelp (``zs``:
    layer 0's z [N, 4, 64] and layer 1's [N, 4, 100]): ``csrc/attn_agg_bwd.cu``
    against its plain version on the card (f32 rows and int8 codes; alpha and
    ds within GAT_BWD_TOL), run to run bitwise, timed beside the plain
    version, the bound, the row floor and ``sampled_addmm`` per head; then,
    at layer 0, the walks that finish the backward (dz on the transposed
    plan, the score sums on the transposed and forward plans) bitwise the
    CPU's plain versions on a slice of each plan (``_tile_slice``), and the
    whole backward timed beside the library calls (``sparse.mm`` on Aᵀ with
    the heads folded in for dz)."""
    import torch

    from repro_torch.core.aggregation import edge_segment_sum_tiles, to_device_plan
    from repro_torch.core.quantization import compute_scale_zp, quantize
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import attn_ops
    from repro_torch.kernels.segment_agg.ref import aggregate_tiles_mh_ref, attend_tiles_bwd_ref
    from repro_torch.models.gnn.gat import LEAKY_SLOPE

    dev = torch.device("cuda")
    n, e = eng.graph.num_nodes, eng.graph.num_edges
    dp = eng._device_plans("runtime", eng.plans("runtime"), dev)["float"]
    t0 = time.perf_counter()
    tg = eng._tile_grad("runtime", "float", dev)
    tp = tg.transposed()
    tplan = eng._tplans[("runtime", "float")]
    transposed_s = time.perf_counter() - t0
    gen = _cuda_gen(11)
    csr = (tg.indices, tg.items)
    pattern = torch.sparse_csr_tensor(torch.from_numpy(eng.graph.indptr).to(dev),
                                      tg.indices.long(), torch.zeros(e, device=dev), (n, n))
    rows = []
    layers = []
    for layer, z in enumerate(zs):
        h, dh = z.shape[1], z.shape[2]
        d = h * dh
        scores = torch.randn((e, h), generator=gen, device=dev)
        gr = torch.randn((n, h, dh), generator=gen, device=dev)
        lse = torch.zeros((n, h), device=dev)
        out = attn_ops.attend_tiles(z, dp.gather_idx, dp.edge_ids, scores, dp.coeff, dp.seg_ids,
                                    dp.out_node, dp.split, num_nodes=n,
                                    leaky_slope=LEAKY_SLOPE, lse=lse)
        sampled = _sampled_dots(pattern, gr, z)
        lib_vals = torch.stack([m.values() for m in sampled()], dim=1)
        dots = lib_vals.new_zeros((e, h))
        attn_ops.edge_dot(z, gr, *csr, out=dots)
        lib_err = float((lib_vals - dots).abs().max())
        sampled_ms = cuda_ms(sampled, reps=3)
        del lib_vals, dots
        qp = compute_scale_zp(z)
        for kind, x, xqp in (("f32", z, None), ("int8", quantize(z, qp), qp)):
            def kernel():
                return attn_ops.attend_tiles_bwd(x, gr, out, lse, scores, *csr,
                                                 leaky_slope=LEAKY_SLOPE, qp=xqp)

            def plain():
                return attend_tiles_bwd_ref(x, gr, out, lse, scores, *csr,
                                            leaky_slope=LEAKY_SLOPE, qp=xqp)

            build.reset_launch_counts()
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            launches = build.launch_counts()
            want = plain()
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = {}
            for name, a, w in zip(("alpha", "ds"), got, want):
                scale = float(w.abs().max())
                errs[name] = float(((a - w).abs() / (GAT_BWD_TOL * (w.abs() + scale))).max())
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            ms = cuda_ms(kernel, reps=5)
            plain_ms = cuda_ms(plain, reps=1)
            elem = x.element_size()
            # each input once (every node is a source and a destination), the
            # two [E, H] outputs once
            nbytes = (n * d * elem + 2 * n * d * 4 + n * h * 4 + e * h * 4 + e * 4
                      + int(csr[1].numel()) * 4 + 2 * e * h * 4)
            ops = 2.0 * e * d + 2.0 * n * d + 8.0 * e * h
            b_ms, b_by = bound(nbytes, ops, FP32_FLOPS)
            row = dict(layer=layer, rows=kind, n=n, edges=e, heads=h, dh=dh, launches=launches,
                       run_to_run_bitwise=bitwise, finite=finite, max_err_in_tol=errs,
                       max_abs_err=max(float((a - w).abs().max()) for a, w in zip(got, want)),
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                       row_floor_ms=e * d * elem / HBM_BPS * 1e3, library_ms=sampled_ms,
                       library_err=lib_err)
            rows.append(row)
            log(f"[gat bwd] kernel layer {layer} {kind} rows N={n} E={e} H={h} dh={dh}: "
                f"launches {launches}, err/tol alpha {errs['alpha']:.3g} ds {errs['ds']:.3g} "
                f"(<= 1: within {GAT_BWD_TOL} of each value and of the largest), bitwise "
                f"{bitwise}; ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
                f"row_floor_ms={row['row_floor_ms']:.3f} sampled_addmm x{h} "
                f"{sampled_ms:.3f} ms (err {lib_err:.3g})")
            if (launches != {attn_ops.ATTENTION_BWD: 2} or not bitwise or not finite
                    or max(errs.values()) > 1.0 or lib_err > 1e-3):
                raise RuntimeError(f"gat bwd {kind}: {row}")
            del got, again, want
        if layer == 0:
            layers.append((z, gr, out, lse, scores))
        del sampled, gr, out, lse, scores
    z, gr, out, lse, scores = layers[0]
    h, dh = z.shape[1], z.shape[2]

    # The walks that finish the backward, given the kernel's alpha and ds:
    # bitwise the CPU's plain versions (each segment summed in lane order)
    # on the nodes of GAT_BWD_SLICE_TILES tiles at each end of the
    # transposed and the forward plan, split hubs included.
    alpha, ds = attn_ops.attend_tiles_bwd(z, gr, out, lse, scores, *csr,
                                          leaky_slope=LEAKY_SLOPE)
    mh_args = (tp.gather_idx, tp.edge_ids, alpha, tp.coeff, tp.seg_ids, tp.out_node, tp.split)
    dz = attn_ops.aggregate_tiles_mh(gr, *mh_args, num_nodes=n, aligned=True)
    sums = [edge_segment_sum_tiles(ds, p, num_nodes=n, aligned=True) for p in (tp, dp)]
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    gr_cpu, alpha_cpu, ds_cpu = gr.cpu(), alpha.cpu(), ds.cpu()
    checked = []
    walks_bitwise = True
    for label, plan, got in (("transposed", tplan, [dz, sums[0]]),
                             ("forward", eng.plans("runtime")["float"], [sums[1]])):
        sub, nodes, n_split = _tile_slice(plan, GAT_BWD_SLICE_TILES)
        sp = to_device_plan(sub, cpu)
        want = [edge_segment_sum_tiles(ds_cpu, sp, num_nodes=n)]
        if label == "transposed":
            want.insert(0, aggregate_tiles_mh_ref(
                gr_cpu, sp.gather_idx, sp.edge_ids, alpha_cpu, sp.coeff, sp.seg_ids,
                sp.out_node, sp.split, num_nodes=n))
        idx = torch.from_numpy(nodes).long()
        walks_bitwise &= all(torch.equal(a.cpu()[idx], b[idx]) for a, b in zip(got, want))
        checked.append(dict(plan=label, tiles=sub.num_tiles, nodes=int(nodes.size),
                            split_nodes=n_split))
        if n_split == 0:
            raise RuntimeError(f"gat bwd: the {label} plan's slice holds no split node")
    cpu_s = time.perf_counter() - t0

    def backward():
        a, s_ = attn_ops.attend_tiles_bwd(z, gr, out, lse, scores, *csr, leaky_slope=LEAKY_SLOPE)
        attn_ops.aggregate_tiles_mh(gr, tp.gather_idx, tp.edge_ids, a, tp.coeff, tp.seg_ids,
                                    tp.out_node, tp.split, num_nodes=n, aligned=True)
        for p in (tp, dp):
            edge_segment_sum_tiles(s_, p, num_nodes=n, aligned=True)

    build.reset_launch_counts()
    backward()
    bwd_launches = build.launch_counts()
    bwd_ms = cuda_ms(backward, reps=3)
    dz_ms = cuda_ms(lambda: attn_ops.aggregate_tiles_mh(gr, *mh_args, num_nodes=n,
                                                        aligned=True), reps=3)

    # Library yardstick of dz: Aᵀ·g with the heads folded into the rows.
    lib_at = _heads_csr(tp, alpha, n)
    gflat = gr.view(n * h, dh)
    spmm_ms = cuda_ms(lambda: torch.sparse.mm(lib_at, gflat), reps=3)
    spmm_err = float((torch.sparse.mm(lib_at, gflat).view(n, h, dh) - dz).abs().max())
    del lib_at, pattern
    sampled_ms = rows[0]["library_ms"]
    live = tplan.edge_ids >= 0
    summary = dict(kernel=rows, transposed_plan_s=transposed_s, transposed_tiles=tplan.num_tiles,
                   transposed_edges=int(live.sum()), walks_bitwise_cpu=walks_bitwise,
                   walks_checked=checked, cpu_walk_s=cpu_s, backward_launches=bwd_launches, backward_ms=bwd_ms,
                   dz_walk_ms=dz_ms, library_sampled_addmm_ms=sampled_ms,
                   library_spmm_ms=spmm_ms,
                   library_spmm_err=spmm_err, library_ms=sampled_ms,
                   backward_library_ms=sampled_ms + spmm_ms)
    log(f"[gat bwd] transposed runtime plan: {tplan.num_tiles} tiles, {int(live.sum())} edges "
        f"({transposed_s:.1f} s); dz and the score sums bitwise the CPU's: {walks_bitwise} "
        f"on {checked} (CPU {cpu_s:.1f} s); whole backward {bwd_ms:.3f} ms (launches {bwd_launches}), its "
        f"dz walk {dz_ms:.3f} ms; library: sparse.mm on Aᵀ {spmm_ms:.3f} ms (err "
        f"{spmm_err:.3g})")
    if not walks_bitwise:
        raise RuntimeError("the GAT backward's walks differ from the CPU's plain versions")
    if bwd_launches != {attn_ops.ATTENTION_BWD: 1, attn_ops.SEGMENT_AGG_MH: 3}:
        raise RuntimeError(f"the GAT backward launched {bwd_launches}")
    if not spmm_err <= AGE_ATOL:
        raise RuntimeError(f"library yardstick differs: {spmm_err}")
    return summary


def phase_qat_gat(g):
    """Degree-Quant QAT of FULL ``ample-gat`` on Yelp with self-loops and
    planted labels through ``gat.apply`` on a float engine: QAT_GAT_STEPS
    AdamW steps timed by phase with their launches, a profiled step, two
    runs bitwise, the deployed int8 accuracy beside the float one, the
    gradients at FULL widths on cora against the CPU's. Returns (row, the
    Yelp training engine, for ``phase_gat_bwd``)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.message_passing import AmpleEngine, EngineConfig
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import attn_ops
    from repro_torch.models.api import params_to
    from repro_torch.models.gnn import api as gnn_api
    from repro_torch.models.gnn import gat
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    ex = _example("train_gcn_degreequant_torch")
    cfg = get_config("ample-gat")
    dev = torch.device("cuda")
    row = {}
    t0 = time.perf_counter()
    gs = gnn_api.prepare_graph(cfg, g)
    x, labels, train = _qat_inputs(ex, gs, cfg.vocab_size, dev)
    eng = AmpleEngine(gs, EngineConfig(mixed_precision=False))
    eng._device_plans("runtime", eng.plans("runtime"), dev)
    row["setup_s"] = time.perf_counter() - t0
    log(f"[qat gat] yelp + self-loops: {gs.num_nodes} nodes {gs.num_edges} edges, heads "
        f"{cfg.gnn_heads}, dims {cfg.gnn_layer_dims}, {int(train.sum())} training nodes; "
        f"setup and plan {row['setup_s']:.1f} s")
    params0 = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device=dev)
    opt_cfg = AdamWConfig(lr=QAT_GAT_LR, weight_decay=ex.WEIGHT_DECAY)

    def step(params, opt, rng, times=None):
        mask = torch.from_numpy(ex.sample_protection_mask(gs, ex.DQ, rng)).to(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = _gat_qat_loss(cfg, params, eng, x, labels, train, mask)
        ev[1].record()
        grads = torch.autograd.grad(loss, _gat_leaves(params))
        ev[2].record()
        params, opt, metrics = adamw_update(_gat_tree(params, grads), opt, params, opt_cfg)
        ev[3].record()
        if times is not None:
            torch.cuda.synchronize()
            times.update(forward_ms=ev[0].elapsed_time(ev[1]),
                         backward_ms=ev[1].elapsed_time(ev[2]),
                         optimizer_ms=ev[2].elapsed_time(ev[3]),
                         grad_norm=float(metrics["grad_norm"]))
        return params, opt, loss

    def trainable(p):
        return {"layers": [{k: v.detach().requires_grad_() for k, v in lyr.items()}
                           for lyr in p["layers"]]}

    params = trainable(params0)
    opt = adamw_init(params)
    rng = np.random.default_rng(3)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for s in range(QAT_GAT_STEPS):
        build.reset_launch_counts()
        st = {}
        params, opt, loss = step(params, opt, rng, st)
        st.update(loss=float(loss.detach()), launches=build.launch_counts())
        steps.append(st)
        log(f"[qat gat] step {s}: loss {st['loss']:.5f} forward {st['forward_ms']:.3f} ms "
            f"backward {st['backward_ms']:.3f} ms optimizer {st['optimizer_ms']:.3f} ms "
            f"launches {st['launches']} grad_norm {st['grad_norm']:.4g}")
    row.update(steps=steps, peak_bytes=torch.cuda.max_memory_allocated())
    want = {attn_ops.ATTENTION: 2, attn_ops.ATTENTION_BWD: 2, attn_ops.SEGMENT_AGG_MH: 6}
    log(f"[qat gat] peak device memory {row['peak_bytes'] / 2**30:.2f} GiB; launches a step "
        f"expected {want}")
    losses = [st["loss"] for st in steps]
    if any(st["launches"] != want for st in steps):
        raise RuntimeError(f"QAT GAT steps launched {[st['launches'] for st in steps]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"QAT GAT losses {losses}: not finite, or not falling")

    wall_ms, _, prof = _device_profile(lambda: step(params, opt, rng), warmup=1)
    busy = sum(ms for _, ms, _ in prof)
    row["profile"] = dict(wall_ms=wall_ms, device_ms=busy if prof else None,
                          top=[dict(name=nm, ms=ms, count=c) for nm, ms, c in prof[:24]])
    if prof:
        log(f"[qat gat] profiled step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
            f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})")
        for nm, ms, count in prof[:14]:
            log(f"[qat gat]   {ms:9.3f} ms  x{count:<4d} {nm[:90]}")

    # Two runs of the same steps from the same seed: bitwise the same.
    runs = []
    for _ in range(2):
        p, o, r = trainable(params0), None, np.random.default_rng(3)
        o = adamw_init(p)
        for _ in range(QAT_GAT_REPEAT_STEPS):
            p, o, _ = step(p, o, r)
        runs.append([t.detach() for t in _gat_leaves(p)])
    row["repeat_bitwise"] = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"[qat gat] two runs of {QAT_GAT_REPEAT_STEPS} steps bitwise equal: "
        f"{row['repeat_bitwise']}")
    if not row["repeat_bitwise"]:
        raise RuntimeError("two QAT GAT runs from one seed gave different parameters")
    del runs

    # Deployment: the trained weights on the float engine and on int8.
    with torch.no_grad():
        test = ~train

        def accuracy(e):
            pred = torch.argmax(gat.apply(cfg, params, e, x), dim=-1)
            return float((pred == labels)[test].to(torch.float32).mean())

        build.reset_launch_counts()
        acc_float = accuracy(eng)
        t0 = time.perf_counter()
        mixed = AmpleEngine(gs, EngineConfig(mixed_precision=True))
        acc_mixed = accuracy(mixed)
        row.update(acc_float=acc_float, acc_mixed=acc_mixed, deploy_s=time.perf_counter() - t0,
                   deploy_launches=build.launch_counts())
        del mixed
    log(f"[qat gat] after {QAT_GAT_STEPS} steps: test accuracy float {acc_float:.4f}, deployed "
        f"int8 {acc_mixed:.4f} (launches {row['deploy_launches']}: float 2 attention, mixed "
        f"4 attention + 2 GEMM)")

    del x, labels, train, params, opt, params0
    gc.collect()
    torch.cuda.empty_cache()

    # FULL widths on a cora-sized graph: the card's gradients within the
    # CPU's f32 tolerance.
    cg = gnn_api.prepare_graph(cfg, make_dataset("cora", max_feature_dim=cfg.d_model, seed=0))
    cparams = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    cmask = torch.from_numpy(ex.sample_protection_mask(cg, ex.DQ, np.random.default_rng(3)))
    got = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        e = AmpleEngine(cg, EngineConfig(mixed_precision=False))
        p = trainable(params_to(cparams, d))
        loss = _gat_qat_loss(cfg, p, e, *_qat_inputs(ex, cg, cfg.vocab_size, d), cmask.to(d))
        got[key] = [loss] + list(torch.autograd.grad(loss, _gat_leaves(p)))
    names = ["loss"] + [f"layer{i}.{k}" for i, lyr in enumerate(cparams["layers"])
                        for k in sorted(lyr)]
    errs = {nm: _close_report(nm, a, b) for nm, a, b in zip(names, got["card"], got["cpu"])}
    row["cora"] = dict(nodes=cg.num_nodes, edges=cg.num_edges, max_abs_err=errs)
    log(f"[qat gat] cora {cg.num_nodes} nodes at FULL widths, step 0 card vs CPU: max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (atol {QAT_ATOL}, rtol {QAT_RTOL})")
    return row, eng


# ------------------------------------- training through the sharded and streamed engines
QAT_SHARDS = 2  # the training phases' host-loop shards
QAT_SHARDED_STEPS = 3  # timed steps on each engine (the sharded and the unsharded one)
QAT_SHARDED_REPEAT_STEPS = 2  # steps of each of the two runs held bitwise
QAT_STREAMED_STEPS = 2  # timed streamed steps (each re-quantizes the features on the host)
QAT_STREAMED_FRAC = 8  # the streamed phase's budget: features.nbytes // 8


def _trainable(p):
    return {"layers": [{k: v.detach().requires_grad_() for k, v in lyr.items()}
                       for lyr in p["layers"]]}


def _grad_report(tag, params, got, want):
    """Max abs difference of each of (loss, gradient leaves) and whether all
    are bitwise; raises beyond the f32 tolerance."""
    import torch

    names = ["loss"] + [f"layer{i}.{k}" for i, lyr in enumerate(params["layers"])
                        for k in sorted(lyr)]
    errs = {nm: _close_report(f"{tag} {nm}", a, b) for nm, a, b in zip(names, got, want)}
    return errs, all(torch.equal(a, b) for a, b in zip(got, want))


def phase_qat_sharded(arch, base):
    """Degree-Quant QAT of FULL ``ample-<arch>`` on Yelp (self-loops) through
    ``ShardedAmpleEngine``: QAT_SHARDS host-loop shards, float, the
    unsharded QAT phase's recipe. Step-0 gradients against the unsharded
    engine ``base`` (that phase's, plans warm) at the f32 tolerance; the
    per-shard transposed plans and the halo-transpose plan built and timed;
    QAT_SHARDED_STEPS steps on each engine by phase with their launches;
    two runs bitwise; the halo-transpose AGE against its plain version and
    ``index_add_``."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.message_passing import EngineConfig, compile_sharded_plans
    from repro_torch.distributed.graph_shard import ShardedAmpleEngine
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg.ref import aggregate_tiles_ref
    from repro_torch.models.gnn import api as gnn_api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    tag = f"qat sharded {arch}"
    ex = _example("train_gcn_degreequant_torch")
    cfg = get_config(f"ample-{arch}")
    dev = torch.device("cuda", torch.cuda.current_device())  # the cache keys' device
    gs, mode = base.graph, gnn_api.agg_mode(cfg)
    x, labels, train = _qat_inputs(ex, gs, cfg.vocab_size, dev)
    row = dict(arch=arch, shards=QAT_SHARDS, nodes=gs.num_nodes, edges=gs.num_edges)
    t0 = time.perf_counter()
    splan = compile_sharded_plans(gs, EngineConfig(mixed_precision=False),
                                  num_shards=QAT_SHARDS, modes=(mode,))
    eng = ShardedAmpleEngine(gs, splan)
    row["plan_s"] = time.perf_counter() - t0
    # What the backward reads, built before the first step: each shard's
    # transposed plans (and TileGrads), then the halo-transpose plan.
    t0 = time.perf_counter()
    for sp in splan.shards:
        for t in sp.plan.mode_plans[mode]:
            eng._shard_transposed(sp, mode, t, dev)
            if mode == "runtime":
                eng._shard_tile_grad(sp, mode, t, dev)
    torch.cuda.synchronize()
    row["transposed_plans_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hplan = eng._halo_transpose(dev)
    torch.cuda.synchronize()
    row["halo_plan_s"] = time.perf_counter() - t0
    stacked = sum(sp.shard.num_local for sp in splan.shards)
    row.update(halo_total=splan.halo_total, stacked_rows=stacked,
               halo_per_shard=[sp.halo_size for sp in splan.shards])
    log(f"[{tag}] yelp + self-loops: {gs.num_nodes} nodes {gs.num_edges} edges, {QAT_SHARDS} "
        f"shards, halo {row['halo_per_shard']} rows; sharded plan {row['plan_s']:.1f} s, the "
        f"shards' transposed plans {row['transposed_plans_s']:.1f} s, the halo-transpose plan "
        f"{row['halo_plan_s']:.1f} s ({stacked} stacked rows)")

    lr = EXAMPLE_LR if arch == "gcn" else QAT_GAT_LR
    opt_cfg = AdamWConfig(lr=lr, weight_decay=ex.WEIGHT_DECAY)
    params0 = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device=dev)

    def loss_fn(p, e, mask):
        if arch == "gcn":
            return ex.qat_loss(p, e, x, labels, train, mask)
        return _gat_qat_loss(cfg, p, e, x, labels, train, mask)

    def step(e, params, opt, rng, times=None):
        mask = torch.from_numpy(ex.sample_protection_mask(gs, ex.DQ, rng)).to(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = loss_fn(params, e, mask)
        ev[1].record()
        grads = torch.autograd.grad(loss, _gat_leaves(params))
        ev[2].record()
        params, opt, _ = adamw_update(_gat_tree(params, grads), opt, params, opt_cfg)
        ev[3].record()
        if times is not None:
            torch.cuda.synchronize()
            times.update(forward_ms=ev[0].elapsed_time(ev[1]),
                         backward_ms=ev[1].elapsed_time(ev[2]),
                         optimizer_ms=ev[2].elapsed_time(ev[3]))
        return params, opt, loss

    # (a) Step 0's gradients: sharded against unsharded, the same mask.
    got = {}
    for key, e in (("unsharded", base), ("sharded", eng)):
        p = _trainable(params0)
        mask = torch.from_numpy(ex.sample_protection_mask(gs, ex.DQ,
                                                          np.random.default_rng(3))).to(dev)
        loss = loss_fn(p, e, mask)
        got[key] = [loss.detach()] + list(torch.autograd.grad(loss, _gat_leaves(p)))
    errs, bitwise = _grad_report(tag, params0, got["sharded"], got["unsharded"])
    row.update(max_abs_err_vs_unsharded=errs, bitwise_vs_unsharded=bitwise)
    log(f"[{tag}] step 0, sharded vs unsharded: max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (atol {QAT_ATOL}, rtol {QAT_RTOL}); bitwise {bitwise}")
    del got

    # (b) Timed steps on both engines from one seed, launches per step.
    torch.cuda.synchronize()
    for key, e in (("unsharded", base), ("sharded", eng)):
        torch.cuda.reset_peak_memory_stats()
        params, rng = _trainable(params0), np.random.default_rng(3)
        opt, steps = adamw_init(params), []
        for s in range(QAT_SHARDED_STEPS):
            build.reset_launch_counts()
            st = {}
            params, opt, loss = step(e, params, opt, rng, st)
            st.update(loss=float(loss.detach()), launches=build.launch_counts())
            st["step_ms"] = st["forward_ms"] + st["backward_ms"] + st["optimizer_ms"]
            steps.append(st)
            log(f"[{tag}] {key} step {s}: loss {st['loss']:.5f} forward {st['forward_ms']:.3f} "
                f"ms backward {st['backward_ms']:.3f} ms optimizer {st['optimizer_ms']:.3f} ms "
                f"launches {st['launches']}")
        row[key] = dict(steps=steps, peak_bytes=torch.cuda.max_memory_allocated(),
                        warm_step_ms=sum(st["step_ms"] for st in steps[1:]) / (len(steps) - 1))
        del params, opt
    sh, un = row["sharded"], row["unsharded"]
    counts = [st["launches"] for st in sh["steps"]]
    log(f"[{tag}] warm step {sh['warm_step_ms']:.3f} ms sharded vs {un['warm_step_ms']:.3f} ms "
        f"unsharded ({sh['warm_step_ms'] / un['warm_step_ms']:.2f}x); peak "
        f"{sh['peak_bytes'] / 2**30:.2f} vs {un['peak_bytes'] / 2**30:.2f} GiB; {card_line()}")
    if any(c != counts[0] for c in counts):
        raise RuntimeError(f"{tag}: steps launched {counts}")
    want = {}
    if arch == "gcn":  # per shard the unsharded step's 3, and one halo-transpose AGE
        want = {seg_ops.KERNEL: QAT_SHARDS * un["steps"][0]["launches"].get(seg_ops.KERNEL, 0) + 1}
    else:  # decomposed: no fused attention; the backward and the halo sums ran
        want = {"attention": 0}
        for k in ("segment_agg_mh", "attention_bwd", seg_ops.KERNEL):
            if not counts[0].get(k):
                raise RuntimeError(f"{tag}: {k} was not launched in a step: {counts[0]}")
    if any(counts[0].get(k, 0) != v for k, v in want.items()):
        raise RuntimeError(f"{tag}: a step launched {counts[0]}, expected {want}")
    if not all(np.isfinite(st["loss"]) for st in sh["steps"]):
        raise RuntimeError(f"{tag}: a loss is not finite")
    row["launches_per_step"] = counts[0]

    # (c) Two runs of the same steps from one seed: bitwise.
    runs = []
    for _ in range(2):
        p, r = _trainable(params0), np.random.default_rng(3)
        o = adamw_init(p)
        for _ in range(QAT_SHARDED_REPEAT_STEPS):
            p, o, _ = step(eng, p, o, r)
        runs.append([t.detach() for t in _gat_leaves(p)])
    row["repeat_bitwise"] = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"[{tag}] two runs of {QAT_SHARDED_REPEAT_STEPS} steps bitwise equal: "
        f"{row['repeat_bitwise']}")
    if not row["repeat_bitwise"]:
        raise RuntimeError(f"{tag}: two runs from one seed gave different parameters")
    del runs

    # (d) The halo gradient's sum: the AGE on the halo-transpose plan at the
    # widest row a backward hands it, against its plain version, bitwise
    # twice, and index_add_ over the stacked ids (the library call).
    d = cfg.gnn_layer_dims[1]
    n = gs.num_nodes
    gr = torch.randn((stacked, d), generator=_cuda_gen(21), device=dev)
    args = (hplan.gather_idx, hplan.coeff, hplan.seg_ids, hplan.out_node, hplan.split)
    out = seg_ops.aggregate_tiles(gr, *args, num_nodes=n)
    again = seg_ops.aggregate_tiles(gr, *args, num_nodes=n)
    plain = aggregate_tiles_ref(gr, *args, num_nodes=n)
    ids = torch.cat(eng._shard_state[("local_ids", str(dev))])
    lib = torch.zeros((n, d), device=dev).index_add_(0, ids, gr)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    if not torch.equal(out, again) or err > AGE_ATOL or float((out - lib).abs().max()) > AGE_ATOL:
        raise RuntimeError(f"{tag}: the halo-transpose AGE: err {err}, bitwise twice "
                           f"{torch.equal(out, again)}")
    ms = cuda_ms(lambda: seg_ops.aggregate_tiles(gr, *args, num_nodes=n), 10)
    plain_ms = cuda_ms(lambda: aggregate_tiles_ref(gr, *args, num_nodes=n), 5)
    lib_ms = cuda_ms(lambda: torch.zeros((n, d), device=dev).index_add_(0, ids, gr), 10)
    nbytes = stacked * d * 4 + n * d * 4 + 3 * hplan.gather_idx.numel() * 4
    bms, by = bound(nbytes, stacked * d, FP32_FLOPS)
    row["halo_sum"] = dict(rows=stacked, n=n, d=d, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bms, bound_by=by, max_abs_err=err)
    log(f"[{tag}] halo-transpose AGE [{stacked} x {d}] -> [{n} x {d}]: {ms:.3f} ms (plain "
        f"{plain_ms:.3f}, index_add_ {lib_ms:.3f}, bound {bms:.3f} by {by}); max abs err vs "
        f"plain {err:.3g}, bitwise twice; {card_line()}")
    del gr, out, again, plain, lib
    return row, eng


def phase_qat_streamed(g):
    """FULL ``ample-gat`` on a mixed engine on Yelp (self-loops), layer 0's
    FTE streamed from page-locked host features at 1/QAT_STREAMED_FRAC of the
    matrix: the int8 GEMM once per chunk under grad. Step-0 gradients against
    the in-memory features' on the same engine; QAT_STREAMED_STEPS AdamW
    steps by phase with the bytes streamed and the launches."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.message_passing import AmpleEngine, EngineConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_matmul import ops as qm_ops
    from repro_torch.memory.feature_store import FeatureStore, default_chunk_rows
    from repro_torch.memory.prefetcher import StreamedFeatures
    from repro_torch.models.gnn import api as gnn_api
    from repro_torch.models.gnn import gat
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    tag = "qat streamed"
    ex = _example("train_gcn_degreequant_torch")
    cfg = get_config("ample-gat")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    gs = gnn_api.prepare_graph(cfg, g)
    x, labels, train = _qat_inputs(ex, gs, cfg.vocab_size, dev)
    eng = AmpleEngine(gs, EngineConfig(mixed_precision=True))
    eng._device_plans("runtime", eng.plans("runtime"), dev)
    budget = gs.features.nbytes // QAT_STREAMED_FRAC
    rows = default_chunk_rows(gs.num_nodes, gs.features.shape[1], budget)
    store = FeatureStore.from_array(gs.features, chunk_rows=rows, pin_memory=True)
    row = dict(setup_s=time.perf_counter() - t0, budget_bytes=budget, chunk_rows=rows,
               chunks=store.num_chunks, feature_bytes=gs.features.nbytes)
    log(f"[{tag}] mixed engine, yelp + self-loops {gs.num_nodes} nodes; features "
        f"{gs.features.nbytes / 2**20:.1f} MiB on the host, budget {budget / 2**20:.1f} MiB, "
        f"{store.num_chunks} chunks of {rows} rows; setup and plans {row['setup_s']:.1f} s")
    params0 = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device=dev)
    opt_cfg = AdamWConfig(lr=QAT_GAT_LR, weight_decay=ex.WEIGHT_DECAY)

    def loss_fn(p, feats):
        logp = torch.log_softmax(gat.apply(cfg, p, eng, feats), dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        return torch.where(train, nll, 0.0).sum() / train.sum()

    # (a) Step 0: streamed against in-memory features, the same engine.
    got = {}
    for key in ("in memory", "streamed"):
        p = _trainable(params0)
        feats = x if key == "in memory" else StreamedFeatures(store, budget, device=dev)
        t0 = time.perf_counter()
        loss = loss_fn(p, feats)
        got[key] = [loss.detach()] + list(torch.autograd.grad(loss, _gat_leaves(p)))
        torch.cuda.synchronize()
        row[f"first_step_s_{key}"] = time.perf_counter() - t0
    errs, bitwise = _grad_report(tag, params0, got["streamed"], got["in memory"])
    row.update(max_abs_err_vs_in_memory=errs, bitwise_vs_in_memory=bitwise)
    log(f"[{tag}] step 0, streamed vs in memory: max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; bitwise {bitwise} (first steps {row['first_step_s_in memory']:.1f} s in memory, "
        f"{row['first_step_s_streamed']:.1f} s streamed)")
    del got

    # (b) Steps through the streamed features, by phase.
    params = _trainable(params0)
    opt, steps = adamw_init(params), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for s in range(QAT_STREAMED_STEPS):
        sf = StreamedFeatures(store, budget, device=dev)
        build.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        loss = loss_fn(params, sf)
        ev[1].record()
        grads = torch.autograd.grad(loss, _gat_leaves(params))
        ev[2].record()
        params, opt, _ = adamw_update(_gat_tree(params, grads), opt, params, opt_cfg)
        ev[3].record()
        torch.cuda.synchronize()
        st = dict(loss=float(loss.detach()), wall_ms=(time.perf_counter() - t0) * 1e3,
                  forward_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
                  optimizer_ms=ev[2].elapsed_time(ev[3]), launches=build.launch_counts(),
                  bytes_streamed=sf.stats.bytes_streamed)
        steps.append(st)
        log(f"[{tag}] step {s}: loss {st['loss']:.5f} forward {st['forward_ms']:.3f} ms "
            f"backward {st['backward_ms']:.3f} ms optimizer {st['optimizer_ms']:.3f} ms (wall "
            f"{st['wall_ms']:.1f} ms); streamed {st['bytes_streamed'] / 2**20:.1f} MiB; "
            f"launches {st['launches']}")
    row.update(steps=steps, peak_bytes=torch.cuda.max_memory_allocated())
    gemms = [st["launches"].get(qm_ops.KERNEL, 0) for st in steps]
    if any(gm < store.num_chunks for gm in gemms):
        raise RuntimeError(f"{tag}: the int8 GEMM ran {gemms} times a step, fewer than the "
                           f"{store.num_chunks} chunks")
    for k in ("attention", "attention_bwd", "segment_agg_mh"):
        if not all(st["launches"].get(k) for st in steps):
            raise RuntimeError(f"{tag}: {k} was not launched in every step")
    if not all(st["bytes_streamed"] > 0 and np.isfinite(st["loss"]) for st in steps):
        raise RuntimeError(f"{tag}: a step streamed nothing or its loss is not finite")
    log(f"[{tag}] peak device memory {row['peak_bytes'] / 2**30:.2f} GiB; {card_line()}")
    del params, opt, eng, store, x
    return row


REMAT_ARCH, REMAT_LAYERS = "qwen3-8b", 8  # of 36: two embeddings + 8 layers, ~2.8 B params
REMAT_BATCH, REMAT_STEPS = 2, 3  # B 2 x TRAIN_SEQ; the first step of each policy warms up


def phase_remat():
    """FULL-width Qwen3-8B (its config sets ``remat="block"``) cut to
    REMAT_LAYERS layers: a training step's forward and backward
    (``loss_fn`` then ``torch.autograd.grad``) under ``"none"`` and
    ``"block"``: warm step time, peak memory, launches (block runs each
    unit's forward twice), gradients bitwise."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.api import loss_fn, model_init

    tag = "remat"
    full = get_config(REMAT_ARCH)
    if full.remat != "block":
        raise RuntimeError(f"{REMAT_ARCH} sets remat={full.remat!r}, not 'block'")
    cfg = dataclasses.replace(full, num_layers=REMAT_LAYERS)
    params = model_init(cfg, _cuda_gen(0), device="cuda")
    leaves = [t.requires_grad_() for t in _tree_leaves(params)]
    n_params = sum(t.numel() for t in leaves)
    b = synthetic_batch(seed=0, step=0, batch=REMAT_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab_size,
                        family=cfg.family)
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    row = dict(arch=REMAT_ARCH, layers=REMAT_LAYERS, params=n_params, batch=REMAT_BATCH,
               seq=TRAIN_SEQ, cut=f"{REMAT_LAYERS} of {full.num_layers} layers: the 36 layers "
               "hold 8.2 B params, 16.4 GB in bf16 with as much again of gradients; "
               "widths are the published ones")
    log(f"[{tag}] FULL-width {REMAT_ARCH} at {REMAT_LAYERS} of {full.num_layers} layers: "
        f"{n_params:,} params; B {REMAT_BATCH} x {TRAIN_SEQ}; {card_line()}")
    grads = {}
    for policy in ("none", "block"):
        c = dataclasses.replace(cfg, remat=policy)
        steps = []
        for s in range(REMAT_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            build.reset_launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            loss, _ = loss_fn(params, c, batch)
            ev[1].record()
            g = torch.autograd.grad(loss, leaves)
            ev[2].record()
            torch.cuda.synchronize()
            st = dict(loss=float(loss.detach()), forward_ms=ev[0].elapsed_time(ev[1]),
                      backward_ms=ev[1].elapsed_time(ev[2]), launches=build.launch_counts(),
                      peak_bytes=torch.cuda.max_memory_allocated(), base_bytes=base)
            st["step_ms"] = st["forward_ms"] + st["backward_ms"]
            # what the step itself held at its peak (the other policy's kept
            # gradients sit in base)
            st["step_peak_bytes"] = st["peak_bytes"] - base
            steps.append(st)
            log(f"[{tag}] {policy} step {s}: loss {st['loss']:.5f} forward "
                f"{st['forward_ms']:.1f} ms backward {st['backward_ms']:.1f} ms; peak "
                f"{st['peak_bytes'] / 2**30:.2f} GiB, {st['step_peak_bytes'] / 2**30:.2f} GiB "
                f"above the {base / 2**30:.2f} GiB held before the step; launches "
                f"{st['launches']}")
            del loss
            if s == REMAT_STEPS - 1:
                grads[policy] = g
            del g
        warm = steps[1:]
        row[policy] = dict(steps=steps, warm_step_ms=sum(st["step_ms"] for st in warm) / len(warm),
                           peak_bytes=max(st["peak_bytes"] for st in warm),
                           step_peak_bytes=max(st["step_peak_bytes"] for st in warm))
        want_fwd = REMAT_LAYERS * (2 if policy == "block" else 1)
        got_fwd = warm[-1]["launches"].get(fa_ops.KERNEL, 0)
        got_bwd = warm[-1]["launches"].get(fa_ops.BWD_DQ_KERNEL, 0)
        if got_fwd != want_fwd or got_bwd != REMAT_LAYERS:
            raise RuntimeError(f"{tag} {policy}: flash forward {got_fwd} (expected {want_fwd}), "
                               f"backward {got_bwd} (expected {REMAT_LAYERS}) launches a step")
    errs = [float((a.float() - c.float()).abs().max()) for a, c in
            zip(grads["none"], grads["block"])]
    row["grads_bitwise"] = all(torch.equal(a, c) for a, c in zip(grads["none"], grads["block"]))
    row["grads_max_abs_err"] = max(errs)
    n, bl = row["none"], row["block"]
    log(f"[{tag}] warm step {n['warm_step_ms']:.1f} ms none, {bl['warm_step_ms']:.1f} ms block "
        f"({bl['warm_step_ms'] / n['warm_step_ms']:.3f}x); a step's peak above what it "
        f"found {n['step_peak_bytes'] / 2**30:.2f} GiB none, {bl['step_peak_bytes'] / 2**30:.2f} "
        f"GiB block; gradients bitwise "
        f"{row['grads_bitwise']} (max abs diff {row['grads_max_abs_err']:.3g}); {card_line()}")
    if not row["grads_bitwise"]:
        raise RuntimeError(f"{tag}: the checkpointed step's gradients differ from the plain one's")
    if not bl["step_peak_bytes"] < n["step_peak_bytes"]:
        raise RuntimeError(f"{tag}: block remat did not lower the peak")
    del grads, params, leaves
    return row


def phase_examples():
    """The three examples ported in full, once each on the card, briefly."""
    import torch

    from repro_torch.kernels import build

    rows = {}
    for name, kwargs in (("quickstart_torch", dict(device="cuda")),
                         ("serve_lm_torch", dict(device="cuda")),
                         ("ample_simulation_torch", dict(device="cuda", max_nodes=20_000))):
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = _example(name).run(**kwargs)
        torch.cuda.synchronize()
        rows[name] = dict(seconds=time.perf_counter() - t0, launches=build.launch_counts())
        if name == "quickstart_torch":
            rows[name].update(res)
            ok = (res["warm_equals_cold"] == 1.0 and res["outofcore_bitwise"] == 1.0
                  and res["gat_warm_equals_cold"] == 1.0 and res["oracle_agreement"] >= 0.9)
        elif name == "serve_lm_torch":
            ok = tuple(res.shape) == (4, 40)
        else:
            ok = all(r["event_driven"]["latency_ms"] > 0 for r in res.values())
        log(f"[examples] {name}: {rows[name]['seconds']:.1f} s, launches "
            f"{rows[name]['launches']}, ok {ok}")
        if not ok or (name != "ample_simulation_torch" and not rows[name]["launches"]):
            raise RuntimeError(f"example {name} failed on the card: {rows[name]}")
    return rows


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


COMPRESS_STEPS = 2  # steps with each compressor, from the lm train phase's own state
# The leaves the CPU recomputes a compressed step: the embedding and the
# unit's leaves of at most this many entries (its two 66 M-entry attention
# projections and three 385 M-entry MLP leaves would take the host's top-k
# a minute a step).
COMPRESS_GATE_MAX = 16_000_000


class _CompressProbe:
    """A compressor as the train step calls it, with CUDA events around the
    compression itself and device copies of the gated leaves' gradients and
    error state, before and after."""

    def __init__(self, comp, gated):
        import torch

        self.comp, self.gated = comp, gated
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def init_state(self, grads):
        return self.comp.init_state(grads)

    def compress_decompress(self, grads, state):
        grad_leaves, err_leaves = _tree_leaves(grads), _tree_leaves(state)
        self.inputs = {j: (grad_leaves[j].clone(), err_leaves[j].clone()) for j in self.gated}
        self.events[0].record()
        out, new = self.comp.compress_decompress(grads, state)
        self.events[1].record()
        out_leaves, new_leaves = _tree_leaves(out), _tree_leaves(new)
        self.outputs = {j: (out_leaves[j].clone(), new_leaves[j].clone()) for j in self.gated}
        return out, new


def _bits(t):
    """A tensor's bits, for a bitwise comparison."""
    import torch

    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _cpu_gate(name, comp, j, card_in, card_out, draws):
    """Leaf ``j`` compressed on the CPU from the card's gradient and error
    state (and, for int8, the card's draws): bitwise the card's output and
    new error state?"""
    import torch

    from repro_torch.distributed.compression import int8_leaf, topk_leaf

    g, e = card_in
    cpu = topk_leaf(g, e, comp.ratio) if name == "topk" else int8_leaf(g, e, draws)
    return all(torch.equal(_bits(a), _bits(b)) for a, b in zip(card_out, cpu))


def _compressed_steps(cfg, tcfg, trainer, box, first_batch, tag):
    """COMPRESS_STEPS train steps with each compressor (top-k at 1%, int8),
    continuing the state in ``box`` (a one-item list, so that no caller
    keeps the state alive past the first step): step and compress ms, the
    error state's bytes, the peak, the flash launches. Each step's gated
    leaves are copied to the host; after the last step (so that no host
    work competes with the steps' launches) worker threads recompute them on
    the CPU from the card's gradients and error state (int8 on the card's
    draws), held bitwise. Returns (the state, the rows)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.checkpoint.checkpoint import _paths
    from repro_torch.distributed.compression import Int8Compressor, TopKCompressor
    from repro_torch.kernels import build
    from repro_torch.train.train_step import make_train_step

    state = box.pop()
    pending = []  # (what, the _cpu_gate arguments) of each gated leaf and step
    paths = _paths(state["params"])
    sizes = [t.numel() for t in _param_leaves(state)]
    gated = [j for j, (p, n) in enumerate(zip(paths, sizes))
             if p == "embed" or (p.startswith("units/") and n <= COMPRESS_GATE_MAX)]
    want = _train_launches(cfg)
    rows, batch_i = {}, first_batch
    for name, comp in (("topk", TopKCompressor(ratio=0.01)), ("int8", Int8Compressor())):
        probe = _CompressProbe(comp, gated)
        step_fn = make_train_step(cfg, tcfg.opt, total_steps=tcfg.steps, warmup=tcfg.warmup,
                                  compressor=probe)
        state["compress"] = comp.init_state(state["params"])
        err_bytes = sum(e.nbytes for e in _tree_leaves(state["compress"]))
        steps = []
        for i in range(COMPRESS_STEPS):
            batch = trainer.batch(batch_i)
            batch_i += 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(build.launch_counts())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, metrics = step_fn(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            counts = {k: v - before.get(k, 0) for k, v in build.launch_counts().items()
                      if v - before.get(k, 0)}
            st = dict(step=int(state["step"]), loss=float(metrics["loss"]),
                      grad_norm=float(metrics["grad_norm"]),
                      step_ms=ev[0].elapsed_time(ev[1]),
                      compress_ms=probe.events[0].elapsed_time(probe.events[1]),
                      peak_bytes=torch.cuda.max_memory_allocated(), launches=counts)
            st["compress_share"] = st["compress_ms"] / st["step_ms"]
            t0 = time.perf_counter()
            for j in gated:
                card_in = [t.cpu() for t in probe.inputs[j]]
                draws = (None if name == "topk" else
                         comp.draws(j, card_in[0].shape, probe.inputs[j][0].device).cpu())
                pending.append(((name, st["step"], paths[j]), (
                    name, comp, j, card_in, [t.cpu() for t in probe.outputs[j]], draws)))
            st["copy_s"] = time.perf_counter() - t0
            st["gated_entries"] = sum(sizes[j] for j in gated)
            del probe.inputs, probe.outputs
            steps.append(st)
            log(f"[{tag}] --compress {name} step {st['step']}: loss {st['loss']:.4f} grad_norm "
                f"{st['grad_norm']:.4f}; step {st['step_ms']:.1f} ms, compress "
                f"{st['compress_ms']:.1f} ms ({st['compress_share']:.3f} of the step); error "
                f"state {err_bytes / 1e9:.3f} GB; peak {st['peak_bytes'] / 2**30:.2f} GiB; "
                f"launches {counts}; {len(gated)} leaves ({st['gated_entries']:,} entries) "
                f"copied to the host for the CPU in {st['copy_s']:.1f} s")
            if any(counts.get(k, 0) != v for k, v in want.items()):
                raise RuntimeError(f"{tag} {name}: launches {counts}, expected {want}")
            if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
                raise RuntimeError(f"{tag} {name}: not finite: {st}")
        rows[name] = dict(steps=steps, error_state_bytes=err_bytes,
                          gated=[paths[j] for j in gated])
        del state["compress"], step_fn, probe
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        oks = list(pool.map(lambda p: _cpu_gate(*p[1]), pending))
    gate_s = time.perf_counter() - t0
    bad = [what for (what, _), ok in zip(pending, oks) if not ok]
    if bad:
        raise RuntimeError(f"{tag}: compressed on the card, not bitwise the CPU's: {bad}")
    rows["cpu_gate_s"] = gate_s
    log(f"[{tag}] every gated leaf of the {2 * COMPRESS_STEPS} compressed steps bitwise the "
        f"CPU's compress_decompress ({len(pending)} leaves, {gate_s:.1f} s on "
        f"{os.cpu_count()} host threads after the last step); {card_line()}")
    return state, rows


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
    if arch == TRAIN_ARCH:  # gradient compression, from this state
        box = [state]
        del state
        state, row["compressed"] = _compressed_steps(cfg, tcfg, trainer, box, 2 * TRAIN_STEPS,
                                                     tag)
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
    # plan files go under build/ (ignored by git) and are removed after the
    # mesh phase, which loads the sharded GCN's and GAT's.
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
    with phase("mesh reference gcn"):  # the host loop's QAT step 0, for the mesh phase
        mesh_inputs = {"graph": g, "gcn": (srv.params, sharded_y,
                                           mesh_train_reference("gcn", cfg, ssrv, g))}
    del ssrv
    with phase("sharded mincut"):
        mincut_row = phase_sharded_mincut(cfg, srv.params)
    del srv, entry
    gc.collect()
    torch.cuda.empty_cache()

    # Degree-Quant QAT through the AGE's backward on the transposed plan.
    with phase("qat gcn"):
        qat_row, qat_gcn_engine = phase_qat(g)
    # The same training through the sharded engine, against that engine.
    qat_sharded_rows = {}
    with phase("qat sharded gcn"):
        qat_sharded_rows["gcn"], _ = phase_qat_sharded("gcn", qat_gcn_engine)
    del qat_gcn_engine
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
        sgat_row, sgat_y = phase_sharded_gat(gat_cfg, gsrv.params, g, gouts[0].outputs,
                                             os.path.join(plan_dir, "sharded_gat"))
    with phase("mesh reference gat"):
        mesh_inputs["gat"] = (gsrv.params, sgat_y, mesh_gat_train_reference(
            gat_cfg, gsrv.params, g, os.path.join(plan_dir, "mesh_gat_train")))
    del gsrv, gentry
    gc.collect()
    torch.cuda.empty_cache()
    # The mesh backend: 4 ranks on the card, on the sharded phases' plan
    # files and against their host-loop outputs.
    with phase("mesh"):
        mesh_row = phase_mesh(mesh_inputs, {"gcn": os.path.join(plan_dir, "sharded"),
                                            "gat_train": os.path.join(plan_dir, "mesh_gat_train"),
                                            "gat": os.path.join(plan_dir, "sharded_gat")})
    shutil.rmtree(plan_dir, ignore_errors=True)
    del mesh_inputs, sgat_y

    # GAT training: Degree-Quant QAT through the fused attention's backward,
    # then that backward's kernel at both layers' shapes on the same engine.
    with phase("qat gat"):
        qat_gat_row, qat_gat_engine = phase_qat_gat(g)
    with phase("gat bwd"):
        # z at both layers' shapes: H 4 of 64 (hidden, concatenated) and of
        # 100 (the output layer, averaged).
        zs = [torch.randn((qat_gat_engine.graph.num_nodes, gat_cfg.gnn_heads, dh),
                          generator=_cuda_gen(12 + k), device="cuda")
              for k, dh in enumerate((gat_cfg.gnn_layer_dims[1] // gat_cfg.gnn_heads,
                                      gat_cfg.gnn_layer_dims[2]))]
        gat_bwd_row = phase_gat_bwd(qat_gat_engine, zs)
    del zs
    with phase("qat sharded gat"):
        qat_sharded_rows["gat"], _ = phase_qat_sharded("gat", qat_gat_engine)
    del qat_gat_engine
    gc.collect()
    torch.cuda.empty_cache()
    with phase("qat streamed"):
        qat_streamed_row = phase_qat_streamed(g)
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
    with phase("remat"):
        remat_row = phase_remat()
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
    with phase("examples"):
        example_rows = phase_examples()

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
             # one rank's request on the mesh (4 ranks, its own shard's groups)
             launches_mesh_rank_request=[r["models"]["gcn"]["launches"]["segment_agg"]
                                         for r in mesh_row["per_rank"]],
             # one rank's QAT step on the mesh: its own shard's forward and backward
             # AGE and the halo-transpose sums
             launches_mesh_rank_train_step=_mesh_step_launches(mesh_row, "segment_agg"),
             # a Yelp QAT step: 2 forward, 1 backward on the transposed plan
             launches_qat_step=qat_row["steps"][0]["age_launches"],
             launches_qat_deploy=qat_row["deploy_launches"].get("segment_agg", 0),
             launches_mixed_qat_step=qat_row["mixed_step_launches"].get("segment_agg", 0),
             # a sharded Yelp QAT step (2 host-loop shards): the forward's and the
             # backward's per shard, and the halo-transpose sums
             launches_qat_sharded_step={a: r["launches_per_step"].get("segment_agg", 0)
                                        for a, r in qat_sharded_rows.items()},
             halo_transpose={a: r["halo_sum"] for a, r in qat_sharded_rows.items()},
             qat_backward={k: qat_row["backward_kernel"][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "d",
                 "tiles", "n")}),
        dict(kernel_row("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
                        "src/repro/kernels/quant_matmul/repack.py:108",
                        counts.get("quant_matmul", 0), gemm,
                        f"M={gemm['m']} K={gemm['k']} N={gemm['n']}"),
             launches_by_path=by_path("quant_matmul"),
             launches_streamed_request=streamed("quant_matmul"),
             launches_sharded_request=sharded_row["launches_request"].get("quant_matmul", 0),
             # every rank runs the FTE on the whole matrix, as the reference's
             # global transform does
             launches_mesh_rank_request={m: [r["models"][m]["launches"]["quant_matmul"]
                                             for r in mesh_row["per_rank"]]
                                         for m in ("gcn", "gat")},
             launches_mesh_rank_train_step=_mesh_step_launches(mesh_row, "quant_matmul"),
             # one pubmed step through gcn.apply on a mixed engine (item 9)
             launches_mixed_qat_step=qat_row["mixed_step_launches"].get("quant_matmul", 0),
             # a FULL ample-gat step with layer 0's FTE streamed (once a chunk)
             launches_qat_streamed_step=qat_streamed_row["steps"][-1]["launches"].get(
                 "quant_matmul", 0)),
        kernel_row("attention", "src/repro_torch/csrc/attn_agg.cu",
                   "src/repro/kernels/segment_agg/attn_kernel.py:194",
                   gcounts.get("attention", 0), attn, gat_shape.format(**attn)),
        dict(kernel_row("segment_agg_mh", "src/repro_torch/csrc/attn_agg.cu",
                        "src/repro/kernels/segment_agg/attn_kernel.py:239",
                        dec_row["launches"].get("segment_agg_mh", 0), mh, gat_shape.format(**mh)),
             launches_sharded_request=sgat_row["launches_request"].get("segment_agg_mh", 0),
             launches_mesh_rank_request=[r["models"]["gat"]["launches"]["segment_agg_mh"]
                                         for r in mesh_row["per_rank"]],
             launches_mesh_rank_train_step=_mesh_step_launches(mesh_row, "segment_agg_mh"),
             launches_qat_gat_step=qat_gat_row["steps"][0]["launches"].get("segment_agg_mh", 0),
             launches_qat_sharded_gat_step=qat_sharded_rows["gat"]["launches_per_step"].get(
                 "segment_agg_mh", 0),
             qat_gat_dz_walk_ms=gat_bwd_row["dz_walk_ms"]),
        # The GAT backward: launches in the FULL ample-gat QAT run on Yelp
        # (QAT_GAT_STEPS steps, one a layer a step), times at layer 0's shape
        # (f32 rows; the codes' row beside).
        dict(kernel_row("attention_bwd", "src/repro_torch/csrc/attn_agg_bwd.cu",
                        "src/repro/kernels/segment_agg/attn_kernel.py:194",
                        sum(st["launches"].get("attention_bwd", 0)
                            for st in qat_gat_row["steps"]),
                        dict(gat_bwd_row["kernel"][0], library_ms=gat_bwd_row["library_ms"]),
                        "N={n} E={edges} H={heads} dh={dh}, {rows} rows".format(
                            **gat_bwd_row["kernel"][0])),
             note="the gradient of the Pallas kernel at replaces, which the reference takes "
                  "by jax.grad of its jnp path (src/repro/core/message_passing.py:1095-1098)",
             library="torch.sparse.sampled_addmm, once per head (the dots at the CSR's "
                     "pattern)",
             launches_per_step=qat_gat_row["steps"][0]["launches"].get("attention_bwd", 0),
             launches_qat_sharded_gat_step=qat_sharded_rows["gat"]["launches_per_step"].get(
                 "attention_bwd", 0),
             launches_mesh_rank_train_step=_mesh_step_launches(mesh_row, "attention_bwd"),
             launches_qat_streamed_step=qat_streamed_row["steps"][-1]["launches"].get(
                 "attention_bwd", 0),
             cases={"layer {layer} {rows} rows dh {dh}".format(**r): {k: r[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "row_floor_ms",
                 "library_ms")} for r in gat_bwd_row["kernel"]},
             backward_ms=gat_bwd_row["backward_ms"],
             backward_library_ms=gat_bwd_row["backward_library_ms"]),
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
             # a warm Qwen3-8B step at 8 layers, remat "none" and "block"
             launches_remat_step={p: remat_row[p]["steps"][-1]["launches"].get(fa_ops.KERNEL, 0)
                                  for p in ("none", "block")},
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
        sharded_mincut=mincut_row, sharded_gat=sgat_row, mesh=mesh_row, qat_gcn=qat_row,
        qat_gat=qat_gat_row, gat_bwd=gat_bwd_row, examples=example_rows,
        qat_sharded=qat_sharded_rows, qat_streamed=qat_streamed_row, remat=remat_row,
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
