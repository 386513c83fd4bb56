"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc/`` have a plain C interface. On first
use they are compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, then linked into one shared
library under ``build/repro_torch/`` at the root of the checkout and loaded
with ``ctypes``. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a built one is reused.

Each kernel wrapper calls ``count_launch`` exactly where it launches its
kernel, so a run can show that it went through the kernels:
``reset_launch_counts()`` before the run, ``launch_counts()`` after it.

A kernel's result carries no autograd graph. So each wrapper calls
``require_no_grad`` before it launches: under grad, an input that requires
grad raises instead of leaving a gradient silently cut. The AGE's backward
is the AGE on the transposed plan (``core/aggregation.py``), which runs the
wrapper with grad off; flash attention's and the SSD's are kernels of their
own (``csrc/flash_attention_bwd.cu``, ``csrc/ssd_scan_bwd.cu``), each behind
an autograd Function in its ``ops.py``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

__all__ = [
    "BuildReport",
    "build",
    "library",
    "call",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
    "require_no_grad",
]

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C entry point -> argument types. Every entry point returns the
# cudaError_t of its launches (0 = success).
_SIGNATURES = {
    "ample_segment_agg": [
        _I,  # device
        _P, _I, _P, _P, _I,  # x, element bytes (4: f32, 1: int8 codes), qscale, qzero, row stride
        _P, _P, _P, _P, _P, _P, _P,  # gather_idx, coeff, seg_ids, out_node, slot_of, split_ptr, split_node
        _P, _P,  # partial, out
        _I, _I, _I, _I, _I, _I,  # num_tiles, lanes, segs, d, n_split, num_nodes
        _I, _I, _I, _I, _I, _I,  # chunk_bytes, groups, per_group, lanes_per_stage, threads, smem_bytes
        _P,  # stream
    ],
    "ample_attention": [
        _I,  # device
        _P, _I, _P, _P, _I,  # x, element bytes (4: f32, 1: int8 codes), qscale, qzero, row stride
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # gather_idx, edge_ids, scores, coeff, seg_ids, out_node, slot_of, split_ptr, split_node
        _P, _P, _P, _P,  # part_a, part_m, part_l, out
        _I, _I, _I, _I, _I, _I, _I,  # num_tiles, lanes, segs, heads, dh, n_split, num_nodes
        _I, _I, _I, _I, _I, _I,  # chunk_bytes, groups, per_group, lanes_per_stage, threads, smem_bytes
        _F,  # leaky slope
        _P,  # stream
    ],
    "ample_segment_agg_mh": [
        _I,  # device
        _P, _I, _P, _P, _I,  # x, element bytes, qscale, qzero, row stride
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # gather_idx, edge_ids, edge_coeff, coeff (or null), seg_ids, out_node, slot_of, split_ptr, split_node
        _P, _P,  # part_a, out
        _I, _I, _I, _I, _I, _I, _I,  # num_tiles, lanes, segs, heads, dh, n_split, num_nodes
        _I, _I, _I, _I, _I, _I,  # chunk_bytes, groups, per_group, lanes_per_stage, threads, smem_bytes
        _P,  # stream
    ],
    "ample_quant_matmul": [
        _I,  # device
        _P, _P, _P,  # a [M, K], w [N, Kp], out [M, N]
        _I, _I, _I, _I,  # m, k, n, kp
        _P,  # stream
    ],
    "ample_flash_attention": [
        _I,  # device
        _P, _P, _P, _P,  # q [B, S, H, hd], k, v [B, T, KV, hd], out [B, S, H, hd]
        _P,  # lse f32 [B, H, S] or null
        _I,  # 1 = bf16, 0 = f32
        _I, _I, _I, _I, _I, _I,  # b, s, t, h, kv, hd
        _I,  # 1 = causal, 0 = no mask
        _F,  # scale (1 / sqrt(hd))
        _P,  # stream
    ],
    "ample_flash_attention_tc": [
        _I,  # device
        _P, _P, _P, _P,  # q [B, S, H, hd], k, v [B, T, KV, hd], out [B, S, H, hd], all bf16
        _P,  # lse f32 [B, H, S] or null
        _I, _I, _I, _I, _I, _I,  # b, s, t, h, kv, hd (64 or 128)
        _I,  # 1 = causal, 0 = no mask
        _F,  # scale (1 / sqrt(hd))
        _P,  # stream
    ],
    "ample_flash_attention_bwd_dq": [
        _I,  # device
        _P, _P, _P, _P, _P,  # q [B, S, H, hd], k, v [B, T, KV, hd], out, dout [B, S, H, hd]
        _P, _P,  # lse f32 [B, H, S] (in), D = rowsum(dout * out) f32 [B, H, S] (out)
        _P,  # dq [B, S, H, hd]
        _I,  # 1 = bf16, 0 = f32
        _I, _I, _I, _I, _I, _I,  # b, s, t, h, kv, hd
        _I,  # 1 = causal, 0 = no mask
        _F,  # scale (1 / sqrt(hd))
        _P,  # stream
    ],
    "ample_flash_attention_bwd_dkdv": [
        _I,  # device
        _P, _P, _P, _P,  # q [B, S, H, hd], k, v [B, T, KV, hd], dout [B, S, H, hd]
        _P, _P,  # lse, D f32 [B, H, S] (the dq kernel's)
        _P, _P,  # dk, dv [B, T, KV, hd]
        _I,  # 1 = bf16, 0 = f32
        _I, _I, _I, _I, _I, _I,  # b, s, t, h, kv, hd
        _I,  # 1 = causal, 0 = no mask
        _F,  # scale (1 / sqrt(hd))
        _P,  # stream
    ],
    "ample_flash_attention_bwd_tc_dq": [
        _I,  # device
        _P, _P, _P, _P, _P,  # q [B, S, H, hd], k, v [B, T, KV, hd], out, dout, all bf16
        _P, _P,  # lse f32 [B, H, S] (in), D = rowsum(dout * out) f32 [B, H, S] (out)
        _P,  # dq [B, S, H, hd]
        _I, _I, _I, _I, _I, _I,  # b, s, t, h, kv, hd (64 or 128)
        _I,  # 1 = causal, 0 = no mask
        _F,  # scale (1 / sqrt(hd))
        _P,  # stream
    ],
    "ample_flash_attention_bwd_tc_dkdv": [
        _I,  # device
        _P, _P, _P, _P,  # q [B, S, H, hd], k, v [B, T, KV, hd], dout [B, S, H, hd], all bf16
        _P, _P,  # lse, D f32 [B, H, S] (the dq kernel's)
        _P, _P,  # dk, dv [B, T, KV, hd]
        _P, _I,  # f32 partial sums [2, splits, B, T, KV, hd] (null when splits is 1), splits
        _I, _I, _I, _I, _I, _I,  # b, s, t, h, kv, hd (64 or 128)
        _I,  # 1 = causal, 0 = no mask
        _F,  # scale (1 / sqrt(hd))
        _P,  # stream
    ],
    "ample_ssd_intra_chunk": [
        _I,  # device
        _P, _P, _P, _P, _P,  # cc, bc [B, NC, Q, N], xdt [B, NC, H, Q, P], acum [B, NC, H, Q], out
        _P,  # C Bᵀ scratch
        _I, _I, _I, _I, _I, _I,  # b, nc, q, n, h, p
        _I,  # heads per block
        _P,  # stream
    ],
    "ample_ssd_intra_chunk_bwd": [
        _I,  # device
        _P, _P, _P, _P, _P,  # cc, bc [B, NC, Q, N], xdt [B, NC, H, Q, P], acum [B, NC, H, Q], dy
        _P, _P, _P, _P,  # dcc, dbc, dxdt, dacum
        _P, _P, _P, _P,  # scratch: C Bᵀ tiles [B, NC, T (T + 1) / 2, 64, 64]; dCB [runs, B, NC, QP, QP]; G partials: rows [B, NC, H, T, QP], keys [B, NC, H, QP]
        _I, _I, _I, _I, _I, _I,  # b, nc, q, n, h, p
        _L, _L, _L,  # dy's strides (floats): chunk, head, row
        _I, _I,  # heads per run of the first kernel; its ring's slots (0: the deepest that fits)
        _P,  # stream
    ],
}

_launches: Dict[str, int] = {}
_lib: Optional[ctypes.CDLL] = None

# Where each kernel gets a backward: the item of ROADMAP.md's queue 1.
_BACKWARD = {
    "segment_agg": "AmpleEngine.aggregate differentiates it for static coefficients; "
                   "the sharded and streamed engines under grad are ROADMAP.md queue 1 "
                   "item 10",
    "attention": "ROADMAP.md queue 1 item 8 (GAT training on the card)",
    "segment_agg_mh": "ROADMAP.md queue 1 item 8 (GAT training on the card)",
    "quant_matmul": "ROADMAP.md queue 1 item 9 (QAT through the int8 FTE)",
}


def require_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through kernel ``name``: grad
    mode is on and one of ``tensors`` (None allowed) requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no backward "
            f"({_BACKWARD.get(name, 'no ROADMAP.md item yet')}); run it under "
            "torch.no_grad()")


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (called where a kernel launches)."""
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


@dataclasses.dataclass(frozen=True)
class BuildReport:
    library: Path
    seconds: float  # 0.0 when an earlier build of the same sources was reused
    ptxas_log: str  # nvcc -Xptxas -v output: registers, shared memory, spills


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels need the CUDA toolkit to build"
    )


def _sources() -> List[Path]:
    srcs = sorted(SOURCE_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SOURCE_DIR}")
    return srcs


def build() -> BuildReport:
    """Compile ``csrc/*.cu`` into one shared library (reused when current)."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libample_kernels-{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return BuildReport(lib, 0.0, log.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{lib.stem}-{tag}.tmp.so"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}")
    text = "\n".join(logs)
    log_tmp = BUILD_DIR / f"{log.name}.{tag}.tmp"
    log_tmp.write_text(text)
    os.replace(tmp, lib)
    os.replace(log_tmp, log)
    return BuildReport(lib, time.perf_counter() - t0, text)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().library))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def call(name: str, device: torch.device, *args) -> None:
    """Launch C entry point ``name`` on ``device``'s current stream; raise
    if the launch was refused (the entry point returns cudaGetLastError)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    status = getattr(library(), name)(index, *args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
