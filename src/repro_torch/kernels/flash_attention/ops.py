"""Wrapper of the flash-attention kernel: q [B,S,H,hd], k/v [B,T,KV,hd] in,
causal attention [B,S,H,hd] out (the layout of the reference's ``ops.py``;
the kernel reads it directly, so nothing is transposed).

A CUDA tensor launches ``csrc/flash_attention.cu``; a CPU tensor takes the
plain version (``ref.py``). q-head ``h`` reads kv-head ``h // (H // KV)``.

The source holds two kernels of one function, and ``flash_variant`` picks
one from the dtype, the head dim and the alignment: the tensor-core kernel
(bf16, hd 64 or 128, 16-byte aligned bases: every served LM) or the
CUDA-core kernel (everything else, f32 above all). Every launch counts under
``KERNEL``; a tensor-core launch also counts under ``TC_KERNEL``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["KERNEL", "TC_KERNEL", "TC_HEAD_DIMS", "MAX_HEAD_DIM", "flash_attention",
           "flash_variant"]

KERNEL = "flash_attention"
TC_KERNEL = "flash_attention_tc"
TC_HEAD_DIMS = (64, 128)  # the tensor-core kernel's tiles
MAX_HEAD_DIM = 128  # the kernel's widest tile


def flash_variant(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
    """``"tensor_cores"`` for bf16 with a head dim of ``TC_HEAD_DIMS`` and
    16-byte aligned bases (its cp.async copies move 16 bytes), else
    ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS and aligned:
        return "tensor_cores"
    return "cuda_cores"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be [B,S,H,hd] and k, v [B,T,KV,hd], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, hd = q.shape
    bk, t, kv, hdk = k.shape
    if bk != b or hdk != hd or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if not 1 <= s <= t:
        # With S > T the first S - T query rows would see no key at all.
        raise ValueError(f"causal attention needs 1 <= S <= T, got S={s}, T={t}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, masked where ``kpos - (T - S) > qpos``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be f32 or all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} exceeds the kernel's {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v, out))
    if flash_variant(q.dtype, hd, aligned) == "tensor_cores":
        build.call(
            "ample_flash_attention_tc", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kv, hd, scale,
        )
        build.count_launch(TC_KERNEL)
    else:
        build.call(
            "ample_flash_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, t, h, kv, hd, scale,
        )
    build.count_launch(KERNEL)
    return out
