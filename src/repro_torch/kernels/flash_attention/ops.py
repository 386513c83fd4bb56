"""Wrapper of the flash-attention kernel: q [B,S,H,hd], k/v [B,T,KV,hd] in,
attention [B,S,H,hd] out (the layout of the reference's ``ops.py``; the
kernel reads it directly, so nothing is transposed). ``causal=True`` masks
where ``kpos - (T - S) > qpos`` (self-attention of a decoder, S <= T);
``causal=False`` masks nothing (an encoder, S = T, and cross-attention, any
S and T), the TPU kernel's two branches.

A CUDA tensor launches ``csrc/flash_attention.cu``; a CPU tensor takes the
plain version (``ref.py``). q-head ``h`` reads kv-head ``h // (H // KV)``.

Under grad (grad mode on and an input that requires grad) the call goes
through ``FlashAttentionFunction``: its forward launches the forward kernel
with the rows' log-sum-exp as a second output, and its backward launches the
two kernels of ``csrc/flash_attention_bwd.cu`` (dQ with D = rowsum(dO ∘ O),
then dK/dV), counted under ``BWD_DQ_KERNEL`` and ``BWD_DKDV_KERNEL``. The
backward has the forward's two variants, picked by the same
``flash_variant``: a call whose inputs, output and gradients would all feed
the tensor-core forward runs the tensor-core pair (``wgmma``; also counted
under ``BWD_TC_KERNEL``), every other call the CUDA-core pair. On CPU
tensors the same Function runs ``flash_attention_lse_ref`` and
``flash_attention_bwd_ref``. A CUDA tensor never takes a plain version.

The source holds two kernels of one function, and ``flash_variant`` picks
one from the dtype, the head dim and the alignment: the tensor-core kernel
(bf16, hd 64 or 128, 16-byte aligned bases: every served LM) or the
CUDA-core kernel (everything else, f32 above all); each kernel has a causal
and an unmasked instance. Every launch counts under ``KERNEL``; a
tensor-core launch also counts under ``TC_KERNEL``, an unmasked one under
``NONCAUSAL_KERNEL``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)

__all__ = ["KERNEL", "TC_KERNEL", "NONCAUSAL_KERNEL", "BWD_DQ_KERNEL", "BWD_DKDV_KERNEL",
           "BWD_TC_KERNEL", "TC_HEAD_DIMS", "MAX_HEAD_DIM", "FlashAttentionFunction",
           "flash_attention", "flash_attention_bwd", "flash_variant", "bwd_variant",
           "bwd_head_splits"]

KERNEL = "flash_attention"
TC_KERNEL = "flash_attention_tc"
NONCAUSAL_KERNEL = "flash_attention_noncausal"
BWD_DQ_KERNEL = "flash_attention_bwd_dq"
BWD_DKDV_KERNEL = "flash_attention_bwd_dkdv"
BWD_TC_KERNEL = "flash_attention_bwd_tc"
TC_HEAD_DIMS = (64, 128)  # the tensor-core kernel's tiles
MAX_HEAD_DIM = 128  # the kernel's widest tile
# The tensor-core dK/dV grid is split over the q-heads until it has this
# many blocks per SM: fewer leave the first key blocks of a causal call alone
# on the card at the end, more add partial sums to write and read
# (``python3 tools/flash_bwd_splits_sweep.py`` times every split on the card).
BWD_MIN_WAVES = 3


def flash_variant(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
    """``"tensor_cores"`` for bf16 with a head dim of ``TC_HEAD_DIMS`` and
    16-byte aligned bases (its cp.async copies move 16 bytes), else
    ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS and aligned:
        return "tensor_cores"
    return "cuda_cores"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be [B,S,H,hd] and k, v [B,T,KV,hd], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, hd = q.shape
    bk, t, kv, hdk = k.shape
    if bk != b or hdk != hd or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if s < 1 or t < 1:
        raise ValueError(f"attention needs S >= 1 and T >= 1, got S={s}, T={t}")
    if causal and s > t:
        # With S > T the first S - T query rows would see no key at all.
        raise ValueError(f"causal attention needs 1 <= S <= T, got S={s}, T={t}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention; causal masks where ``kpos - (T - S) > qpos``. Under grad
    the result carries the backward kernels' gradient."""
    _check(q, k, v, causal)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    return _forward(q, k, v, causal, with_lse=False)[0]


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward: the kernels on CUDA tensors, their
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if q.device.type == "cpu":
            out, lse = flash_attention_lse_ref(q, k, v, causal=causal)
        else:
            out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal)
        return dq, dk, dv, None


def _cuda_inputs(*xs: torch.Tensor) -> None:
    if xs[0].device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {xs[0].device}")
    dt = xs[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(x.dtype != dt for x in xs):
        raise TypeError(f"q, k, v must all be f32 or all bf16, got {[x.dtype for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("q, k and v must be contiguous")
    if xs[0].shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {xs[0].shape[-1]} exceeds the kernel's {MAX_HEAD_DIM}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, *,
             with_lse: bool):
    """Launch the forward kernel: (out, lse f32 [B, H, S] or None)."""
    _cuda_inputs(q, k, v)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lse_ptr = lse.data_ptr() if with_lse else None
    scale = 1.0 / math.sqrt(hd)
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v, out))
    if flash_variant(q.dtype, hd, aligned) == "tensor_cores":
        build.call(
            "ample_flash_attention_tc", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, b, s, t, h, kv,
            hd, int(causal), scale,
        )
        build.count_launch(TC_KERNEL)
    else:
        build.call(
            "ample_flash_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
            int(q.dtype == torch.bfloat16), b, s, t, h, kv, hd, int(causal), scale,
        )
    build.count_launch(KERNEL)
    if not causal:
        build.count_launch(NONCAUSAL_KERNEL)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True):
    """(dq, dk, dv) for the upstream gradient ``dout`` of ``out`` (the forward's
    output, with its log-sum-exp ``lse`` f32 [B, H, S]): the two backward
    kernels on CUDA tensors, ``flash_attention_bwd_ref`` on CPU tensors."""
    _check(q, k, v, causal)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} must match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    dout = dout.contiguous()
    _cuda_inputs(q, k, v, out, dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous f32")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dvec = torch.empty_like(lse)  # D = rowsum(dout * out), the dq kernel's, for dk/dv
    scale = 1.0 / math.sqrt(hd)
    if bwd_variant(q, k, v, out, dout, dq, dk, dv) == "tensor_cores":
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = bwd_head_splits(b, t, kv, h // kv, sms)
        partial = (torch.empty((2, splits, b, t, kv, hd), dtype=torch.float32, device=q.device)
                   if splits > 1 else None)
        build.call(
            "ample_flash_attention_bwd_tc_dq", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), b, s, t, h, kv, hd, int(causal),
            scale,
        )
        build.count_launch(BWD_DQ_KERNEL)
        build.call(
            "ample_flash_attention_bwd_tc_dkdv", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if partial is None else partial.data_ptr(), splits, b, s, t, h, kv, hd,
            int(causal), scale,
        )
        build.count_launch(BWD_DKDV_KERNEL)
        build.count_launch(BWD_TC_KERNEL)
        return dq, dk, dv
    bf16 = int(q.dtype == torch.bfloat16)
    build.call(
        "ample_flash_attention_bwd_dq", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), bf16, b, s, t, h, kv, hd, int(causal),
        scale,
    )
    build.count_launch(BWD_DQ_KERNEL)
    build.call(
        "ample_flash_attention_bwd_dkdv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), bf16, b, s, t, h, kv, hd, int(causal),
        scale,
    )
    build.count_launch(BWD_DKDV_KERNEL)
    return dq, dk, dv


def bwd_variant(*tensors: torch.Tensor) -> str:
    """The backward's variant for q, k, v, out, dout and the three gradients:
    ``flash_variant`` of q's dtype and head dim, aligned only if every base
    is."""
    return flash_variant(tensors[0].dtype, tensors[0].shape[-1],
                         all(x.data_ptr() % 16 == 0 for x in tensors))


def bwd_head_splits(b: int, t: int, kv: int, g: int, sms: int) -> int:
    """How many blocks share each (kv-head, batch, 64 keys) of the tensor-core
    dK/dV kernel, each over its own run of the ``g`` q-heads: 1 where the
    grid already fills the card, else the fewest of the divisors of ``g`` that
    give ``BWD_MIN_WAVES`` blocks per SM (all ``g`` if none does). Under the
    causal mask a key block's walk is as long as the query rows that see it,
    so with few blocks the first key blocks alone set the kernel's time."""
    blocks = kv * b * -(-t // 64)
    for d in range(1, g + 1):
        if g % d == 0 and blocks * d >= BWD_MIN_WAVES * sms:
            return d
    return g
