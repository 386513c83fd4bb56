"""Mamba2 — SSD (state-space duality) blocks, chunked form + decode recurrence.

The reference's ``repro/models/lm/mamba.py``: gated x/z projection, causal
depthwise conv on (x, B, C), softplus-dt discretization with a scalar decay
per head (A), and the SSD chunked algorithm:

  * intra-chunk: the quadratic term ``((C Bᵀ) ∘ L) @ X·dt`` with
    ``L[i,j] = exp(Σ_{j<k≤i} a_k)``, through the SSD kernel's wrapper
    (``kernels/ssd_scan``): on a CUDA tensor it launches
    ``csrc/ssd_scan.cu``, on a CPU tensor it runs the plain version. The
    reference computes the same term with einsums in the layer;
  * inter-chunk: a linear recurrence over per-chunk states, a loop over the
    chunks (the reference's ``lax.scan``).

Decode is the pure recurrence: state ← decay·state + B·(dt·x), y = C·state.
Single B/C group (G=1), shared across heads. The casts follow the reference
step by step: projections in the model dtype, the conv in f32 cast back, B,
C, dt, softplus and the decay in f32, ``rmsnorm(y · silu(z))`` in f32, then
``y`` in the model dtype through ``out_proj``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.lm.norm import rmsnorm, rmsnorm_init

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "mamba_state_init", "softplus_inverse_dt"]


def mamba_init(make, d_model: int, *, d_inner: int, ssm_state: int, heads: int,
               conv: int = 4, dtype=torch.bfloat16) -> Dict:
    """Projections in the model dtype; conv, decay and norm params in f32
    (``make``: a parameter maker of ``transformer.py``)."""
    n, h = ssm_state, heads
    f32 = torch.float32

    def conv_init(c):
        return {"w": make.normal((conv, c), conv**-0.5, f32), "b": make.zeros((c,), f32)}

    return {
        "wx": make.normal((d_model, d_inner), d_model**-0.5, dtype),
        "wz": make.normal((d_model, d_inner), d_model**-0.5, dtype),
        "wb": make.normal((d_model, n), d_model**-0.5, dtype),
        "wc": make.normal((d_model, n), d_model**-0.5, dtype),
        "wdt": make.normal((d_model, h), d_model**-0.5, dtype),
        "conv_x": conv_init(d_inner),
        "conv_b": conv_init(n),
        "conv_c": conv_init(n),
        "A_log": make.zeros((h,), f32),  # A = -exp(A_log) = -1
        "D": make.ones((h,), f32),
        "dt_bias": make.dt_bias((h,)),  # softplus^-1 of dt in [1e-3, 1e-1]
        "norm_scale": rmsnorm_init(make, d_inner),
        "out_proj": make.normal((d_inner, d_model), d_inner**-0.5, dtype),
    }


def _causal_conv(u: torch.Tensor, conv: Dict) -> torch.Tensor:
    """Depthwise causal conv1d: u [B, L, C], w [K, C] -> silu(conv) [B, L, C]."""
    w, b = conv["w"], conv["b"]
    k = w.shape[0]
    u32 = u.float()
    pad = F.pad(u32, (0, 0, k - 1, 0))
    out = torch.zeros_like(u32)
    for i in range(k):  # K is tiny (4): unrolled taps, as in the reference
        out = out + pad[:, i : i + u.shape[1], :] * w[i]
    return F.silu(out + b).to(u.dtype)


def mamba_apply(params: Dict, x: torch.Tensor, *, d_inner: int, ssm_state: int, heads: int,
                headdim: int, chunk: int = 256, norm_eps: float = 1e-6,
                return_state: bool = False):
    """x [B, L, D] -> [B, L, D] (and, with ``return_state``, the decode state)."""
    b, l, _ = x.shape
    n, h, p = ssm_state, heads, headdim
    z = x @ params["wz"]
    ux, ub, uc = x @ params["wx"], x @ params["wb"], x @ params["wc"]
    xc = _causal_conv(ux, params["conv_x"])
    bb = _causal_conv(ub, params["conv_b"]).float()
    cc = _causal_conv(uc, params["conv_c"]).float()
    dt = x @ params["wdt"]

    dt = F.softplus(dt.float() + params["dt_bias"])  # [B,L,H]
    a = -torch.exp(params["A_log"])  # [H]
    adt = dt * a  # log-decay per step [B, L, H]

    # ---- chunking: padded steps have dt = 0, so their decay is 1 and they add 0
    q = min(chunk, l)
    nc = -(-l // q)
    lp = nc * q
    if lp != l:
        xc, z, bb, cc, adt, dt = (F.pad(t, (0, 0, 0, lp - l)) for t in (xc, z, bb, cc, adt, dt))
    xh = xc.reshape(b, nc, q, h, p).float()
    xdt = xh * dt.reshape(b, nc, q, h)[..., None]  # fold dt into B·x
    bc = bb.reshape(b, nc, q, n)
    cch = cc.reshape(b, nc, q, n)
    acum = torch.cumsum(adt.reshape(b, nc, q, h), dim=2)  # [B,nc,Q,H]

    # intra-chunk (diagonal block), in the kernel's layout [B,nc,H,Q,(P)]
    y_diag = ssd_ops.ssd_intra_chunk(
        cch, bc, xdt.permute(0, 1, 3, 2, 4).contiguous(), acum.permute(0, 1, 3, 2).contiguous()
    ).permute(0, 1, 3, 2, 4)  # [B,nc,Q,H,P]

    # chunk-final states: S_c = Σ_j exp(acum_last - acum_j) B_j ⊗ xdt_j
    decay_states = torch.exp(acum[:, :, -1:, :] - acum)  # [B,nc,Q,H]
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc, decay_states, xdt)

    # inter-chunk recurrence over the chunks
    chunk_decay = torch.exp(acum[:, :, -1, :])  # [B,nc,H]
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)  # the state entering chunk c
        s = states[:, c] + s * chunk_decay[:, c, :, None, None]
    s_prev = torch.stack(s_prevs, dim=1)  # [B,nc,H,P,N]

    # off-diagonal: contribution of the carried state to every position
    state_decay = torch.exp(acum)  # [B,nc,Q,H]
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", cch, s_prev, state_decay)

    y = (y_diag + y_off).reshape(b, lp, h, p) + params["D"][None, None, :, None] * xh.reshape(
        b, lp, h, p)
    y = y.reshape(b, lp, d_inner)[:, :l]
    z = z[:, :l]
    y = rmsnorm(params["norm_scale"], y * F.silu(z.float()), eps=norm_eps)
    out = y.to(x.dtype) @ params["out_proj"]
    if not return_state:
        return out
    # Decode-continuation state: the final SSM state and the last K-1 raw conv
    # inputs, front-padded with zeros when L < K-1.
    need = params["conv_x"]["w"].shape[0] - 1

    def tail(u):  # [B, L, C] -> [B, K-1, C]
        u = F.pad(u, (0, 0, max(0, need - u.shape[1]), 0))
        return u[:, u.shape[1] - need:].float()

    state = {"conv_x": tail(ux), "conv_b": tail(ub), "conv_c": tail(uc), "ssm": s}
    return out, state


def mamba_state_init(batch: int, *, d_inner: int, ssm_state: int, heads: int, headdim: int,
                     conv: int = 4, dtype=torch.float32, device="cpu") -> Dict:
    """Decode state: conv windows for (x, B, C) + the SSM state tensor."""
    n = ssm_state

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_x": zeros(batch, conv - 1, d_inner),
        "conv_b": zeros(batch, conv - 1, n),
        "conv_c": zeros(batch, conv - 1, n),
        "ssm": zeros(batch, heads, headdim, n),
    }


def _conv_step(u_t: torch.Tensor, conv_state: torch.Tensor, conv: Dict):
    """One causal-conv step: u_t [B, C]; returns (silu(out) [B, C], new_state)."""
    window = torch.cat([conv_state, u_t[:, None, :].to(conv_state.dtype)], dim=1)  # [B, K, C]
    out = torch.einsum("bkc,kc->bc", window.float(), conv["w"])
    return F.silu(out + conv["b"]), window[:, 1:]


def mamba_decode(params: Dict, x: torch.Tensor, state: Dict, *, d_inner: int, ssm_state: int,
                 heads: int, headdim: int, norm_eps: float = 1e-6):
    """One-token recurrence for x [B, 1, D]. Returns (y [B,1,D], new_state)."""
    b = x.shape[0]
    h, p = heads, headdim
    xt = x[:, 0]
    z = xt @ params["wz"]
    xc, ncx = _conv_step(xt @ params["wx"], state["conv_x"], params["conv_x"])
    bb, ncb = _conv_step(xt @ params["wb"], state["conv_b"], params["conv_b"])
    cc, ncc = _conv_step(xt @ params["wc"], state["conv_c"], params["conv_c"])
    dt = F.softplus((xt @ params["wdt"]).float() + params["dt_bias"])  # [B,H]
    decay = torch.exp(dt * (-torch.exp(params["A_log"])))  # [B,H]
    xh = xc.reshape(b, h, p).float()
    xdt = xh * dt[..., None]
    s_new = state["ssm"] * decay[..., None, None] + torch.einsum("bn,bhp->bhpn", bb, xdt)
    y = torch.einsum("bn,bhpn->bhp", cc, s_new) + params["D"][None, :, None] * xh
    y = y.reshape(b, d_inner)
    y = rmsnorm(params["norm_scale"], y * F.silu(z.float()), eps=norm_eps)
    out = (y.to(x.dtype) @ params["out_proj"])[:, None, :]
    return out, {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc, "ssm": s_new}


def softplus_inverse_dt(u: torch.Tensor) -> torch.Tensor:
    """Mamba2's default dt bias from uniform ``u`` in [0, 1): softplus⁻¹ of
    dt = exp(u·(log 0.1 − log 0.001) + log 0.001), dt in [1e-3, 1e-1]."""
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    return dt0 + torch.log(-torch.expm1(-dt0))
