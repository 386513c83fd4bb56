"""Mamba2 — SSD (state-space duality) blocks, chunked form + decode recurrence.

The reference's ``repro/models/lm/mamba.py``: gated x/z projection, causal
depthwise conv on (x, B, C), softplus-dt discretization with a scalar decay
per head (A), and the SSD chunked algorithm:

  * intra-chunk: the quadratic term ``((C Bᵀ) ∘ L) @ X·dt`` with
    ``L[i,j] = exp(Σ_{j<k≤i} a_k)``, through the SSD kernel's wrapper
    (``kernels/ssd_scan``): on a CUDA tensor it launches
    ``csrc/ssd_scan.cu``, on a CPU tensor it runs the plain version. Under
    grad its autograd Function's backward is ``csrc/ssd_scan_bwd.cu`` (the
    plain backward on the CPU). The reference computes the same term with
    einsums in the layer and differentiates them;
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

from repro_torch.distributed.sharding import _Gather, cache_layout, on_mesh
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


def _mixer(params: Dict, x: torch.Tensor, *, ssm_state: int, heads: int, headdim: int,
           chunk: int, norm_eps: float, return_state: bool, col=None, bc=None, norm=None,
           out=None):
    """The mixer over x [B, L, D] for ``heads`` heads (all of them, or this
    rank's under tensor parallelism). The hooks, identities on one device:
    ``col`` the input of the column-parallel projections (wx, wz, wdt),
    ``bc`` B and C after their conv (whole on every rank, read by its own
    heads), ``norm`` the gated RMSNorm, ``out`` ``out_proj``'s output."""
    b, l, _ = x.shape
    n, h, p = ssm_state, heads, headdim
    xin = x if col is None else col(x)
    z = xin @ params["wz"]
    ux, ub, uc = xin @ params["wx"], x @ params["wb"], x @ params["wc"]
    xc = _causal_conv(ux, params["conv_x"])
    bb = _causal_conv(ub, params["conv_b"]).float()
    cc = _causal_conv(uc, params["conv_c"]).float()
    if bc is not None:
        bb, cc = bc(bb), bc(cc)
    dt = xin @ params["wdt"]

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
    bc_ = bb.reshape(b, nc, q, n)
    cch = cc.reshape(b, nc, q, n)
    acum = torch.cumsum(adt.reshape(b, nc, q, h), dim=2)  # [B,nc,Q,H]

    # intra-chunk (diagonal block), in the kernel's layout [B,nc,H,Q,(P)]
    y_diag = ssd_ops.ssd_intra_chunk(
        cch, bc_, xdt.permute(0, 1, 3, 2, 4).contiguous(), acum.permute(0, 1, 3, 2).contiguous()
    ).permute(0, 1, 3, 2, 4)  # [B,nc,Q,H,P]

    # chunk-final states: S_c = Σ_j exp(acum_last - acum_j) B_j ⊗ xdt_j
    decay_states = torch.exp(acum[:, :, -1:, :] - acum)  # [B,nc,Q,H]
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc_, decay_states, xdt)

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
    y = y.reshape(b, lp, h * p)[:, :l]
    z = z[:, :l]
    g = y * F.silu(z.float())
    y = (rmsnorm if norm is None else norm)(params["norm_scale"], g, eps=norm_eps)
    o = y.to(x.dtype) @ params["out_proj"]
    if out is not None:
        o = out(o)
    if not return_state:
        return o
    # Decode-continuation state: the final SSM state and the last K-1 raw conv
    # inputs, front-padded with zeros when L < K-1.
    need = params["conv_x"]["w"].shape[0] - 1

    def tail(u):  # [B, L, C] -> [B, K-1, C]
        u = F.pad(u, (0, 0, max(0, need - u.shape[1]), 0))
        return u[:, u.shape[1] - need:].float()

    state = {"conv_x": tail(ux), "conv_b": tail(ub), "conv_c": tail(uc), "ssm": s}
    return o, state


def mamba_apply(params: Dict, x: torch.Tensor, *, d_inner: int, ssm_state: int, heads: int,
                headdim: int, chunk: int = 256, norm_eps: float = 1e-6,
                return_state: bool = False, policy=None):
    """x [B, L, D] -> [B, L, D] (and, with ``return_state``, the decode
    state). Under a mesh ``policy`` see ``_mamba_apply_sharded``."""
    kw = dict(ssm_state=ssm_state, headdim=headdim, chunk=chunk, norm_eps=norm_eps,
              return_state=return_state)
    if on_mesh(policy):
        return _mamba_apply_sharded(params, x, policy, d_inner=d_inner, heads=heads, **kw)
    return _mixer(params, x, heads=heads, **kw)


def mamba_state_init(batch: int, *, d_inner: int, ssm_state: int, heads: int, headdim: int,
                     device, conv: int = 4, dtype=torch.float32) -> Dict:
    """Decode state on ``device``: conv windows for (x, B, C) + the SSM state
    tensor."""
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


def _step(params: Dict, x: torch.Tensor, state: Dict, *, heads: int, headdim: int,
          norm_eps: float, norm=None, out=None):
    """One-token recurrence for x [B, 1, D] over ``heads`` heads (this
    rank's under tensor parallelism: ``norm`` and ``out`` as in ``_mixer``;
    the B/C windows whole)."""
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
    y = y.reshape(b, h * p)
    y = (rmsnorm if norm is None else norm)(params["norm_scale"], y * F.silu(z.float()),
                                            eps=norm_eps)
    o = y.to(x.dtype) @ params["out_proj"]
    if out is not None:
        o = out(o)
    return o[:, None, :], {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc, "ssm": s_new}


def mamba_decode(params: Dict, x: torch.Tensor, state: Dict, *, d_inner: int, ssm_state: int,
                 heads: int, headdim: int, norm_eps: float = 1e-6, policy=None):
    """One-token recurrence for x [B, 1, D]. Returns (y [B,1,D], new_state).
    Under a mesh ``policy`` see ``_mamba_decode_sharded``."""
    if on_mesh(policy):
        return _mamba_decode_sharded(params, x, state, policy, d_inner=d_inner,
                                     ssm_state=ssm_state, heads=heads, headdim=headdim,
                                     norm_eps=norm_eps)
    return _step(params, x, state, heads=heads, headdim=headdim, norm_eps=norm_eps)


# ------------------------------------------------------------- on a mesh
def _split_rmsnorm(total: int, psum):
    """RMSNorm over a last dim split over "model": the sum of squares of
    this rank's ``x.shape[-1]`` of ``total`` channels summed by ``psum``
    before the rsqrt (one norm over the whole ``d_inner``, as on one
    device; a per-shard norm would be a grouped norm)."""

    def norm(params: Dict, x: torch.Tensor, *, eps: float) -> torch.Tensor:
        x32 = x.float()
        var = psum(torch.sum(x32 * x32, dim=-1, keepdim=True)) / total
        return (x32 * torch.reciprocal(torch.sqrt(var + eps)) * params["scale"]).to(x.dtype)

    return norm


def _local_mixer(params: Dict, policy, *, d_inner: int, heads: int):
    """(params, this rank's heads, head-parallel). In ``tp`` with d_inner and
    the heads split over "model" (``param_shardings``' Mamba rules: wx, wz,
    conv_x, norm_scale by d_inner, out_proj row-parallel, wdt, A_log, D,
    dt_bias by head) each rank runs its own heads; otherwise every
    model-sharded leaf is gathered and the heads stay whole."""
    full = {("wx",): (-1, d_inner), ("wz",): (-1, d_inner), ("out_proj",): (0, d_inner),
            ("wdt",): (-1, heads), ("conv_x", "w"): (-1, d_inner), ("conv_x", "b"): (0, d_inner),
            ("A_log",): (0, heads), ("D",): (0, heads), ("dt_bias",): (0, heads),
            ("norm_scale", "scale"): (0, d_inner)}

    def leaf(p, path):
        for k in path:
            p = p[k]
        return p

    tp = policy.tp
    split = [leaf(params, path).shape[dim] * tp == n for path, (dim, n) in full.items()]
    if policy.mode == "tp" and all(split) and heads % tp == 0:
        return params, heads // tp, True
    p = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    for path, (dim, n) in full.items():
        t = leaf(p, path)
        if t.shape[dim] != n:
            t = policy.gather_model(t, dim % t.dim())
            if len(path) == 1:
                p[path[0]] = t
            else:
                p[path[0]][path[1]] = t
    return p, heads, False


def _state_specs(policy, hp: bool, heads: int, d_inner: int, ssm_state: int):
    """(the layout a rank's mixer state comes in, the cache's layout), per
    leaf, without the unit dim: batch as the compute layout; conv_x's
    channels and the SSM heads over "model" when head-parallel; B/C whole."""
    rows = policy.compute_spec()[0]
    mine = ("model",) if hp else ()
    src = {"conv_x": (rows, (), mine), "conv_b": (rows, (), ()), "conv_c": (rows, (), ()),
           "ssm": (rows, mine, (), ())}
    shapes = {"conv_x": (1, policy.batch, 1, d_inner), "conv_b": (1, policy.batch, 1, ssm_state),
              "conv_c": (1, policy.batch, 1, ssm_state), "ssm": (1, policy.batch, heads, 1, 1)}
    dst = {k: cache_layout(k, shape, policy.mesh, batch=policy.batch) for k, shape in shapes.items()}
    return src, dst


def _mamba_apply_sharded(params: Dict, x: torch.Tensor, policy, *, d_inner: int, heads: int,
                         ssm_state: int, headdim: int, chunk: int, norm_eps: float,
                         return_state: bool):
    """The mixer on a mesh. x [B', S', D] in the block's compute layout.

    Head-parallel (``tp``): the column-parallel projections read
    ``colpar(x)``; B and C are computed whole on every rank from the
    replicated wb, wc, conv_b, conv_c and read by the rank's heads only, so
    their gradient is summed over "model" (``colpar`` on each); the SSD, the
    chunk states and the recurrence run at H/tp heads; the gated RMSNorm
    sums its squares over "model"; ``out_proj`` is row-parallel. Otherwise
    (fsdp, or heads that do not split) the weights are whole and the mixer
    runs on the rank's rows; where the compute layout splits the sequence
    over "model", the sequence is gathered first (the conv window and the
    recurrence cross the split) and each rank keeps its own rows of the
    output, so its loss reaches every row it reads and the gradient of the
    gathered input is reduce-scattered. With ``return_state`` the state is
    returned in the cache's layout (``cache_spec``)."""
    p, h_loc, hp = _local_mixer(params, policy, d_inner=d_inner, heads=heads)
    hooks = {}
    if hp:
        hooks = dict(col=policy.colpar, bc=policy.colpar, out=policy.rowpar,
                     norm=_split_rmsnorm(d_inner, policy.psum_model))
    seq = "model" in policy.compute_spec()[1]
    if seq:
        x = _Gather.apply(x, policy.group("model"), 1, True)
    res = _mixer(p, x, ssm_state=ssm_state, heads=h_loc, headdim=headdim, chunk=chunk,
                 norm_eps=norm_eps, return_state=return_state, **hooks)
    o, state = res if return_state else (res, None)
    if seq:
        n = o.shape[1] // policy.tp
        o = o.narrow(1, policy._coord("model") * n, n)
    if not return_state:
        return o
    src, dst = _state_specs(policy, hp, heads, d_inner, ssm_state)
    with torch.no_grad():
        state = {k: policy.redistribute(v, src[k], dst[k]).contiguous() for k, v in state.items()}
    return o, state


@torch.no_grad()
def _mamba_decode_sharded(params: Dict, x: torch.Tensor, state: Dict, policy, *, d_inner: int,
                          ssm_state: int, heads: int, headdim: int, norm_eps: float):
    """One decode step on a mesh: x [B', 1, D] in the compute layout, the
    state in the cache's layout (``cache_spec``: batch over the data axes,
    the SSM heads and every conv window's channels over "model"). The state
    moves to the layout the step reads (the rank's heads and conv_x
    channels when head-parallel, else every head; the B/C windows whole),
    the step runs as ``_mamba_apply_sharded``'s, and the new state moves
    back to the cache's layout."""
    p, h_loc, hp = _local_mixer(params, policy, d_inner=d_inner, heads=heads)
    hooks = {}
    if hp:
        hooks = dict(out=policy.rowpar, norm=_split_rmsnorm(d_inner, policy.psum_model))
    read, cache = _state_specs(policy, hp, heads, d_inner, ssm_state)
    st = {k: policy.redistribute(v, cache[k], read[k]) for k, v in state.items()}
    o, new = _step(p, x, st, heads=h_loc, headdim=headdim, norm_eps=norm_eps, **hooks)
    return o, {k: policy.redistribute(v, read[k], cache[k]) for k, v in new.items()}


def softplus_inverse_dt(u: torch.Tensor) -> torch.Tensor:
    """Mamba2's default dt bias from uniform ``u`` in [0, 1): softplus⁻¹ of
    dt = exp(u·(log 0.1 − log 0.001) + log 0.001), dt in [1e-3, 1e-1]."""
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    return dt0 + torch.log(-torch.expm1(-dt0))
