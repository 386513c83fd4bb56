"""Decoder-only LM assembly: dense / VLM / MoE / hybrid (Jamba) / SSM (Mamba2).

The reference's ``repro/models/lm/transformer.py``. Layers are grouped into
repeated **units** (the smallest repeating pattern of layer roles), and each
role's parameters are stacked with a leading unit axis ``[U, ...]``, as in
the reference, so its parameter trees carry over leaf by leaf
(``models/api.py::params_from_numpy``). Unit patterns:

  dense LM, VLM       [(attn, dense)]                       U = L
  granite-moe         [(attn, moe)]                         U = L
  llama4 (interleave) [(attn, dense), (attn, moe)]          U = L/2
  jamba (1:7, moe/2)  8 roles: attn at offset 4, moe odd    U = L/8
  mamba2              [(mamba, none)]                       U = L

The reference scans over the units; here a Python loop indexes unit ``u`` of
every stacked leaf (a view). The decode cache keeps the reference's layout:
one entry per role, stacked ``[U, B, L, KV, hd]`` K/V (int8 with f32 scales
``[U, B, L, KV]`` under ``kv_cache_dtype="int8"``) or the Mamba state tree.
``decode_step`` writes it in place.

Batches carry ``tokens`` [B, S] or ``embeds`` [B, S, D] (a stubbed modality
frontend's output, cast to the model dtype), and M-RoPE configs may carry
``positions`` [3, B, S] (text positions otherwise). The enc-dec stack is
``encdec.py``; it reuses ``make_statics`` and ``sin_positions`` from here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (NO_POLICY, _map, cache_shardings, local_shape,
                                              on_mesh)
from repro_torch.models.lm.attention import (
    AttnStatics,
    attention,
    attn_init,
    decode_attention,
    quantize_kv,
)
from repro_torch.models.lm.mamba import (
    mamba_apply,
    mamba_decode,
    mamba_init,
    mamba_state_init,
    softplus_inverse_dt,
)
from repro_torch.models.lm.mlp import mlp_apply_sharded, mlp_init
from repro_torch.models.lm.moe import moe_apply, moe_init
from repro_torch.models.lm.norm import make_norm
from repro_torch.models.lm.rope import mrope_text_positions

__all__ = [
    "NO_POLICY",
    "TensorMaker",
    "ShapeMaker",
    "block_roles",
    "mixer_counts",
    "make_statics",
    "sin_positions",
    "init_lm",
    "param_shapes",
    "forward",
    "prefill",
    "init_cache",
    "decode_step",
]

Role = Tuple[str, str]  # (mixer, ffn)

# The token families of the reference's registry (``audio`` and ``encdec``
# configs have encoder layers and run ``encdec.py``).
TOKEN_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio", "encdec")


def block_roles(cfg: ModelConfig) -> List[Role]:
    if cfg.family not in TOKEN_FAMILIES:
        raise ValueError(f"{cfg.name}: {cfg.family!r} is not a token family")
    if cfg.is_hybrid:  # jamba: attn every `period`, MoE every `moe_period`
        roles = []
        for i in range(cfg.attn_layer_period):
            mixer = "attn" if i == cfg.attn_layer_offset else "mamba"
            ffn = ("moe" if cfg.is_moe and i % cfg.moe_layer_period == cfg.moe_layer_period - 1
                   else "dense")
            roles.append((mixer, ffn))
        return roles
    if cfg.is_ssm_only:
        return [("mamba", "none" if cfg.d_ff == 0 else "dense")]
    if cfg.is_moe and cfg.moe_layer_period > 1:
        return [("attn", "dense")] * (cfg.moe_layer_period - 1) + [("attn", "moe")]
    if cfg.is_moe:
        return [("attn", "moe")]
    return [("attn", "dense")]


def mixer_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Layers of each mixer (``attn``, ``mamba``) over the whole depth: a
    prefill runs the flash kernel once per ``attn`` layer and the SSD kernel
    once per ``mamba`` layer."""
    roles = block_roles(cfg)
    units = _units(cfg)
    return {m: units * sum(r[0] == m for r in roles) for m in ("attn", "mamba")}


def make_statics(cfg: ModelConfig, *, causal: bool = True) -> AttnStatics:
    return AttnStatics(
        cfg.num_heads,
        cfg.num_kv_heads,
        cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        mrope=cfg.pos_embed == "mrope",
        mrope_sections=cfg.mrope_sections,
        qk_norm=cfg.qk_norm,
        causal=causal,
        norm_eps=cfg.norm_eps,
        use_rope=cfg.pos_embed in ("rope", "mrope"),
    )


def sin_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """The reference's sinusoidal table at f32 ``positions`` [S]: [S, D] f32,
    sin of the first D/2 columns, cos of the rest (constant 9.21)."""
    half = d_model // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                     / half * 9.21)
    ang = positions[:, None] * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------- init
class TensorMaker:
    """Parameter maker for ``*_init``: random tensors from ``generator`` with
    a leading ``lead`` shape (the unit axis; the unit and expert axes for
    stacked experts), made on the generator's device and moved to
    ``device``."""

    def __init__(self, generator: torch.Generator, device, lead: Tuple[int, ...] = ()):
        self.gen, self.device, self.lead = generator, torch.device(device), tuple(lead)

    def stacked(self, n: int) -> "TensorMaker":
        """A maker of the same stream with one more leading axis of ``n``."""
        return TensorMaker(self.gen, self.device, self.lead + (n,))

    def _put(self, t: torch.Tensor, dtype) -> torch.Tensor:
        return t.to(device=self.device, dtype=dtype)

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        t = torch.randn(self.lead + tuple(shape), generator=self.gen, device=self.gen.device)
        return self._put(t.mul_(std), dtype)  # in place: one f32 draw at a time

    def zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(self.lead + tuple(shape), dtype=dtype, device=self.device)

    def ones(self, shape, dtype) -> torch.Tensor:
        return torch.ones(self.lead + tuple(shape), dtype=dtype, device=self.device)

    def dt_bias(self, shape) -> torch.Tensor:
        u = torch.rand(self.lead + tuple(shape), generator=self.gen, device=self.gen.device)
        return self._put(softplus_inverse_dt(u), torch.float32)


class ShapeMaker:
    """Parameter maker that gives each leaf's shape (a tuple) and allocates
    nothing: ``param_shapes`` runs the same ``*_init`` code through it."""

    def __init__(self, lead: Tuple[int, ...] = ()):
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "ShapeMaker":
        return ShapeMaker(self.lead + (n,))

    def normal(self, shape, std, dtype):
        return self.lead + tuple(shape)

    def zeros(self, shape, dtype):
        return self.lead + tuple(shape)

    ones = zeros

    def dt_bias(self, shape):
        return self.lead + tuple(shape)


def _init_role(cfg: ModelConfig, role: Role, make) -> Dict:
    norm_init, _ = make_norm(cfg.norm)
    mixer, ffn = role
    dt = _dtype(cfg)
    p: Dict = {"norm_mixer": norm_init(make, cfg.d_model)}
    if mixer == "attn":
        p["attn"] = attn_init(make, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                              qk_norm=cfg.qk_norm, dtype=dt)
    else:
        p["mamba"] = mamba_init(make, cfg.d_model, d_inner=cfg.d_inner,
                                ssm_state=cfg.ssm_state, heads=cfg.ssm_heads,
                                conv=cfg.ssm_conv, dtype=dt)
    if ffn != "none":
        p["norm_ffn"] = norm_init(make, cfg.d_model)
        if ffn == "moe":
            p["moe"] = moe_init(make, cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.mlp,
                                shared_expert=cfg.moe_shared_expert, dtype=dt)
        else:
            p["mlp"] = mlp_init(make, cfg.d_model, cfg.d_ff, cfg.mlp, bias=cfg.mlp_bias,
                                dtype=dt)
    return p


def _build(cfg: ModelConfig, make, make_units) -> Dict:
    roles = block_roles(cfg)
    norm_init, _ = make_norm(cfg.norm)
    vp, d, dt = cfg.padded_vocab(1), cfg.d_model, _dtype(cfg)
    params: Dict = {
        "embed": make.normal((vp, d), 0.02, dt),
        "final_norm": norm_init(make, d),
        "units": [_init_role(cfg, role, make_units) for role in roles],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = make.normal((d, vp), d**-0.5, dt)
    return params


def _units(cfg: ModelConfig) -> int:
    roles = block_roles(cfg)
    if cfg.num_layers % len(roles):
        raise ValueError(f"{cfg.num_layers} layers do not split into units of {len(roles)}")
    return cfg.num_layers // len(roles)


def param_shapes(cfg: ModelConfig) -> Dict:
    """The params tree with a shape tuple per leaf (the reference's tree)."""
    return _build(cfg, ShapeMaker(), ShapeMaker((_units(cfg),)))


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    """Random params for ``cfg`` from ``generator``, on ``device``: the
    reference's init rules (He-normal weights, embed · 0.02, ones/zeros for
    norms and biases, Mamba2's dt bias), not its random numbers."""
    units = _units(cfg)
    return _build(cfg, TensorMaker(generator, device), TensorMaker(generator, device, (units,)))


# ------------------------------------------------------------------ forward
def _unbind(tree, units: int) -> List:
    """Every unit of the stacked leaves: ``units`` trees of views. One
    ``torch.unbind`` a leaf, so under grad each stacked leaf's gradient is
    stacked once from the units' (indexing unit by unit would add a
    zero-filled full-size gradient per unit)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, units) for k, v in tree.items()}
        return [{k: per_key[k][u] for k in tree} for u in range(units)]
    return list(torch.unbind(tree, 0))


def _batch_shape(batch: Dict) -> Tuple[int, int]:
    """The global (B, S) of ``batch["tokens"]`` or ``batch["embeds"]``."""
    x = batch["embeds"] if "embeds" in batch else batch["tokens"]
    b, s = (x.shape if hasattr(x, "shape") else torch.as_tensor(x).shape)[:2]
    return int(b), int(s)


def _embed(cfg: ModelConfig, emb: torch.Tensor, batch: Dict, pol) -> torch.Tensor:
    """``batch["embeds"]`` [B, S, D] cast to the model dtype, else the
    embedding rows of ``batch["tokens"]`` [B, S]; on a mesh this rank's rows
    in the compute layout: its block of the embeds, or a vocab-parallel
    lookup (each rank its own rows, zero elsewhere, summed over "model")
    where the table ``emb`` is split."""
    if "embeds" in batch:
        x = torch.as_tensor(batch["embeds"], device=emb.device)
        return pol.take(x, pol.compute_spec()).to(_dtype(cfg))
    tok = torch.as_tensor(batch["tokens"], device=emb.device).long()
    tok = pol.take(tok, pol.compute_spec()[:2])
    n = emb.shape[0]
    if not on_mesh(pol) or n == cfg.padded_vocab(1):
        return emb[tok]
    local = tok - pol._coord("model") * n
    mine = (local >= 0) & (local < n)
    return pol.rowpar(emb[local.clamp(0, n - 1)] * mine[..., None].to(emb.dtype))


def _embed_in(cfg: ModelConfig, emb: torch.Tensor, batch: Dict, pol):
    """(x [B, S, D] in the residual layout, positions in the compute
    layout): positions [B, S] for RoPE, [3, B, S] for M-RoPE
    (``batch["positions"]`` when given, else text positions), None
    otherwise; a ``sin`` config adds the sinusoidal table to x."""
    x = _embed(cfg, emb, batch, pol)
    b, s = _batch_shape(batch)
    cs = pol.compute_spec()
    if cfg.pos_embed == "sin":
        pe = sin_positions(torch.arange(s, dtype=torch.float32, device=x.device), cfg.d_model)
        x = x + pol.take(pe, cs[1:2])[None].to(x.dtype)
    if cfg.pos_embed in ("rope", "mrope") and "positions" in batch:
        positions = torch.as_tensor(batch["positions"], device=x.device)
    elif cfg.pos_embed == "rope":
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    elif cfg.pos_embed == "mrope":
        positions = mrope_text_positions(b, s, device=x.device)
    elif cfg.pos_embed in ("sin", "none"):
        positions = None
    else:
        raise ValueError(f"unknown pos_embed {cfg.pos_embed!r}")
    if positions is not None:
        positions = pol.take(positions, cs[:2], first=positions.dim() - 2)
    return pol.res(x), positions


def _lm_head(cfg: ModelConfig, params: Dict, emb: torch.Tensor, x: torch.Tensor, pol):
    """Logits f32 of this rank's rows: column-parallel over the vocab where
    the head is split over "model"."""
    if cfg.tie_embeddings:
        w = emb.T
    else:
        w = pol.gather_params(params["lm_head"], "lm_head")
    split = on_mesh(pol) and w.shape[1] != cfg.padded_vocab(1)
    return pol.logits((pol.colpar(x) @ w if split else x @ w).float())


def _mamba_kw(cfg: ModelConfig) -> Dict:
    return dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state, heads=cfg.ssm_heads,
                headdim=cfg.ssm_headdim, norm_eps=cfg.norm_eps)


def _ffn(cfg: ModelConfig, ffn: str, p: Dict, x: torch.Tensor, norm_apply, aux: List, pol,
         res: bool = True) -> torch.Tensor:
    """The role's feed-forward with its residual; a MoE layer appends its aux
    loss to ``aux``. ``res``: ``x`` is in the residual layout (else, in
    decode, the compute layout)."""
    if ffn == "none":
        return x
    xin = pol.block_in(x) if res else x
    h = norm_apply(p["norm_ffn"], xin, eps=cfg.norm_eps)
    if ffn == "moe":
        h, a = moe_apply(p["moe"], h, num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
                         kind=cfg.mlp, capacity_factor=cfg.capacity_factor, policy=pol)
        aux.append(a)
    else:
        h = mlp_apply_sharded(p["mlp"], h, cfg.mlp, pol, tensor_parallel=on_mesh(pol)
                              and pol.mode == "tp" and cfg.d_ff % pol.tp == 0)
    return pol.res(xin + h) if res else xin + h


def _write_kv(c: Dict, u: int, k: torch.Tensor, v: torch.Tensor, pol) -> None:
    """This rank's positions of the prompt's K/V [B', S, KV, hd] into unit
    ``u`` of its cache (int8 with scales under ``kv_cache_dtype="int8"``)."""
    l_loc = c["k"].shape[2]
    lo = pol._coord("model") * l_loc
    n = max(0, min(l_loc, k.shape[1] - lo))
    k, v = k[:, lo:lo + n], v[:, lo:lo + n]
    if "k_scale" in c:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        c["k_scale"][u, :, :n], c["v_scale"][u, :, :n] = ks, vs
    c["k"][u, :, :n], c["v"][u, :, :n] = k, v


def _unit(cfg: ModelConfig, roles, st, norm_apply, unit_params: List[Dict], x: torch.Tensor,
          positions, cache: Optional[List[Dict]], u: int, aux: List, pol) -> torch.Tensor:
    """One unit's roles over ``x``; writes K/V and SSM states into unit ``u``
    of ``cache`` when given and each MoE layer's aux loss into ``aux``."""
    for r, role in enumerate(roles):
        mixer, ffn = role
        p = unit_params[r]
        xin = pol.block_in(x)
        h = norm_apply(p["norm_mixer"], xin, eps=cfg.norm_eps)
        if mixer == "attn":
            h, k, v = attention(p["attn"], h, st, positions, return_kv=True, policy=pol)
            if cache is not None:
                _write_kv(cache[r], u, k, v, pol)
        else:
            out = mamba_apply(p["mamba"], h, chunk=cfg.ssm_chunk,
                              return_state=cache is not None, policy=pol, **_mamba_kw(cfg))
            if cache is not None:
                h, state = out
                for key, val in state.items():
                    cache[r][key][u] = val
            else:
                h = out
        x = _ffn(cfg, ffn, p, pol.res(xin + h), norm_apply, aux, pol)
    return x


def _run(params: Dict, cfg: ModelConfig, batch: Dict, cache: Optional[List[Dict]], aux: List,
         policy):
    """Full-sequence pass; writes K/V and SSM states into ``cache`` when given
    and each MoE layer's aux loss into ``aux``. On a mesh each unit's FSDP
    leaves are gathered inside the unit.

    Under ``cfg.remat == "block"`` a training forward (grad on, no cache)
    runs each unit under ``torch.utils.checkpoint`` (non-reentrant), as the
    reference wraps its unit in ``jax.checkpoint``: the unit keeps only its
    input, and the backward runs its forward again (gathering its FSDP
    leaves again instead of keeping them). The recompute sees the same
    inputs: no role draws random numbers (and the checkpoint restores the
    RNG state regardless), positions come from the batch, and ``cache_len``
    is read only by decode, which never checkpoints; prefill neither. The
    unit returns its MoE aux losses one by one, so they are summed in the
    same order as without it (bitwise)."""
    pol = policy.bind(*_batch_shape(batch))
    roles = block_roles(cfg)
    st = make_statics(cfg)
    _, norm_apply = make_norm(cfg.norm)
    emb = pol.gather_params(params["embed"], "embed")
    x, positions = _embed_in(cfg, emb, batch, pol)
    units = _units(cfg)
    per_unit = [_unbind(stacked, units) for stacked in params["units"]]
    remat = cfg.remat == "block" and cache is None and torch.is_grad_enabled()
    for u in range(units):
        def body(x, u=u):
            unit_aux: List[torch.Tensor] = []
            up = [pol.gather_params(per_unit[r][u], "units", r, lead=1)
                  for r in range(len(roles))]
            y = _unit(cfg, roles, st, norm_apply, up, x, positions, cache, u, unit_aux, pol)
            return (y, *unit_aux)

        x, *unit_aux = checkpoint(body, x, use_reentrant=False) if remat else body(x)
        aux.extend(unit_aux)
    x = pol.block_in(x)
    x = norm_apply(pol.gather_params(params["final_norm"], "final_norm"), x, eps=cfg.norm_eps)
    return _lm_head(cfg, params, emb, x, pol)


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            policy=NO_POLICY) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over ``batch["tokens"]`` [B, S] or
    ``batch["embeds"]`` [B, S, D] (with optional M-RoPE ``positions``).
    Returns (logits [B, S, Vp] f32, aux), aux being the MoE layers' summed
    load-balancing loss (0 without MoE layers). Under a mesh ``policy``:
    the global batch, this rank's params; this rank's logits (the vocab over
    "model" in tp when the head is column-parallel)."""
    aux: List[torch.Tensor] = []
    logits = _run(params, cfg, batch, None, aux, policy)
    return logits, sum(aux, torch.zeros((), dtype=torch.float32, device=logits.device))


def prefill(params: Dict, cfg: ModelConfig, batch: Dict, max_len: int, *, policy=NO_POLICY):
    """Process the prompt once: (logits [B, S, Vp] f32, cache, cache_len).

    One forward pass that also writes every layer's K/V (and SSM final
    state) into a decode cache of capacity ``max_len``; ``cache_len`` is the
    prompt length, a host int. Under a mesh ``policy`` the cache is this
    rank's shard (``cache_shardings``: its batch rows, its positions of a
    capacity rounded up to a multiple of the model axis)."""
    b, s = _batch_shape(batch)
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, device=params["embed"].device, policy=policy)
    return _run(params, cfg, batch, cache, [], policy), cache, s


# ------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device, dtype=None,
               policy=NO_POLICY) -> List[Dict]:
    """Per-role stacked cache ([U, ...] leading axis), zeros. Under a mesh
    ``policy``: this rank's shard of a cache for the global ``batch``, each
    leaf at its local shape by ``cache_shardings`` (K/V and int8 scales L/tp
    positions of a capacity rounded up to a multiple of the model axis; the
    Mamba states H/tp heads and C/tp channels of each conv window)."""
    if on_mesh(policy):
        mesh = policy.mesh
        length = -(-max_len // policy.tp) * policy.tp
        shapes = init_cache(cfg, batch, length, device="meta", dtype=dtype)
        return _map(lambda _, leaf, pl: torch.zeros(local_shape(leaf.shape, pl, mesh),
                                                    dtype=leaf.dtype, device=device),
                    shapes, cache_shardings(cfg, shapes, mesh, batch=batch))
    units = _units(cfg)
    dt = dtype or _dtype(cfg)
    int8kv = cfg.kv_cache_dtype == "int8"
    cache = []
    for mixer, _ in block_roles(cfg):
        if mixer == "attn":
            shape = (units, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            kdt = torch.int8 if int8kv else dt
            entry = {"k": torch.zeros(shape, dtype=kdt, device=device),
                     "v": torch.zeros(shape, dtype=kdt, device=device)}
            if int8kv:
                entry["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                entry["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        else:
            one = mamba_state_init(batch, d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                                   heads=cfg.ssm_heads, headdim=cfg.ssm_headdim,
                                   conv=cfg.ssm_conv, device=device)
            entry = {k: v[None].repeat((units,) + (1,) * v.dim()) for k, v in one.items()}
        cache.append(entry)
    return cache


def decode_step(params: Dict, cfg: ModelConfig, batch: Dict, cache: List[Dict], cache_len: int,
                *, policy=NO_POLICY):
    """One serving step for ``batch["tokens"]`` [B, 1] or ``batch["embeds"]``
    [B, 1, D]: returns (logits [B, Vp] f32, cache), the cache updated in
    place at ``cache_len`` (also the position of every M-RoPE stream). Under
    a mesh ``policy``: the global tokens, this rank's params and cache (from
    ``prefill`` or ``init_cache`` under the policy), this rank's logits."""
    pol = policy.bind(_batch_shape(batch)[0], 1)
    roles = block_roles(cfg)
    st = make_statics(cfg)
    _, norm_apply = make_norm(cfg.norm)
    emb = pol.gather_params(params["embed"], "embed")
    x = _embed(cfg, emb, batch, pol)
    units = _units(cfg)
    per_unit = [_unbind(stacked, units) for stacked in params["units"]]
    per_cache = [_unbind(c, units) for c in cache]
    for u in range(units):
        for r, role in enumerate(roles):
            mixer, ffn = role
            p = pol.gather_params(per_unit[r][u], "units", r, lead=1)
            c = per_cache[r][u]
            h = norm_apply(p["norm_mixer"], x, eps=cfg.norm_eps)
            if mixer == "attn":
                scales = {k: c[k] for k in ("k_scale", "v_scale") if k in c}
                h = decode_attention(p["attn"], h, st, c["k"], c["v"], cache_len, policy=pol,
                                     **scales)[0]
            else:
                h, new = mamba_decode(p["mamba"], h, c, policy=pol, **_mamba_kw(cfg))
                for key, val in new.items():
                    c[key].copy_(val)
            # the residual stream stays in the compute layout: no sequence to split
            x = _ffn(cfg, ffn, p, x + h, norm_apply, [], pol, res=False)
    x = norm_apply(pol.gather_params(params["final_norm"], "final_norm"), x, eps=cfg.norm_eps)
    return _lm_head(cfg, params, emb, x, pol)[:, 0], cache
