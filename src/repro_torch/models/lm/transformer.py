"""Decoder-only LM assembly: dense / MoE / hybrid (Jamba) / SSM (Mamba2).

The reference's ``repro/models/lm/transformer.py``. Layers are grouped into
repeated **units** (the smallest repeating pattern of layer roles), and each
role's parameters are stacked with a leading unit axis ``[U, ...]``, as in
the reference, so its parameter trees carry over leaf by leaf
(``models/api.py::params_from_numpy``). Unit patterns:

  dense LM            [(attn, dense)]                       U = L
  granite-moe         [(attn, moe)]                         U = L
  llama4 (interleave) [(attn, dense), (attn, moe)]          U = L/2
  jamba (1:7, moe/2)  8 roles: attn at offset 4, moe odd    U = L/8
  mamba2              [(mamba, none)]                       U = L

The reference scans over the units; here a Python loop indexes unit ``u`` of
every stacked leaf (a view). The decode cache keeps the reference's layout:
one entry per role, stacked ``[U, B, L, KV, hd]`` K/V (int8 with f32 scales
``[U, B, L, KV]`` under ``kv_cache_dtype="int8"``) or the Mamba state tree.
``decode_step`` writes it in place. VLM and enc-dec configs are refused (see
``block_roles``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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
from repro_torch.models.lm.mlp import mlp_apply, mlp_init
from repro_torch.models.lm.moe import moe_apply, moe_init
from repro_torch.models.lm.norm import make_norm

__all__ = [
    "TensorMaker",
    "ShapeMaker",
    "block_roles",
    "mixer_counts",
    "make_statics",
    "init_lm",
    "param_shapes",
    "forward",
    "prefill",
    "init_cache",
    "decode_step",
]

Role = Tuple[str, str]  # (mixer, ffn)

# Families of the reference's registry that the port does not serve yet, and
# the ROADMAP item (queue 1) that ports each.
_NOT_PORTED = {
    "vlm": "queue 1 item 9 (VLM: qwen2-vl, M-RoPE)",
    "encdec": "queue 1 item 10 (enc-dec: seamless)",
    "audio": "queue 1 item 10 (enc-dec: seamless)",
}


def block_roles(cfg: ModelConfig) -> List[Role]:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"ROADMAP {_NOT_PORTED[cfg.family]}"
        )
    if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
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


def make_statics(cfg: ModelConfig) -> AttnStatics:
    return AttnStatics(
        cfg.num_heads,
        cfg.num_kv_heads,
        cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps,
        use_rope=cfg.pos_embed == "rope",
    )


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
def _index(tree, u: int):
    """Unit ``u`` of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    return tree[u]


def _embed_in(cfg: ModelConfig, params: Dict, tokens: torch.Tensor):
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    x = params["embed"][tokens]
    b, s = tokens.shape
    positions = None
    if cfg.pos_embed == "rope":
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    elif cfg.pos_embed != "none":
        raise NotImplementedError(f"pos_embed {cfg.pos_embed!r} is not ported yet")
    return x, positions


def _lm_head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).float()


def _mamba_kw(cfg: ModelConfig) -> Dict:
    return dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state, heads=cfg.ssm_heads,
                headdim=cfg.ssm_headdim, norm_eps=cfg.norm_eps)


def _ffn(cfg: ModelConfig, ffn: str, p: Dict, x: torch.Tensor, norm_apply, aux: List):
    """The role's feed-forward with its residual; a MoE layer appends its aux
    loss to ``aux``."""
    if ffn == "none":
        return x
    h = norm_apply(p["norm_ffn"], x, eps=cfg.norm_eps)
    if ffn == "moe":
        h, a = moe_apply(p["moe"], h, num_experts=cfg.num_experts,
                         top_k=cfg.experts_per_token, kind=cfg.mlp,
                         capacity_factor=cfg.capacity_factor)
        aux.append(a)
        return x + h
    return x + mlp_apply(p["mlp"], h, cfg.mlp)


def _run(params: Dict, cfg: ModelConfig, tokens, cache: Optional[List[Dict]], aux: List):
    """Full-sequence pass; writes K/V and SSM states into ``cache`` when given
    and each MoE layer's aux loss into ``aux``."""
    roles = block_roles(cfg)
    st = make_statics(cfg)
    _, norm_apply = make_norm(cfg.norm)
    x, positions = _embed_in(cfg, params, tokens)
    s = x.shape[1]
    for u in range(_units(cfg)):
        for r, (role, stacked) in enumerate(zip(roles, params["units"])):
            mixer, ffn = role
            p = _index(stacked, u)
            h = norm_apply(p["norm_mixer"], x, eps=cfg.norm_eps)
            if mixer == "attn":
                h, k, v = attention(p["attn"], h, st, positions, return_kv=True)
                if cache is not None:
                    c = cache[r]
                    if "k_scale" in c:
                        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
                        c["k"][u, :, :s], c["v"][u, :, :s] = kq, vq
                        c["k_scale"][u, :, :s], c["v_scale"][u, :, :s] = ks, vs
                    else:
                        c["k"][u, :, :s], c["v"][u, :, :s] = k, v
            else:
                out = mamba_apply(p["mamba"], h, chunk=cfg.ssm_chunk,
                                  return_state=cache is not None, **_mamba_kw(cfg))
                if cache is not None:
                    h, state = out
                    for key, val in state.items():
                        cache[r][key][u] = val
                else:
                    h = out
            x = _ffn(cfg, ffn, p, x + h, norm_apply, aux)
    x = norm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    return _lm_head(cfg, params, x)


def forward(params: Dict, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over ``batch["tokens"]`` [B, S]. Returns
    (logits [B, S, Vp] f32, aux), aux being the MoE layers' summed
    load-balancing loss (0 without MoE layers)."""
    aux: List[torch.Tensor] = []
    logits = _run(params, cfg, batch["tokens"], None, aux)
    return logits, sum(aux, torch.zeros((), dtype=torch.float32, device=logits.device))


def prefill(params: Dict, cfg: ModelConfig, batch: Dict, max_len: int):
    """Process the prompt once: (logits [B, S, Vp] f32, cache, cache_len).

    One forward pass that also writes every layer's K/V (and SSM final
    state) into a decode cache of capacity ``max_len``; ``cache_len`` is the
    prompt length, a host int."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, device=params["embed"].device)
    return _run(params, cfg, tokens, cache, []), cache, s


# ------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device, dtype=None) -> List[Dict]:
    """Per-role stacked cache ([U, ...] leading axis), zeros."""
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


def decode_step(params: Dict, cfg: ModelConfig, batch: Dict, cache: List[Dict], cache_len: int):
    """One serving step for ``batch["tokens"]`` [B, 1]: returns (logits
    [B, Vp] f32, cache), the cache updated in place at ``cache_len``."""
    roles = block_roles(cfg)
    st = make_statics(cfg)
    _, norm_apply = make_norm(cfg.norm)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device).long()
    x = params["embed"][tokens]
    for u in range(_units(cfg)):
        for r, (role, stacked) in enumerate(zip(roles, params["units"])):
            mixer, ffn = role
            p = _index(stacked, u)
            c = _index(cache[r], u)
            h = norm_apply(p["norm_mixer"], x, eps=cfg.norm_eps)
            if mixer == "attn":
                scales = {k: c[k] for k in ("k_scale", "v_scale") if k in c}
                h = decode_attention(p["attn"], h, st, c["k"], c["v"], cache_len, **scales)[0]
            else:
                h, new = mamba_decode(p["mamba"], h, c, **_mamba_kw(cfg))
                for key, val in new.items():
                    c[key].copy_(val)
            x = _ffn(cfg, ffn, p, x + h, norm_apply, [])
    x = norm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    return _lm_head(cfg, params, x)[:, 0], cache
