"""Encoder-decoder backbone (Seamless-M4T medium's transformer core).

The reference's ``repro/models/lm/encdec.py``. Encoder: bidirectional
attention units. Decoder: causal self-attention + cross-attention over the
encoder's output + FFN. The speech/text modality frontend is a stub, as in
the reference: ``src_embeds`` [B, S_src, D] arrive precomputed (frame
embeddings); the decoder consumes token ids.

Both stacks keep the reference's parameter tree, each unit's leaves stacked
``[U, ...]`` (``encoder``: U = ``encoder_layers``, ``decoder``: U =
``num_layers``), so ``models/api.py::params_from_numpy`` carries it over leaf
by leaf; a Python loop indexes unit ``u`` (a view). Every full-sequence
attention runs the flash kernel's wrapper: the decoder's self-attention
causal, the encoder and the cross-attention unmasked. Cross-attention K/V
are projected once from the encoder's output and reused across decode steps
(the cache's ``cross_k``/``cross_v``).

As in the reference, ``prefill`` returns a decoder cache whose self-attention
K/V are zeros with ``cache_len`` = the target length: a decode step after it
attends to those zero rows (the reference's ``model_prefill``); decoding from
``model_init_cache`` at ``cache_len = 0`` reproduces the teacher-forced
forward.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NO_POLICY, cache_layout, on_mesh
from repro_torch.models.lm.attention import (
    attention,
    attn_init,
    cross_decode_attention,
    decode_attention,
    project_kv,
    project_kv_sharded,
)
from repro_torch.models.lm.mlp import mlp_init
from repro_torch.models.lm.norm import make_norm
from repro_torch.models.lm.transformer import (
    ShapeMaker,
    TensorMaker,
    _dtype,
    _embed,
    _embed_in,
    _ffn,
    _lm_head,
    _unbind,
    make_statics,
    sin_positions,
)

__all__ = [
    "init_encdec",
    "param_shapes",
    "encode",
    "forward_encdec",
    "prefill",
    "init_decoder_cache",
    "decode_step_encdec",
]


def _sin_pos(x: torch.Tensor, d_model: int, start: int = 0) -> torch.Tensor:
    """x [B, S, D] plus the sinusoidal table of positions start .. start + S - 1."""
    pos = torch.arange(start, start + x.shape[1], dtype=torch.float32, device=x.device)
    return x + sin_positions(pos, d_model)[None].to(x.dtype)


def _init_unit(cfg: ModelConfig, make, *, cross: bool) -> Dict:
    norm_init, _ = make_norm(cfg.norm)
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def attn():
        return attn_init(make, d, cfg.num_heads, cfg.num_kv_heads, hd,
                         qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, dtype=dt)

    p = {
        "norm_attn": norm_init(make, d),
        "attn": attn(),
        "norm_ffn": norm_init(make, d),
        "mlp": mlp_init(make, d, cfg.d_ff, cfg.mlp, bias=cfg.mlp_bias, dtype=dt),
    }
    if cross:
        p["norm_cross"] = norm_init(make, d)
        p["cross"] = attn()
    return p


def _build(cfg: ModelConfig, make, make_enc, make_dec) -> Dict:
    if cfg.encoder_layers <= 0:
        raise ValueError(f"{cfg.name} has no encoder layers")
    norm_init, _ = make_norm(cfg.norm)
    vp, d, dt = cfg.padded_vocab(1), cfg.d_model, _dtype(cfg)
    return {
        "embed": make.normal((vp, d), 0.02, dt),
        "lm_head": make.normal((d, vp), d**-0.5, dt),
        "encoder": _init_unit(cfg, make_enc, cross=False),
        "decoder": _init_unit(cfg, make_dec, cross=True),
        "enc_norm": norm_init(make, d),
        "final_norm": norm_init(make, d),
    }


def param_shapes(cfg: ModelConfig) -> Dict:
    """The params tree with a shape tuple per leaf (the reference's tree)."""
    return _build(cfg, ShapeMaker(), ShapeMaker((cfg.encoder_layers,)),
                  ShapeMaker((cfg.num_layers,)))


def init_encdec(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    """Random params for ``cfg`` from ``generator``, on ``device``: the
    reference's init rules, not its random numbers."""
    return _build(cfg, TensorMaker(generator, device),
                  TensorMaker(generator, device, (cfg.encoder_layers,)),
                  TensorMaker(generator, device, (cfg.num_layers,)))


def _pol(policy, b: int, s: int):
    return (policy or NO_POLICY).bind(b, s)


def _attn_unit(cfg: ModelConfig, p: Dict, x: torch.Tensor, norm_apply, st, pol, *,
               norm: str = "norm_attn", attn: str = "attn", kv=None, kv_spec=None):
    """x + attention over norm(x), in the residual layout."""
    xin = pol.block_in(x)
    h = norm_apply(p[norm], xin, eps=cfg.norm_eps)
    return pol.res(xin + attention(p[attn], h, st, kv=kv, policy=pol, kv_spec=kv_spec))


def encode(params: Dict, cfg: ModelConfig, src_embeds, *, policy=NO_POLICY) -> torch.Tensor:
    """Bidirectional encoder over precomputed frontend embeddings
    [B, S_src, D] (cast to the model dtype): [B, S_src, D]. Under a mesh
    ``policy``: the global embeds, this rank's params; its rows in the
    compute layout of (B, S_src)."""
    _, norm_apply = make_norm(cfg.norm)
    st = make_statics(cfg, causal=False)
    x = torch.as_tensor(src_embeds, device=params["embed"].device)
    pol = _pol(policy, *x.shape[:2])
    x, _ = _embed_in(cfg, params["embed"], {"embeds": x}, pol)
    for p in _unbind(params["encoder"], cfg.encoder_layers):
        p = pol.gather_params(p, "encoder", lead=1)
        x = _attn_unit(cfg, p, x, norm_apply, st, pol)
        x = _ffn(cfg, "dense", p, x, norm_apply, [], pol)
    x = pol.block_in(x)
    return norm_apply(pol.gather_params(params["enc_norm"], "enc_norm"), x, eps=cfg.norm_eps)


def _decoder(params: Dict, cfg: ModelConfig, tgt_tokens, cross_kv: Callable, policy=NO_POLICY):
    """The teacher-forced decoder over ``tgt_tokens`` [B, T]: logits
    [B, T, Vp] f32; ``cross_kv(u, p, pol)`` gives layer ``u``'s cross K/V
    and their layout (None on one device)."""
    _, norm_apply = make_norm(cfg.norm)
    st_self = make_statics(cfg, causal=True)
    st_cross = make_statics(cfg, causal=False)
    tokens = torch.as_tensor(tgt_tokens, device=params["embed"].device).long()
    pol = _pol(policy, *tokens.shape)
    emb = pol.gather_params(params["embed"], "embed")
    x, _ = _embed_in(cfg, emb, {"tokens": tokens}, pol)
    for u, p in enumerate(_unbind(params["decoder"], cfg.num_layers)):
        p = pol.gather_params(p, "decoder", lead=1)
        x = _attn_unit(cfg, p, x, norm_apply, st_self, pol)
        k, v, spec = cross_kv(u, p, pol)
        x = _attn_unit(cfg, p, x, norm_apply, st_cross, pol, norm="norm_cross", attn="cross",
                       kv=(k, v), kv_spec=spec)
        x = _ffn(cfg, "dense", p, x, norm_apply, [], pol)
    x = pol.block_in(x)
    x = norm_apply(pol.gather_params(params["final_norm"], "final_norm"), x, eps=cfg.norm_eps)
    return _lm_head(cfg, params, emb, x, pol)


def _project(p: Dict, enc: torch.Tensor, st, pol, enc_pol):
    """A decoder layer's cross K/V from the encoder's output and their
    layout (``enc_pol``: the policy bound to the encoder's shape)."""
    if not on_mesh(pol):
        return (*project_kv(p["cross"], enc, st), None)
    return project_kv_sharded(p["cross"], enc, st, enc_pol)


def forward_encdec(params: Dict, cfg: ModelConfig, batch: Dict, *,
                   policy=NO_POLICY) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward; batch: ``src_embeds`` [B, S_src, D],
    ``tgt_tokens`` [B, T]. Returns (logits [B, T, Vp] f32, aux 0). Under a
    mesh ``policy``: the global batch, this rank's params and logits (the
    vocab over "model" in tp)."""
    enc = encode(params, cfg, batch["src_embeds"], policy=policy)
    st_cross = make_statics(cfg, causal=False)
    enc_pol = _pol(policy, *torch.as_tensor(batch["src_embeds"]).shape[:2])
    logits = _decoder(params, cfg, batch["tgt_tokens"],
                      lambda u, p, pol: _project(p, enc, st_cross, pol, enc_pol), policy)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_decoder_cache(params: Dict, cfg: ModelConfig, enc: torch.Tensor, max_len: int, *,
                       policy=NO_POLICY, batch: Optional[int] = None,
                       src_len: Optional[int] = None) -> Dict:
    """Self-attention K/V (zeros, [L, B, max_len, KV, hd]) and the cross K/V
    ``[L, B, S_src, KV, hd]`` projected from the encoder's output. Under a
    mesh ``policy`` (``enc`` in the encoder's compute layout of the global
    ``batch`` x ``src_len``): this rank's shard by ``cache_shardings``, the
    self K/V at L/tp positions of a capacity rounded up to a multiple of the
    model axis, the cross K/V at S_src/tp encoder positions, every head."""
    st_cross = make_statics(cfg, causal=False)
    units = _unbind(params["decoder"], cfg.num_layers)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if not on_mesh(policy):
        b = enc.shape[0]
        kvs = [project_kv(p["cross"], enc, st_cross) for p in units]
        shape = (cfg.num_layers, b, max_len, kv, hd)
        return {
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=enc.device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=enc.device),
            "cross_k": torch.stack([k for k, _ in kvs]),
            "cross_v": torch.stack([v for _, v in kvs]),
        }
    mesh = policy.mesh
    enc_pol = policy.bind(batch, src_len)
    length = -(-max_len // policy.tp) * policy.tp
    self_shape = (cfg.num_layers, batch, length, kv, hd)
    cross_shape = (cfg.num_layers, batch, src_len, kv, hd)
    spec = {k: cache_layout(k, shape, mesh, batch=batch)
            for k, shape in (("k", self_shape), ("cross_k", cross_shape))}
    zeros = torch.zeros(self_shape[:1] + enc_pol.take(torch.empty(self_shape[1:], device="meta"),
                                                      spec["k"]).shape,
                        dtype=_dtype(cfg), device=enc.device)
    ks, vs = [], []
    with torch.no_grad():
        for p in units:
            p = enc_pol.gather_params(p, "decoder", lead=1)
            k, v, src = project_kv_sharded(p["cross"], enc, st_cross, enc_pol)
            ks.append(enc_pol.redistribute(k, src, spec["cross_k"]))
            vs.append(enc_pol.redistribute(v, src, spec["cross_k"]))
    return {"k": zeros, "v": zeros.clone(), "cross_k": torch.stack(ks).contiguous(),
            "cross_v": torch.stack(vs).contiguous()}


def prefill(params: Dict, cfg: ModelConfig, batch: Dict, max_len: int, *, policy=NO_POLICY):
    """The reference's enc-dec ``model_prefill``: (the teacher-forced logits
    [B, T, Vp], ``init_decoder_cache`` of the encoder's output, T). The
    encoder runs once and the decoder reads the cache's cross K/V, where the
    reference encodes twice; the outputs are the same. Under a mesh
    ``policy`` the decoder's cross-attention gathers the cache's encoder
    positions."""
    t = batch["tgt_tokens"].shape[1]
    if t > max_len:
        raise ValueError(f"target prefix of {t} tokens exceeds max_len {max_len}")
    b, s_src = torch.as_tensor(batch["src_embeds"]).shape[:2]
    enc = encode(params, cfg, batch["src_embeds"], policy=policy)
    cache = init_decoder_cache(params, cfg, enc, max_len, policy=policy, batch=b, src_len=s_src)
    del enc
    spec = None
    if on_mesh(policy):
        spec = cache_layout("cross_k", (1, b, s_src, 1, 1), policy.mesh, batch=b)
    logits = _decoder(params, cfg, batch["tgt_tokens"],
                      lambda u, p, pol: (cache["cross_k"][u], cache["cross_v"][u], spec), policy)
    return logits, cache, t


def decode_step_encdec(params: Dict, cfg: ModelConfig, tokens, cache: Dict, cache_len: int, *,
                       policy=NO_POLICY):
    """One decoder step for ``tokens`` [B, 1] at position ``cache_len``:
    (logits [B, Vp] f32, cache), the self-attention K/V written in place.
    Under a mesh ``policy``: the global tokens, this rank's params and cache
    shard; the self-attention over the cache's position shards, the
    cross-attention over the cross cache's encoder-position shards."""
    _, norm_apply = make_norm(cfg.norm)
    st_self = make_statics(cfg, causal=True)
    st_cross = make_statics(cfg, causal=False)
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    pol = _pol(policy, tokens.shape[0], 1)
    emb = pol.gather_params(params["embed"], "embed")
    x = _embed(cfg, emb, {"tokens": tokens}, pol)
    x = _sin_pos(x, cfg.d_model, start=cache_len)
    for u, p in enumerate(_unbind(params["decoder"], cfg.num_layers)):
        p = pol.gather_params(p, "decoder", lead=1)
        h = norm_apply(p["norm_attn"], x, eps=cfg.norm_eps)
        x = x + decode_attention(p["attn"], h, st_self, cache["k"][u], cache["v"][u],
                                 cache_len, policy=pol)[0]
        h = norm_apply(p["norm_cross"], x, eps=cfg.norm_eps)
        if on_mesh(pol):
            x = x + cross_decode_attention(p["cross"], h, st_cross, cache["cross_k"][u],
                                           cache["cross_v"][u], pol)
        else:
            x = x + attention(p["cross"], h, st_cross,
                              kv=(cache["cross_k"][u], cache["cross_v"][u]))
        x = _ffn(cfg, "dense", p, x, norm_apply, [], pol, res=False)
    x = norm_apply(pol.gather_params(params["final_norm"], "final_norm"), x, eps=cfg.norm_eps)
    return _lm_head(cfg, params, emb, x, pol)[:, 0], cache
