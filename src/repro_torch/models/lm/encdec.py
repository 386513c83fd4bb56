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

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm.attention import attention, attn_init, decode_attention, project_kv
from repro_torch.models.lm.mlp import mlp_apply, mlp_init
from repro_torch.models.lm.norm import make_norm
from repro_torch.models.lm.transformer import (
    ShapeMaker,
    TensorMaker,
    _dtype,
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


def encode(params: Dict, cfg: ModelConfig, src_embeds) -> torch.Tensor:
    """Bidirectional encoder over precomputed frontend embeddings
    [B, S_src, D] (cast to the model dtype): [B, S_src, D]."""
    _, norm_apply = make_norm(cfg.norm)
    st = make_statics(cfg, causal=False)
    x = torch.as_tensor(src_embeds, device=params["embed"].device).to(_dtype(cfg))
    x = _sin_pos(x, cfg.d_model)
    for p in _unbind(params["encoder"], cfg.encoder_layers):
        h = norm_apply(p["norm_attn"], x, eps=cfg.norm_eps)
        x = x + attention(p["attn"], h, st)
        h = norm_apply(p["norm_ffn"], x, eps=cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp)
    return norm_apply(params["enc_norm"], x, eps=cfg.norm_eps)


def _decoder(params: Dict, cfg: ModelConfig, tgt_tokens,
             cross_kv: Callable[[int, Dict], Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """The teacher-forced decoder over ``tgt_tokens`` [B, T]: logits
    [B, T, Vp] f32; ``cross_kv(u, p)`` gives layer ``u``'s cross K/V."""
    _, norm_apply = make_norm(cfg.norm)
    st_self = make_statics(cfg, causal=True)
    st_cross = make_statics(cfg, causal=False)
    tokens = torch.as_tensor(tgt_tokens, device=params["embed"].device).long()
    x = _sin_pos(params["embed"][tokens], cfg.d_model)
    for u, p in enumerate(_unbind(params["decoder"], cfg.num_layers)):
        h = norm_apply(p["norm_attn"], x, eps=cfg.norm_eps)
        x = x + attention(p["attn"], h, st_self)
        h = norm_apply(p["norm_cross"], x, eps=cfg.norm_eps)
        x = x + attention(p["cross"], h, st_cross, kv=cross_kv(u, p))
        h = norm_apply(p["norm_ffn"], x, eps=cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp)
    x = norm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    return (x @ params["lm_head"]).float()


def forward_encdec(params: Dict, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward; batch: ``src_embeds`` [B, S_src, D],
    ``tgt_tokens`` [B, T]. Returns (logits [B, T, Vp] f32, aux 0)."""
    enc = encode(params, cfg, batch["src_embeds"])
    st_cross = make_statics(cfg, causal=False)
    logits = _decoder(params, cfg, batch["tgt_tokens"],
                      lambda u, p: project_kv(p["cross"], enc, st_cross))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_decoder_cache(params: Dict, cfg: ModelConfig, enc: torch.Tensor, max_len: int) -> Dict:
    """Self-attention K/V (zeros, [L, B, max_len, KV, hd]) and the cross K/V
    ``[L, B, S_src, KV, hd]`` projected from the encoder's output."""
    b = enc.shape[0]
    st_cross = make_statics(cfg, causal=False)
    kvs = [project_kv(p, enc, st_cross)
           for p in _unbind(params["decoder"]["cross"], cfg.num_layers)]
    shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=enc.device),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=enc.device),
        "cross_k": torch.stack([k for k, _ in kvs]),
        "cross_v": torch.stack([v for _, v in kvs]),
    }


def prefill(params: Dict, cfg: ModelConfig, batch: Dict, max_len: int):
    """The reference's enc-dec ``model_prefill``: (the teacher-forced logits
    [B, T, Vp], ``init_decoder_cache`` of the encoder's output, T). The
    encoder runs once and the decoder reads the cache's cross K/V, where the
    reference encodes twice; the outputs are the same."""
    t = batch["tgt_tokens"].shape[1]
    if t > max_len:
        raise ValueError(f"target prefix of {t} tokens exceeds max_len {max_len}")
    enc = encode(params, cfg, batch["src_embeds"])
    cache = init_decoder_cache(params, cfg, enc, max_len)
    del enc
    logits = _decoder(params, cfg, batch["tgt_tokens"],
                      lambda u, p: (cache["cross_k"][u], cache["cross_v"][u]))
    return logits, cache, t


def decode_step_encdec(params: Dict, cfg: ModelConfig, tokens, cache: Dict, cache_len: int):
    """One decoder step for ``tokens`` [B, 1] at position ``cache_len``:
    (logits [B, Vp] f32, cache), the self-attention K/V written in place."""
    _, norm_apply = make_norm(cfg.norm)
    st_self = make_statics(cfg, causal=True)
    st_cross = make_statics(cfg, causal=False)
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    x = _sin_pos(params["embed"][tokens], cfg.d_model, start=cache_len)
    for u, p in enumerate(_unbind(params["decoder"], cfg.num_layers)):
        h = norm_apply(p["norm_attn"], x, eps=cfg.norm_eps)
        x = x + decode_attention(p["attn"], h, st_self, cache["k"][u], cache["v"][u],
                                 cache_len)[0]
        h = norm_apply(p["norm_cross"], x, eps=cfg.norm_eps)
        x = x + attention(p["cross"], h, st_cross, kv=(cache["cross_k"][u], cache["cross_v"][u]))
        h = norm_apply(p["norm_ffn"], x, eps=cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp)
    x = norm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    return (x @ params["lm_head"]).float()[:, 0], cache
