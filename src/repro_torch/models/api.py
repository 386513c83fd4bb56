"""Family-agnostic model API: init / forward / prefill / decode by config.

The reference's ``repro/models/api.py``, dispatched on ``cfg.family``:

  * the decoder-only token families (``dense``, ``moe``, ``hybrid``,
    ``ssm``, ``vlm``) route to the LM stack (``models/lm/transformer.py``);
    batches carry ``tokens`` [B, S] or ``embeds`` [B, S, D] (and M-RoPE
    ``positions`` [3, B, S]); ``model_forward`` returns (logits, aux), aux
    being the MoE layers' summed load-balancing loss;
  * a config with ``encoder_layers > 0`` (``audio``: Seamless) routes to
    ``models/lm/encdec.py``; batches carry ``src_embeds`` [B, S_src, D] and
    ``tgt_tokens`` [B, T], decode steps ``tokens`` [B, 1];
  * ``family="gnn"`` routes to the arch registry in ``models/gnn/api.py``;
    batches carry ``graph`` + ``features``. GNN inference has no token
    cache, so prefill/decode reject GNN configs.

``loss_fn`` is the training objective: token cross-entropy plus the MoE
aux loss.

``params_from_numpy`` carries the reference's params (numpy leaves)
into the port, for either family, each leaf in its own dtype (a MoE
router stays f32 in a bf16 model).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import NO_POLICY, VocabParallelNLL, all_reduce, on_mesh
from repro_torch.models.gnn import api as gnn_api
from repro_torch.models.lm import encdec, transformer

__all__ = [
    "model_init",
    "model_forward",
    "model_prefill",
    "model_init_cache",
    "model_decode_step",
    "param_shapes",
    "params_from_numpy",
    "params_to",
    "loss_fn",
]


def _is_gnn(cfg: ModelConfig) -> bool:
    return cfg.family == "gnn"


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def _no_token_cache(cfg: ModelConfig, entry: str):
    raise TypeError(
        f"{entry} is undefined for family='gnn' ({cfg.name}): GNN inference "
        "has no token cache; use model_forward with {'graph', 'features'} or "
        "serve.gnn_engine.GNNServeEngine for cached-plan serving"
    )


def model_init(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
               device="cuda"):
    """Random params for ``cfg`` on ``device`` from ``generator`` (seed 0 on
    ``device`` when omitted)."""
    dev = resolve_device(device)
    if _is_gnn(cfg):
        return gnn_api.gnn_init(cfg, generator, device=dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    if _is_encdec(cfg):
        return encdec.init_encdec(cfg, gen, dev)
    return transformer.init_lm(cfg, gen, dev)


def model_forward(params, cfg: ModelConfig, batch: Dict, *, policy=NO_POLICY):
    """(logits, aux). Under a mesh ``policy`` (``distributed/sharding.py``):
    the global batch and this rank's params in, this rank's logits out."""
    if _is_gnn(cfg):
        return gnn_api.gnn_forward(params, cfg, batch)
    if _is_encdec(cfg):
        return encdec.forward_encdec(params, cfg, batch, policy=policy)
    return transformer.forward(params, cfg, batch, policy=policy)


def model_prefill(params, cfg: ModelConfig, batch: Dict, max_len: int, *, policy=NO_POLICY):
    """(logits, cache, cache_len). Enc-dec, as the reference: the
    teacher-forced logits, a cache with zero self-attention K/V and the
    encoder's cross K/V, and the target length."""
    if _is_gnn(cfg):
        _no_token_cache(cfg, "model_prefill")
    if _is_encdec(cfg):
        return encdec.prefill(params, cfg, batch, max_len, policy=policy)
    return transformer.prefill(params, cfg, batch, max_len, policy=policy)


def model_init_cache(cfg: ModelConfig, params, batch: Dict, max_len: int, *, policy=NO_POLICY):
    """Empty decode cache for the batch's size (``tokens`` or ``embeds``);
    enc-dec runs the encoder over ``src_embeds`` for the cross K/V. Under a
    mesh ``policy``: this rank's shard."""
    if _is_gnn(cfg):
        _no_token_cache(cfg, "model_init_cache")
    if _is_encdec(cfg):
        enc = encdec.encode(params, cfg, batch["src_embeds"], policy=policy)
        b, s = torch.as_tensor(batch["src_embeds"]).shape[:2]
        return encdec.init_decoder_cache(params, cfg, enc, max_len, policy=policy, batch=b,
                                         src_len=s)
    b = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]
    return transformer.init_cache(cfg, b, max_len, device=params["embed"].device, policy=policy)


def model_decode_step(params, cfg: ModelConfig, batch: Dict, cache, cache_len: int, *,
                      policy=NO_POLICY):
    if _is_gnn(cfg):
        _no_token_cache(cfg, "model_decode_step")
    if _is_encdec(cfg):
        return encdec.decode_step_encdec(params, cfg, batch["tokens"], cache, cache_len,
                                         policy=policy)
    return transformer.decode_step(params, cfg, batch, cache, cache_len, policy=policy)


def param_shapes(cfg: ModelConfig):
    """The params tree of ``cfg`` with a shape tuple per leaf."""
    if _is_gnn(cfg):
        return gnn_api.get_arch(cfg.gnn_arch).param_shapes(cfg)
    if _is_encdec(cfg):
        return encdec.param_shapes(cfg)
    return transformer.param_shapes(cfg)


def _leaf(arr, dev: torch.device) -> torch.Tensor:
    """One numpy leaf as a tensor of the same dtype. A bf16 leaf (numpy's
    ``ml_dtypes`` bfloat16, as a JAX array converts) is reinterpreted bit for
    bit through int16, never routed through f32."""
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, fn) for v in node]
    return fn(node)


def params_from_numpy(cfg: ModelConfig, tree, *, device="cuda"):
    """The reference's params (the same tree with numpy leaves) on ``device``,
    checked against ``param_shapes(cfg)``. GNN trees become f32 (the GNN
    API's own ``params_from_numpy``); LM trees keep each leaf's dtype."""
    if _is_gnn(cfg):
        return gnn_api.params_from_numpy(cfg, tree, device=device)
    dev = resolve_device(device)
    params = _tree(tree, lambda a: _leaf(a, dev))
    got = _tree(params, lambda t: tuple(t.shape))
    want = param_shapes(cfg)
    if got != want:
        raise ValueError(f"{cfg.name} weights must be {want}, got {got}")
    return params


def params_to(params, device):
    """A copy of a params tree (either family) on ``device``."""
    return _tree(params, lambda t: t.to(device))


class _TokenNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` (f32 [B, S, V] logits,
    labels >= 0). Its backward writes softmax - onehot, times the upstream
    gradient, into one logits-sized f32 buffer, where autograd through
    ``logsumexp`` and ``take_along_dim`` holds three at once (15 GB at a
    Qwen2-1.5B step of 8,192 tokens over 151,936 columns)."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
        ctx.save_for_backward(logits, lse, labels)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels = ctx.saved_tensors
        grad = (logits - lse[..., None]).exp_().mul_(g[..., None])
        # one entry a row: a sum of one term, the same in any order
        grad.scatter_add_(-1, labels[..., None], -g[..., None])
        return grad, None


def loss_fn(params, cfg: ModelConfig, batch: Dict, *, policy=NO_POLICY,
            aux_coef: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """Token cross-entropy (padded-vocab columns masked out) + ``aux_coef`` ·
    the MoE aux loss, the reference's algorithm: f32 logsumexp, the target
    logit at ``max(labels, 0)``, positions with label < 0 ignored.

    batch["labels"] int[B, S]. Returns (loss, {"ce", "aux", "tokens"}).
    Under a mesh ``policy`` (global batch, this rank's params): over
    vocab-sharded logits the log-sum-exp and the target logit are reduced
    over "model" inside the one autograd Function; each rank sums its own
    tokens' terms, and the sums and the count are summed over the token
    axes, so every rank returns the global loss and backpropagates its own
    tokens' part."""
    logits, aux = model_forward(params, cfg, batch, policy=policy)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    vp = logits.shape[-1]
    off, pol = 0, None
    if on_mesh(policy):
        pol = policy.bind(*labels.shape)
        labels = pol.take(labels, pol.compute_spec()[:2])
        if vp != cfg.padded_vocab(1):
            off = pol._coord("model") * vp
    if off + vp > cfg.vocab_size:  # mask the padded vocab tail
        vmask = torch.arange(off, off + vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(vmask, logits, torch.full((), -1e30, device=logits.device))
    mask = (labels >= 0).to(torch.float32)
    if pol is not None and vp != cfg.padded_vocab(1):
        nll = VocabParallelNLL.apply(logits, torch.clamp(labels, min=0), pol.group("model"),
                                     off) * mask
    else:
        nll = _TokenNLL.apply(logits, torch.clamp(labels, min=0)) * mask
    if pol is None:
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = nll.sum() / denom
    else:
        count = mask.sum()
        for a in pol.token_axes():
            count = all_reduce(count, pol.group(a))
        denom = torch.clamp(count, min=1.0)
        ce = pol.sum_tokens(nll.sum()) / denom
    loss = ce + aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "tokens": denom}
