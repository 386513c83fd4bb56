"""Serving engine for the token families: batched prefill + greedy decode.

The reference's ``repro/serve/engine.py``. Prefill is one forward pass that
also writes every layer's cache (``models/lm/transformer.prefill``); decode
is one token per step for the whole batch. Each sequence is masked once it
emits ``eos_id`` (its later tokens repeat it), and generation stops when all
have. The engine runs on ``cuda`` unless it is given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (NO_POLICY, all_gather, on_mesh, param_shardings,
                                              shard_tree)
from repro_torch.models.api import model_decode_step, model_init, model_prefill

__all__ = ["ServeEngine"]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, max_len: int, device="cuda",
                 generator: Optional[torch.Generator] = None, policy=None):
        """``params`` on ``device`` (the reference's carried over with
        ``models.api.params_from_numpy``), or random ones from ``generator``.
        ``policy``: a ``ShardingPolicy`` to serve over its mesh; ``params``
        are then this rank's shards, cut by the policy's ``placements``.
        Random ones are cut by those, or by ``param_shardings(fsdp=False)``
        (decode gathers no weight) when the policy carries none. Every rank
        runs ``generate`` on the same prompts and returns the whole batch's
        tokens."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = NO_POLICY if policy is None else policy
        if params is None:
            params = model_init(cfg, generator, device=self.device)
            if on_mesh(self.policy):
                mesh = self.policy.mesh
                if self.policy.placements is None:
                    self.policy = self.policy.with_placements(param_shardings(
                        cfg, params, mesh, fsdp=False, mode=self.policy.mode))
                params = shard_tree(params, self.policy.placements, mesh)
        self.params = params
        self.max_len = max_len

    def _argmax(self, logits: torch.Tensor, b: int) -> torch.Tensor:
        """Greedy tokens of the whole batch (``b`` rows) from the logits of
        one position."""
        if not on_mesh(self.policy):
            return torch.argmax(logits[..., : self.cfg.vocab_size], dim=-1)
        return self.policy.bind(b, 1).greedy(logits, self.cfg.vocab_size,
                                             self.cfg.padded_vocab(1))

    @torch.inference_mode()
    def generate(self, prompts, *, max_new_tokens: int,
                 eos_id: Optional[int] = None) -> torch.Tensor:
        """prompts int[B, P] -> int32[B, P + max_new_tokens] on the engine's
        device (fewer columns when every sequence hit ``eos_id``)."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, p = prompts.shape
        if p + max_new_tokens > self.max_len:
            raise ValueError(f"max_len {self.max_len} too small for {p} + {max_new_tokens} tokens")
        logits, cache, cache_len = model_prefill(
            self.params, self.cfg, {"tokens": prompts}, self.max_len, policy=self.policy)
        last = logits[:, -1]
        if on_mesh(self.policy) and self.policy.bind(b, p).compute_spec()[1]:
            last = all_gather(last, self.policy.group("model"))[-1]  # the sequence's end
        next_tok = self._argmax(last, b)
        del logits  # [B, P, V] f32: free it before decoding
        out = [prompts]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        for i in range(max_new_tokens):
            out.append(next_tok[:, None])
            if eos_id is not None:
                done = done | (next_tok == eos_id)
                if bool(done.all()):
                    break
            if i == max_new_tokens - 1:
                break  # the last token is out; no step needs its logits
            logits, cache = model_decode_step(
                self.params, self.cfg, {"tokens": next_tok[:, None]}, cache, cache_len,
                policy=self.policy)
            cache_len += 1
            next_tok = torch.where(done, next_tok, self._argmax(logits, b))
        return torch.cat(out, dim=1).to(torch.int32)
