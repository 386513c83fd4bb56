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
from repro_torch.models.api import model_decode_step, model_init, model_prefill

__all__ = ["ServeEngine"]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, max_len: int, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """``params`` on ``device`` (the reference's carried over with
        ``models.api.params_from_numpy``), or random ones from ``generator``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else model_init(
            cfg, generator, device=self.device)
        self.max_len = max_len

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[..., : self.cfg.vocab_size], dim=-1)

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
            self.params, self.cfg, {"tokens": prompts}, self.max_len)
        next_tok = self._argmax(logits[:, -1])
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
                self.params, self.cfg, {"tokens": next_tok[:, None]}, cache, cache_len)
            cache_len += 1
            next_tok = torch.where(done, next_tok, self._argmax(logits))
        return torch.cat(out, dim=1).to(torch.int32)
