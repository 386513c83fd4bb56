"""Deterministic synthetic token pipeline: seeded, shardable, restartable.

A copy of the reference's ``repro/data/pipeline.py`` (numpy only), so its
batches are bitwise the reference's for every family.

A real deployment swaps `synthetic_batches` for a file-backed reader; the
contract is the generator protocol: (step -> batch) pure in (seed, step), so
restart-from-checkpoint replays identical data without persisted reader state
— the simplest fault-tolerant data-pipeline design.
Targets are a fixed affine-permutation sequence model so loss measurably
drops: next = (a*tok + b) mod V with per-stream (a, b).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["synthetic_batch", "synthetic_batches"]


def synthetic_batch(
    *, seed: int, step: int, batch: int, seq: int, vocab: int,
    family: str = "dense", d_model: int = 0,
) -> Dict[str, np.ndarray]:
    # the affine map is a function of SEED ONLY (stationary, learnable);
    # starting tokens vary per step so batches differ.
    rng_task = np.random.default_rng(np.random.SeedSequence([seed]))
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    a = int(2 * rng_task.integers(1, max(vocab // 2, 2)) + 1)  # odd => invertible
    b = int(rng_task.integers(0, vocab))
    t0 = rng.integers(0, vocab, (batch, 1))
    toks = np.zeros((batch, seq + 1), np.int64)
    toks[:, 0:1] = t0
    for i in range(seq):
        toks[:, i + 1 : i + 2] = (a * toks[:, i : i + 1] + b) % vocab
    out = {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
    if family in ("audio",):  # enc-dec: synthetic frontend embeddings
        out["src_embeds"] = rng.standard_normal((batch, seq, d_model)).astype(
            np.float32
        )
        out["tgt_tokens"] = out.pop("tokens")
    if family in ("vlm",) and d_model:
        out["embeds"] = rng.standard_normal((batch, seq, d_model)).astype(np.float32)
        out.pop("tokens")
    return out


def synthetic_batches(start_step: int = 0, **kw) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(step=step, **kw)
        step += 1
