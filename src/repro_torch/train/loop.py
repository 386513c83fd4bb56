"""Trainer: the training loop with checkpoint/restart and fault injection, as
the reference's ``repro/train/loop.py``.

* data is a function of (seed, step) (``data/pipeline.py``), so a restart
  replays the exact stream;
* checkpoints every ``ckpt_every`` steps (``ckpt_async``: written on a worker
  thread), atomic on disk, and a final one;
* ``run()`` resumes from the newest checkpoint in ``ckpt_dir``;
* ``run(crash_at=n)`` raises after step n (fault injection): a resumed run
  gives bitwise the params of a straight one;
* under a policy the checkpoints hold the whole state (gathered by the
  state's placements, written by rank 0) and each rank restores its shards,
  so a mesh run and an unsharded one read each other's checkpoints.

The params come from ``model_init`` with an explicit ``torch.Generator``
seeded with ``seed``, on ``device`` (``cuda`` unless the caller says
``cpu``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (NO_POLICY, on_mesh, param_shardings, replicated,
                                              shard_tree)
from repro_torch.models.api import model_init, param_shapes
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.train.train_step import init_train_state, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 64
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    ckpt_async: bool = False
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    warmup: int = 10
    compressor: Optional[object] = None


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *, device="cuda", policy=None):
        """``policy``: a ``ShardingPolicy`` to train over its mesh (every rank
        runs the same Trainer: the same seeded params, cut to its shards by
        the policy's ``placements``, or by ``param_shardings`` with FSDP on
        when it carries none, and the same global batches)."""
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.policy = NO_POLICY if policy is None else policy
        if on_mesh(self.policy) and self.policy.placements is None:
            self.policy = self.policy.with_placements(param_shardings(
                cfg, param_shapes(cfg), self.policy.mesh, mode=self.policy.mode))
        self.step_fn = make_train_step(cfg, tcfg.opt, total_steps=tcfg.steps,
                                       warmup=tcfg.warmup, compressor=tcfg.compressor,
                                       policy=self.policy)
        self.metrics_log: List[Dict] = []

    def init_state(self) -> Dict:
        """The seeded params' train state, with the compressor's error-feedback
        state under ``"compress"`` when one is set; under a policy, this
        rank's shards."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = model_init(self.cfg, gen, device=self.device)
        if on_mesh(self.policy):
            params = shard_tree(params, self.policy.placements, self.policy.mesh)
        state = init_train_state(self.cfg, params)
        if self.tcfg.compressor is not None:
            state["compress"] = self.tcfg.compressor.init_state(params)
        return state

    def _ckpt_kw(self, state: Dict) -> Dict:
        """The checkpoint calls' sharding arguments: the state's placements
        (the params' for params, AdamW moments and the error feedback) and
        the mesh, under a policy."""
        if not on_mesh(self.policy):
            return {}
        mesh, pl = self.policy.mesh, self.policy.placements
        place = {"params": pl, "opt": AdamWState(step=replicated(mesh), m=pl, v=pl),
                 "step": replicated(mesh)}
        if "compress" in state:
            place["compress"] = pl
        return {"placements": place, "mesh": mesh}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step``: ``synthetic_batch(seed, step)`` on the device."""
        b = synthetic_batch(seed=self.tcfg.seed, step=step, batch=self.tcfg.batch,
                            seq=self.tcfg.seq, vocab=self.cfg.vocab_size,
                            family=self.cfg.family, d_model=self.cfg.d_model)
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def run(self, *, crash_at: Optional[int] = None) -> Dict:
        """Train to ``tcfg.steps``; resume from the newest checkpoint if any.

        ``crash_at``: raise after that step completes (fault-injection tests)."""
        t = self.tcfg
        state = self.init_state()
        kw = self._ckpt_kw(state)
        start = 0
        if t.ckpt_dir:
            ckpt.wait_pending()
            latest = ckpt.latest_step(t.ckpt_dir, mesh=kw.get("mesh"))
            if latest is not None:
                start = latest
                state = ckpt.restore(t.ckpt_dir, state, step=latest, **kw)
        t0 = time.time()
        for step in range(start, t.steps):
            state, metrics = self.step_fn(state, self.batch(step))
            if (step + 1) % t.log_every == 0 or step + 1 == t.steps:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step + 1
                rec["wall_s"] = time.time() - t0
                self.metrics_log.append(rec)
            if t.ckpt_dir and (step + 1) % t.ckpt_every == 0:
                save = ckpt.save_async if t.ckpt_async else ckpt.save
                save(state, t.ckpt_dir, step + 1, **kw)
            if crash_at is not None and step + 1 >= crash_at:
                raise RuntimeError(f"injected fault after step {step + 1}")
        ckpt.wait_pending()
        if t.ckpt_dir:
            ckpt.save(state, t.ckpt_dir, t.steps, **kw)
        return {"state": state, "metrics": self.metrics_log}
