"""Serve a small LM with batched requests through the KV-cache engine, in the PyTorch port.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch smollm-360m] [--device cpu]

The port of ``examples/serve_lm.py``: one prefill pass that writes every
layer's cache, then batched single-token decode steps, through
``serve/engine.py::ServeEngine`` with a REDUCED config. It runs on the card
by default (flash attention and, for ``--arch mamba2-370m``, the SSD through
their CUDA kernels); ``--device cpu`` runs their plain versions. Weights come
from a ``torch.Generator`` of seed 0 and prompts from numpy seed 1, so the
tokens are the port's own, not the reference's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.serve.engine import ServeEngine


def run(*, arch: str = "smollm-360m", batch: int = 4, prompt_len: int = 16, tokens: int = 24,
        device="cuda") -> torch.Tensor:
    """Generate ``tokens`` new tokens for ``batch`` random prompts; prints the
    rate and returns the sequences int32[B, prompt_len + tokens]."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=True)
    eng = ServeEngine(cfg, max_len=prompt_len + tokens, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, prompt_len))
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} (reduced) batch={batch} device={dev}")
    print(f"prefill+decode {tokens} tokens: {dt:.2f}s ({batch * tokens / dt:.1f} tok/s)")
    for i in range(min(2, batch)):
        print(f"  seq{i}: ...{out[i, prompt_len - 4:].tolist()}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len, tokens=args.tokens,
        device=args.device)


if __name__ == "__main__":
    main()
