"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's ``repro/launch/train.py``: the Trainer on a REDUCED config
by default (``--full`` for the published one), on the card unless
``--device cpu``. ``--compress topk`` (1% of each leaf) or ``int8`` passes the
gradients through ``distributed/compression.py`` before AdamW.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config
from repro_torch.distributed.compression import Int8Compressor, TopKCompressor
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true", help="full (not reduced) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress", choices=["none", "topk", "int8"], default="none")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    comp = {"none": None, "topk": TopKCompressor(ratio=0.01), "int8": Int8Compressor()}[
        args.compress]
    tcfg = TrainerConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                         ckpt_dir=args.ckpt_dir, opt=AdamWConfig(lr=args.lr),
                         compressor=comp)
    out = Trainer(cfg, tcfg, device=args.device).run()
    for rec in out["metrics"]:
        print(
            f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
            f"grad_norm {rec['grad_norm']:.3f}  lr {rec['lr']:.2e}  "
            f"wall {rec['wall_s']:.1f}s"
        )
    return out


if __name__ == "__main__":
    main()
