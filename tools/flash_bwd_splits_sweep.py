#!/usr/bin/env python3
"""Time the tensor-core flash backward's dK/dV kernel over its head splits on one CUDA card.

Run from the root of a checkout on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/flash_bwd_splits_sweep.py

At the training shapes of Qwen2-1.5B (GQA 12/2, hd 128), SmolLM-360M (15/5,
hd 64) and Qwen2-VL-7B (28/4, hd 128), each B 4 x 2,048 causal in bf16, it
times the dK/dV kernel of ``csrc/flash_attention_bwd.cu``'s tensor-core pair
(with its sum of split partials) at every divisor of G = H / KV as the
number of blocks that share a (kv-head, batch, 64 keys), beside the split
``ops.bwd_head_splits`` picks for this card, and the dQ kernel once. Each
time is the median of three runs of ten launches, by CUDA events; the card's
name and power limit are printed first. Every split must give the unsplit
kernel's gradients within 2^-7 of each one's largest magnitude (the f32 sums
run in another order); the script exits 1 if one does not.
"""
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = (  # (label, B, S = T, H, KV, hd)
    ("qwen2-1.5b", 4, 2048, 12, 2, 128),
    ("smollm-360m", 4, 2048, 15, 5, 64),
    ("qwen2-vl-7b", 4, 2048, 28, 4, 128),
)


def main() -> int:
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels.flash_attention import ops as fa_ops

    if not torch.cuda.is_available():
        print("flash_bwd_splits_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(smoke.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for label, b, s, h, kv, hd in SHAPES:
        q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out, lse = fa_ops._forward(q, k, v, True, with_lse=True)
        g = h // kv
        picked = fa_ops.bwd_head_splits(b, s, kv, g, sms)
        times, base, dq_ms = {}, None, None
        for splits in (d for d in range(1, g + 1) if g % d == 0):
            dq_call, dkdv_call, grads = smoke._bwd_entry_points(
                q, k, v, out, lse, do, True, "tensor_cores", splits)
            dq_call()  # D for the dK/dV kernel
            dkdv_call()
            torch.cuda.synchronize()
            if base is None:
                base = [x.float() for x in grads[1:]]
                dq_ms = statistics.median(smoke.cuda_ms(dq_call, reps=10) for _ in range(3))
            err = max(float((x.float() - w).abs().max() / w.abs().max())
                      for x, w in zip(grads[1:], base))
            ok &= err <= 2.0 ** -7
            times[splits] = statistics.median(smoke.cuda_ms(dkdv_call, reps=10) for _ in range(3))
            print(f"{label} B={b} S=T={s} H={h} KV={kv} hd={hd}: splits {splits}"
                  f"{' (picked)' if splits == picked else ''}: dK/dV {times[splits]:.3f} ms, "
                  f"against unsplit {err:.2e} of max", flush=True)
            del grads
        best = min(times, key=times.get)
        print(f"{label}: dQ {dq_ms:.3f} ms; fastest split {best} ({times[best]:.3f} ms), picked "
              f"{picked} ({times[picked]:.3f} ms) on {sms} SMs", flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
