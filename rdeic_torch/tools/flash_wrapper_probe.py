"""Time the d = 16 flash forward through its Python wrapper on one card: the
back-to-back ms and the host µs a call of `flash_attention` (fp32 and bf16),
and the fp32 scratch's allocation alone, for the checkout on PYTHONPATH.

    PYTHONPATH=DIR python rdeic_torch/tools/flash_wrapper_probe.py TAG

times the package `rdeic_torch` under DIR. Run it by its path, not with
`-m`: `-m` puts the working directory first on the import path, so the
working directory's package would be timed whatever DIR is. At the short
serving shapes the wrapper's host work (checks, the output's allocation,
the launch or launches, and the fp32 d = 16 call's scratch) can take
longer than the card, so the back-to-back time reads the host. Run it
with DIR = this checkout and DIR = another (e.g. the parent commit
unpacked by `git archive`) in one card call to compare them. Prints a
JSON line per dtype and shape, tagged TAG.
"""
import json
import sys
import time

import torch

from rdeic_torch.ops import flash_attention as fa

SHAPES = [(1, 1024, 8, 16), (4, 1024, 8, 16), (1, 1536, 8, 16),
          (2, 1000, 3, 16), (2, 1536, 8, 16), (1, 6144, 4, 16)]


def cuda_ms(fn, reps=50):
    """ms a call of fn(), `reps` calls back to back (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=50):
    """µs a call of fn() takes to enqueue, from an idle card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def main() -> None:
    tag = sys.argv[1]
    lib = fa._fwd_library()
    for dt in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                       for _ in range(3))
            r = {"tag": tag, "dtype": str(dt), "shape": shape,
                 "wrapper_ms": cuda_ms(lambda: fa.flash_attention(q, k, v)),
                 "wrapper_host_us": host_us(lambda: fa.flash_attention(q, k, v))}
            if hasattr(lib, "rdeic_flash_attn_fwd_scratch_bytes"):
                b, seq, h, d = shape
                n = lib.rdeic_flash_attn_fwd_scratch_bytes(
                    b, seq, h, d, 0 if dt == torch.float32 else 1)
                if n:
                    r["alloc_ms"] = cuda_ms(lambda: torch.empty(
                        n, dtype=torch.uint8, device="cuda"))
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
