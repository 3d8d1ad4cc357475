"""`mma.sync`'s rounding toward zero over the L-long sums of the d = 64
flash backward, on the CPU.

The d = 64 backward kernels (`flash_dq_d64`, `flash_dkv_d64` in
`rdeic_torch/csrc/flash_attn_bwd.cu`) take every 3xTF32 pass into their
running dq, dk and dv accumulators, and `mma.sync` rounds the sum it
returns toward zero, so every pass drops up to an ulp of them, always
toward zero, and the error grows with L (the card reads ~1e-5 of max at
L = 1024 and 5e-5 on dk at [2, 4096, 5, 64]). This file models that
(`tests/torch_port_tf32.py` `mma_3xtf32`) in the kernels' tile order, and
the remedy: per-step partials added in fp32. They were the suite's
longest tests (minutes each on a torch thread pool shared with the other
test workers), so they sit in a file of their own and run on one thread.
"""
from rdeic_torch.ops.flash_attention import flash_attention_bwd_plain
from tests.torch_port_tf32 import (
    backward_d64_tiles,
    d64_bwd_inputs,
    mma_3xtf32,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
)


def acc_into(x, a, b):
    """Every pass taken into the accumulator itself (`accumulate_step`)."""
    return mma_3xtf32(a, b, x)


def acc_partials(x, a, b):
    """The remedy: each 8-deep step's three passes sum from zero, and that
    sum is added to the accumulator in fp32 (to nearest)."""
    for k0 in range(0, a.shape[-1], 8):
        x = x + mma_3xtf32(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
    return x


def _rz_reads(seq, acc) -> list:
    """(dq, dk, dv) errors over max against float64, at (1, seq, 1), with
    every product on the modelled tensor core."""
    inputs = d64_bwd_inputs(1, seq, 1, seq + 1)
    want = flash_attention_bwd_plain(*(x.double() for x in inputs))
    got = backward_d64_tiles(*inputs, mma_3xtf32, acc)
    return [rel(g, w) for g, w in zip(got, want)]


def test_d64_backward_rounding_toward_zero_grows_with_l_in_one_accumulator():
    """The kernels' order reads ~1e-5 of max at L = 1024, as the card reads
    at L = 1000-1024, and the error grows with L."""
    short, long = _rz_reads(256, acc_into), _rz_reads(1024, acc_into)
    assert min(long) > 5e-6, long
    assert all(b > 2 * a for a, b in zip(short, long)), (short, long)


def test_d64_backward_per_step_partials_keep_the_error_flat():
    """With per-step partials added in fp32 the error stays at a few 1e-6
    of max and does not grow from L = 256 to 1024: the remedy, if a longer
    L ever needs the margin (it costs the kernels registers)."""
    short, long = _rz_reads(256, acc_partials), _rz_reads(1024, acc_partials)
    assert max(long) < 5e-6, long
    assert max(long) < 1.5 * max(short), (short, long)
