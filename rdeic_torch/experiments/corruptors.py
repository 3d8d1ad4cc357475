"""Fault injection: bitstream and latent corruption (a copy of the root
experiments/corruptors.py, numpy only: the same seed gives the same bytes).

Role parity: the reference's experiments/corruptors.py — random bit flips,
geometric-length burst errors, latent corruption (mask-replace / additive
Gaussian), a file-level wrapper, and a `Corruptor` dispatcher; `__main__`
self-test prints corruption statistics.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def bit_flip_bytes(data: bytes, error_rate: float, seed: int = 0) -> bytes:
    """Flip each bit independently with probability `error_rate`."""
    if error_rate <= 0 or not data:
        return data
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    bits = arr.size * 8
    n_flips = rng.binomial(bits, error_rate)
    if n_flips == 0:
        return data
    pos = rng.choice(bits, size=n_flips, replace=False)
    np.bitwise_xor.at(arr, pos // 8, (1 << (pos % 8)).astype(np.uint8))
    return arr.tobytes()


def burst_flip_bytes(
    data: bytes,
    error_rate: float,
    mean_burst_len: float = 8.0,
    seed: int = 0,
) -> bytes:
    """Flip bits in bursts: burst starts are Poisson-like with the overall
    bit-error rate preserved; burst lengths are geometric."""
    if error_rate <= 0 or not data:
        return data
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    bits = arr.size * 8
    target_flips = max(1, int(round(bits * error_rate)))
    flipped = 0
    while flipped < target_flips:
        start = int(rng.integers(0, bits))
        length = 1 + int(rng.geometric(1.0 / mean_burst_len))
        end = min(start + length, bits)
        pos = np.arange(start, end)
        np.bitwise_xor.at(arr, pos // 8, (1 << (pos % 8)).astype(np.uint8))
        flipped += end - start
    return arr.tobytes()


def latent_corrupt(
    latent: np.ndarray,
    mode: str = "mask_replace",
    severity: float = 0.1,
    seed: int = 0,
) -> np.ndarray:
    """Corrupt a decoded latent tensor.

    mode="mask_replace": replace a `severity` fraction of positions with
    N(0, 1) values; mode="additive": add N(0, severity) noise everywhere.
    """
    rng = np.random.default_rng(seed)
    latent = np.array(latent)
    if mode == "mask_replace":
        mask = rng.random(latent.shape) < severity
        latent[mask] = rng.normal(0, 1, size=int(mask.sum()))
    elif mode == "additive":
        latent = latent + rng.normal(0, severity, size=latent.shape)
    else:
        raise ValueError(f"unknown latent corruption mode {mode!r}")
    return latent.astype(np.float32)


def corrupt_file(
    src: str, dst: str, error_rate: float, burst: bool = False, seed: int = 0
) -> None:
    """Corrupt the *payload* of a bitstream file, preserving the 12-byte
    container header so length parsing survives (payload robustness is what
    the experiment measures)."""
    data = Path(src).read_bytes()
    head, payload = data[:12], data[12:]
    fn = burst_flip_bytes if burst else bit_flip_bytes
    Path(dst).write_bytes(head + fn(payload, error_rate, seed=seed))


class Corruptor:
    """Dispatcher mirroring the reference Corruptor class."""

    BITSTREAM_MODES = ("random", "burst")
    LATENT_MODES = ("mask_replace", "additive")

    def __init__(self, target: str, mode: str, severity: float, seed: int = 0):
        assert target in ("bitstream", "latent")
        self.target = target
        self.mode = mode
        self.severity = severity
        self.seed = seed

    def apply_bytes(self, data: bytes) -> bytes:
        assert self.target == "bitstream"
        if self.mode == "random":
            return bit_flip_bytes(data, self.severity, seed=self.seed)
        if self.mode == "burst":
            return burst_flip_bytes(data, self.severity, seed=self.seed)
        raise ValueError(self.mode)

    def apply_latent(self, latent: np.ndarray) -> np.ndarray:
        assert self.target == "latent"
        return latent_corrupt(latent, self.mode, self.severity, seed=self.seed)


def _selftest():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes()
    for rate in (0.0, 0.001, 0.01, 0.1):
        out = bit_flip_bytes(data, rate, seed=1)
        a = np.unpackbits(np.frombuffer(data, np.uint8))
        b = np.unpackbits(np.frombuffer(out, np.uint8))
        frac = float(np.mean(a != b))
        print(f"bit_flip rate={rate}: measured={frac:.5f}")
        assert abs(frac - rate) < max(0.005, rate)
    out = burst_flip_bytes(data, 0.01, seed=2)
    a = np.unpackbits(np.frombuffer(data, np.uint8))
    b = np.unpackbits(np.frombuffer(out, np.uint8))
    print(f"burst_flip rate=0.01: measured={float(np.mean(a != b)):.5f}")
    lat = rng.normal(size=(1, 8, 8, 4)).astype("f4")
    for mode in ("mask_replace", "additive"):
        out = latent_corrupt(lat, mode, 0.2, seed=3)
        print(f"latent {mode}: mean|delta|={float(np.mean(np.abs(out-lat))):.4f}")
        assert out.shape == lat.shape
    print("corruptors self-test OK")


if __name__ == "__main__":
    argparse.ArgumentParser().parse_args()
    _selftest()
