"""Tracing and profiling helpers (counterpart of rdeic_tpu/utils/profiling.py):
named phase timers, a TensorBoard-readable trace of a block through
`torch.profiler`, and the allocator's memory statistics per CUDA device."""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch


class PhaseTimer:
    """Accumulating named wall-clock timers with JSON export."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block and torch.cuda.is_initialized():
                # CUDA launches return before the card is done: wait for them
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / self.counts[name], 2),
            }
            for name in self.totals
        }

    def dump(self, path: str):
        Path(path).write_text(json.dumps(self.summary(), indent=2))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a code block with `torch.profiler` (the CPU, and the CUDA
    devices where there are any) and write it into `log_dir` as a Chrome
    trace that TensorBoard's profiler plugin reads
    (`<host>_<pid>.<ms>.pt.trace.json`). Yields the profiler, whose
    `key_averages()` sums the traced ops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def memory_stats() -> dict:
    """Per-device memory statistics (bytes): `torch.cuda.memory_stats` of
    each visible CUDA device, plus the names the JAX package's devices
    report (`bytes_in_use`, `peak_bytes_in_use`, `bytes_limit`). Without
    CUDA, one empty entry for the CPU, as JAX gives a device that reports
    nothing."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    out = {}
    for d in range(torch.cuda.device_count()):
        stats = dict(torch.cuda.memory_stats(d))
        stats.update(
            bytes_in_use=stats.get("allocated_bytes.all.current", 0),
            peak_bytes_in_use=stats.get("allocated_bytes.all.peak", 0),
            bytes_limit=torch.cuda.get_device_properties(d).total_memory)
        out[f"cuda:{d}"] = stats
    return out
