"""rdeic_torch.utils.profiling against rdeic_tpu.utils.profiling on the CPU:
`PhaseTimer`'s summary and JSON for the same phases under the same clock,
`memory_stats` without CUDA, and `device_trace` writing a trace file."""
import json
import time

import pytest
import torch

from rdeic_torch.utils import profiling as tp
from rdeic_tpu.utils import profiling as jp

# perf_counter readings: each phase reads the clock on entry and on exit
CLOCK = [0.0, 0.125, 1.0, 1.0333333, 2.0, 2.00012345, 5.0, 5.5, 9.0, 9.000001]
PHASES = [("encode", False), ("decode", True), ("encode", False),
          ("sample", True), ("decode", False)]


def _run(module, monkeypatch) -> object:
    ticks = iter(CLOCK)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timer = module.PhaseTimer()
    for name, block in PHASES:
        with timer.phase(name, block=block):
            pass
    monkeypatch.undo()
    return timer


def test_phase_timer_summary_and_dump_equal_jax(monkeypatch, tmp_path):
    got, want = _run(tp, monkeypatch), _run(jp, monkeypatch)
    assert got.summary() == want.summary()
    assert list(got.summary()) == ["encode", "decode", "sample"]
    # 0.125 + 0.00012345 s, rounded as the JAX package rounds
    assert got.summary()["encode"] == {"total_s": 0.1251, "count": 2,
                                       "mean_ms": 62.56}
    got.dump(tmp_path / "t.json")
    want.dump(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_phase_timer_counts_a_phase_that_raises():
    timer = tp.PhaseTimer()
    with pytest.raises(KeyError), timer.phase("x", block=True):
        raise KeyError("boom")
    assert timer.counts["x"] == 1 and timer.totals["x"] >= 0


def test_memory_stats_on_the_cpu_is_one_empty_entry():
    assert tp.memory_stats() == {"cpu": {}}
    assert all(v == {} or isinstance(v, dict)
               for v in jp.memory_stats().values())


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with tp.device_trace(tmp_path / "trace") as prof:
        (a @ a).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
