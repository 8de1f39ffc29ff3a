"""tpu_pillars_torch's profiling helpers (``utils/profiling.py``) on the
CPU: the three cases of tests/test_profiling.py on the port — StageTimer
accounting and its device sync, a stage without ``observe``, and the
``torch.profiler`` trace file."""

import json

import pytest
import torch

from tpu_pillars_torch.utils import profiling
from tpu_pillars_torch.utils.profiling import StageTimer, trace, trace_files


def test_stage_timer_accumulates_and_syncs(monkeypatch):
    synced = []
    monkeypatch.setattr(profiling, "_sync", synced.append)
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("matmul"):
            x = torch.ones((64, 64))
            timer.observe(x @ x)
    with timer.stage("other"):
        timer.observe({"a": (torch.arange(8),)})
    s = timer.summary()
    assert s["matmul"]["count"] == 3
    assert s["other"]["count"] == 1
    assert s["matmul"]["total_s"] > 0
    # summary() rounds total_s at 1e-6 s and mean_ms at 1e-3 ms — allow
    # both roundings in the identity check
    assert abs(s["matmul"]["mean_ms"]
               - 1e3 * s["matmul"]["total_s"] / 3) < 2e-3
    assert set(s["matmul"]) == {"total_s", "count", "mean_ms"}
    # each stage synced on what it observed, and observe() reset after it
    assert len(synced) == 4
    assert timer._result is None
    # CPU tensors need no sync: the real _sync never reaches the card
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("synced a CPU tensor"))
    profiling._sync((torch.ones(2), [torch.zeros(3)]))


def test_stage_timer_tolerates_no_observe():
    timer = StageTimer()
    with timer.stage("host_only"):
        sum(range(100))
    assert timer.summary()["host_only"]["count"] == 1


def test_trace_context_writes_profile(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        x = torch.ones((32, 32))
        x @ x
    found = trace_files(log_dir)
    assert len(found) == 1, "profiler trace produced no file"
    with open(found[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
