"""tpu_pillars_torch's profiling helpers (``utils/profiling.py``) on the
CPU: the three cases of tests/test_profiling.py on the port — StageTimer
accounting and its device sync, a stage without ``observe``, and the
``torch.profiler`` trace file — then the span recorder: its off path,
spans, counters and self time, device spans and gaps (on host-clock
stand-ins for CUDA events), the detector's spans in a trace file and in
the record, ``fit``'s spans and logged rate, the step's ``split=``, and
on a card (``-m cuda``) device spans that resolve without a
synchronise."""

import json
import time

import numpy as np
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


# ---- the span recorder


@pytest.fixture
def recorder():
    """The module recorder, cleared, with tracing off on both sides."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


class FakeEvent:
    """A CUDA event on the host clock, complete once recorded."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e-6


@pytest.fixture
def fake_card(monkeypatch):
    """Device spans on the CPU: every device span's events are
    ``FakeEvent``s; returns the list of synchronised devices."""
    synced = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(profiling, "_cuda_device",
                        lambda d: None if d is False else torch.device("cuda", 0))
    return synced


def tiny_detector():
    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    cfg = tiny_config()
    state = create_train_state(cfg, TrainConfig(), seed=0, device="cpu")
    return Detector(cfg, state.model.state_dict(), device="cpu")


def clouds(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-20, 20, (int(m), 4)).astype(np.float32)
            for m in rng.integers(500, 2000, n)]


def predict_batches(det, batches=2, batch=2):
    for k in range(batches):
        padded = [det.pad_points(c) for c in clouds(batch, seed=k)]
        det.predict_packed_batch(np.stack([p for p, _ in padded]),
                                 np.asarray([n for _, n in padded]))


def test_off_path_records_nothing(recorder, monkeypatch):
    def called(*a, **k):
        pytest.fail("the off path reached the profiler or the card")

    monkeypatch.setattr(torch.profiler, "record_function", called)
    monkeypatch.setattr(torch.cuda, "Event", called)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert not recorder.recording()
    for device in (False, True, torch.device("cuda", 0)):
        s = recorder.span("off", device=device, unit=True)
        assert s is recorder.span("other")     # one shared no-op
        with s:
            pass
    recorder.count("off", 3)
    det = tiny_detector()
    predict_batches(det, batches=1)
    assert recorder.summary() == {"spans": {}, "counters": {}}
    assert recorder.records() == []


def test_enable_records_spans_counters_and_self_time(recorder):
    recorder.enable()
    with recorder.span("outer", unit=True):
        with recorder.span("inner"):
            time.sleep(0.002)
        with recorder.span("inner"):
            pass
        recorder.count("things", 2)
    recorder.count("things", 1)
    recorder.disable()
    with recorder.span("outer", unit=True):
        pass
    s = recorder.summary()
    outer, inner = s["spans"]["outer"], s["spans"]["inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert outer["self_ms"] == pytest.approx(outer["host_ms"]
                                             - inner["host_ms"])
    assert inner["host_ms"] >= 2.0
    assert outer["device_ms"] is None and outer["gap_ms"] is None
    assert s["counters"] == {"things": 3}
    recs = recorder.records()
    assert [r[0] for r in recs] == ["inner", "inner", "outer"]
    assert [r[3] for r in recs] == ["outer", "outer", None]
    assert len({r[4] for r in recs}) == 1
    recorder.reset()
    assert recorder.summary() == {"spans": {}, "counters": {}}


def test_device_spans_and_gaps(recorder, fake_card):
    recorder.enable()
    for _ in range(3):
        with recorder.span("unit", device=True, unit=True):
            with recorder.span("stage", device=True):
                pass
        time.sleep(0.002)
    # a unit that was not recorded breaks the chain of gaps
    recorder.disable()
    with recorder.span("unit", device=True, unit=True):
        pass
    recorder.enable()
    with recorder.span("unit", device=True, unit=True):
        pass
    s = recorder.summary()["spans"]
    assert s["unit"]["count"] == 4 and s["stage"]["count"] == 3
    assert s["unit"]["gaps"] == 2
    assert s["unit"]["gap_ms"] >= 2 * 2.0
    assert s["unit"]["device_ms"] >= s["stage"]["device_ms"] > 0
    assert s["stage"]["gaps"] == 0 and s["stage"]["gap_ms"] is None
    # every pair resolved as it closed: nothing was left to synchronise
    assert fake_card == []


def test_trace_holds_the_detector_spans(recorder, tmp_path):
    det = tiny_detector()
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        predict_batches(det)
    with open(trace_files(log_dir)[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if str(e.get("name", "")).startswith("tp.")]
    names = {e["name"] for e in events}
    stages = {"tp.detector.upload", "tp.detector.frontend",
              "tp.detector.rpn_head", "tp.detector.postprocess"}
    assert {"tp.detector.predict", "tp.detector.pad"} | stages <= names
    predicts = [e for e in events if e["name"] == "tp.detector.predict"]
    assert len(predicts) == 2
    for e in events:
        if e["name"] in stages:    # inside one batch's span
            assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= p["ts"] + p["dur"] for p in predicts)

    recs = recorder.records()
    units = [r for r in recs if r[0] == "detector.predict"]
    assert len(units) == 2
    for name, t0, t1, parent, unit in units:
        children = [r for r in recs if r[3] == "detector.predict"
                    and r[4] == unit]
        assert sorted(r[0] for r in children) == sorted(
            s[3:] for s in stages)
        assert all(t0 <= c[1] and c[2] <= t1 for c in children)
    assert [r[4] for r in recs if r[0] == "detector.pad"] == [None] * 4
    s = recorder.summary()["spans"]
    pred = s["detector.predict"]
    assert pred["count"] == 2 and s["detector.pad"]["count"] == 4
    assert pred["self_ms"] == pytest.approx(
        pred["host_ms"] - sum(s[n[3:]]["host_ms"] for n in stages))


def test_fit_spans_once_per_step(recorder):
    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.train.loop import fit, synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    cfg = tiny_config()
    tcfg = TrainConfig(batch_size=2, max_gt_boxes=8)
    state = create_train_state(cfg, tcfg, seed=0, device="cpu")
    rows = []

    class Log:
        def log(self, event, **kw):
            rows.append((event, kw))

    recorder.enable()
    fit(state, synthetic_batches(cfg, tcfg, seed=1), 2, config=cfg,
        logger=Log(), log_every=1)
    s = recorder.summary()["spans"]
    for name in ("fit.step", "fit.upload", "fit.readback"):
        assert s[name]["count"] == 2, name
    # the loop draws one batch past its last step, as the JAX loop does
    assert s["fit.data"]["count"] == 3
    for phase in ("frontend", "assign", "forward", "backward", "optimizer"):
        assert s["step." + phase]["count"] == 2
    step = s["fit.step"]
    inside = sum(s[n]["host_ms"] for n in s if n.startswith("step.")) + sum(
        s[n]["host_ms"] for n in ("fit.upload", "fit.readback"))
    assert step["self_ms"] == pytest.approx(step["host_ms"] - inside)
    units = {r[4] for r in recorder.records() if r[3] == "fit.step"}
    assert len(units) == 2
    # steps/s over the steps since the previous line
    rates = [kw["steps_per_s"] for e, kw in rows if e == "train_step"]
    assert len(rates) == 2 and all(r > 0 for r in rates)


def test_fit_rate_leaves_the_first_step_out():
    from itertools import islice
    from types import SimpleNamespace

    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.train.loop import fit, synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    cfg = tiny_config()
    tcfg = TrainConfig(batch_size=2, max_gt_boxes=8)
    state = create_train_state(cfg, tcfg, seed=0, device="cpu")
    batches = list(islice(synthetic_batches(cfg, tcfg, seed=1), 4))
    rows = []

    class Log:
        def log(self, event, **kw):
            rows.append((event, kw))

    def step_fn(state, batch):
        time.sleep(0.5 if state.step == 0 else 0.01)   # a slow warm-up
        state.step += 1
        z = torch.zeros(())
        return state, SimpleNamespace(total=z, cls=z, loc=z, dir=z,
                                      num_pos=z)

    fit(state, batches, 4, step_fn, cfg, logger=Log(), log_every=2)
    rates = [kw["steps_per_s"] for e, kw in rows if e == "train_step"]
    # steps 2 and 3-4 at ~100/s; had the 0.5 s first step been timed, the
    # first line would read under 2 / 0.5 = 4/s
    assert len(rates) == 2 and min(rates) > 20


def test_split_is_synchronised_and_kept_out_of_the_record(recorder,
                                                           monkeypatch):
    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.train.loop import synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import (
        _Phases, batch_to_device, make_train_step,
    )

    cfg = tiny_config()
    tcfg = TrainConfig(batch_size=2, max_gt_boxes=8)
    state = create_train_state(cfg, tcfg, seed=0, device="cpu")
    step = make_train_step(cfg, max_gt_per_class=4, accum_steps=2)
    batch = batch_to_device(next(synthetic_batches(cfg, tcfg, seed=1)),
                            torch.device("cpu"))
    recorder.enable()
    split = {}
    step(state, batch, split=split)
    assert set(split) == {"frontend", "assign", "forward", "backward",
                          "optimizer"}
    assert all(v > 0 for v in split.values())
    assert recorder.summary()["spans"] == {}
    # each boundary synchronises the step's card
    marks = []
    monkeypatch.setattr(torch.cuda, "synchronize", marks.append)
    gpu = torch.device("cuda", 0)
    phases = _Phases({}, gpu)
    for name in ("frontend", "assign"):
        phases.begin(name)
    phases.end()
    assert marks == [gpu] * 3
    assert set(phases.out) == {"frontend", "assign"}


@pytest.mark.cuda
def test_device_spans_resolve_without_a_synchronise(recorder, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(2048, 2048, device="cuda")
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    recorder.enable()
    for _ in range(4):
        with recorder.span("unit", device=True, unit=True):
            with recorder.span("matmul", device=True):
                for _ in range(8):
                    x = (x @ x).clamp_(-1, 1)
        done = torch.cuda.Event()
        done.record()
        while not done.query():     # the card finishes, unasked
            time.sleep(1e-4)
    # the pairs of the first units resolved as later spans closed
    assert len(recorder._RECORDER._pending) <= 2
    assert synced == []
    s = recorder.summary()["spans"]
    assert len(synced) == 1
    assert s["unit"]["count"] == 4 and s["unit"]["gaps"] == 3
    assert s["unit"]["device_ms"] >= s["matmul"]["device_ms"] > 0
    assert s["unit"]["gap_ms"] >= 0
