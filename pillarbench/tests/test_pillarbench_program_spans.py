"""The readers of the program's own spans (``program_spans.py`` and the
``metrics/*.py`` whose ``source`` is ``program_span``): each returns a
number from a recorded CPU run of its loop's program calls, device times
read from host-clock stand-ins for CUDA events, and None from an empty
record or from a program without the recorder. Then whole traced runs at
the tiny configuration report the host-clock ones."""

import time

import numpy as np
import pytest
import torch

from pillarbench.cells import Cell, load_benchmark
from pillarbench.readers import RunRecord
from pillarbench.tests.tiny import run_tiny, tiny_cell, tiny_fields
from tpu_pillars_torch.utils import profiling

READERS = {
    "offline.full": ["launch_ms.offline", "upload_host_ms.offline",
                     "upload_dev_ms.offline", "frontend_dev_ms.offline",
                     "rpn_head_dev_ms.offline", "postprocess_dev_ms.offline",
                     "gap_ms.offline"],
    "train.full": ["data_wait_ms.train", "batch_upload_ms.train",
                   "step_host_ms.train", "readback_ms.train", "gap_ms.train"],
}


class FakeEvent:
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
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(profiling, "_cuda_device",
                        lambda d: None if d is False else torch.device("cuda", 0))
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


def record(cell):
    return RunRecord(cell.config, cell.traffic)


def offline_calls(batches=3):
    """The offline loop's program calls: pad, launch, download."""
    from pillarbench.program import program_config
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    cfg = program_config(tiny_fields())
    state = create_train_state(cfg, TrainConfig(), seed=0, device="cpu")
    det = Detector(cfg, state.model.state_dict(), device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(batches):
        padded = [det.pad_points(rng.uniform(-20, 20, (1500, 4)).astype(
            np.float32)) for _ in range(2)]
        det.predict_packed_batch(np.stack([p for p, _ in padded]),
                                 np.asarray([n for _, n in padded])).cpu()


def train_calls(steps=3):
    """The training loop's program calls: ``fit`` with its step."""
    from pillarbench.program import program_config
    from tpu_pillars_torch.train.loop import fit, synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    cfg = program_config(tiny_fields())
    tcfg = TrainConfig(batch_size=2, max_gt_boxes=8)
    state = create_train_state(cfg, tcfg, seed=0, device="cpu")

    class Quiet:
        def log(self, event, **kw):
            pass

    fit(state, synthetic_batches(cfg, tcfg, seed=1), steps, config=cfg,
        logger=Quiet(), log_every=2)


@pytest.mark.parametrize("name,calls", [("offline.full", offline_calls),
                                        ("train.full", train_calls)])
def test_readers_read_a_recorded_run(fake_card, name, calls):
    cell = Cell(name)
    listed = {m["name"] for m in load_benchmark()["per_layer"]
              if m["source"] == "program_span" and name in m["workloads"]}
    assert set(READERS[name]) <= listed
    calls()
    run = record(cell)
    for metric in READERS[name]:
        v = cell.reader(metric)(run)
        assert v is not None and np.isfinite(v) and v >= 0, metric
    assert run.program_spans is not None      # read once a run
    profiling.reset()
    for metric in READERS[name]:
        assert cell.reader(metric)(record(cell)) is None, metric


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "summary")
    for name, metrics in READERS.items():
        cell = Cell(name)
        for metric in metrics:
            assert cell.reader(metric)(record(cell)) is None


def test_traced_runs_report_the_program_spans(tmp_path):
    profiling.reset()
    result, _, _ = run_tiny(tiny_cell("offline.full", tmp_path), trace=1,
                            seconds=1.5)
    metrics = result["metrics"]
    for metric in ("launch_ms.offline", "upload_host_ms.offline"):
        assert metrics[metric]["value"] > 0
    # device times and gaps: not on the CPU
    assert "gap_ms.offline" not in metrics
    assert not any(k.startswith("tp.") for k, _ in
                   result["breakdown"]["idle_gaps"])
    profiling.reset()
    result, _, _ = run_tiny(tiny_cell("train.full", tmp_path), trace=1,
                            seconds=2.0)
    metrics = result["metrics"]
    for metric in ("data_wait_ms.train", "batch_upload_ms.train",
                   "step_host_ms.train", "readback_ms.train"):
        assert metric in metrics
    assert metrics["step_host_ms.train"]["value"] > 0
    assert "gap_ms.train" not in metrics
    profiling.reset()
