"""Whole runs on the CPU at the tiny configuration, past the look for a
card: a sound run comes out correct, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from pillarbench.cells import ROOT
from pillarbench.tests.tiny import run_tiny, tiny_cell


def _half_batch(packed):
    out = packed.clone()
    out[out.shape[0] // 2:, :, 9] = 0.0      # no boxes for half the batch
    return out


def _altered(packed):
    out = packed.clone()
    out[..., 7] += 0.01                       # every score moved
    return out


@pytest.fixture
def broken_serving(monkeypatch):
    from tpu_pillars_torch.detector import Detector

    real = Detector.predict_packed_batch

    def install(fault):
        if fault is not None:
            monkeypatch.setattr(Detector, "predict_packed_batch",
                                lambda self, p, n: fault(real(self, p, n)))
    return install


@pytest.mark.parametrize("fault", [None, _half_batch, _altered],
                         ids=["sound", "half_batch", "altered"])
def test_serving(tmp_path, broken_serving, fault):
    broken_serving(fault)
    result, _, checks = run_tiny(tiny_cell("offline.full", tmp_path))
    assert result["correct"] is (fault is None), checks
    assert result["attempted"] > 0


def _unchanged(real):
    def step(state, batch, split=None):
        keep = [p.detach().clone() for p in state.model.parameters()]
        state, losses = real(state, batch, split)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), keep):
                p.copy_(k)
        return state, losses
    return step


def _late_unchanged(real):
    """Sound for the first steps, then the state left unchanged: only the
    window step can see it."""
    calls = [0]
    frozen = _unchanged(real)

    def step(state, batch, split=None):
        calls[0] += 1
        return (real if calls[0] <= 3 else frozen)(state, batch, split)
    return step


def _half(real):
    def step(state, batch, split=None):
        half = type(batch)(*(x[:x.shape[0] // 2] for x in batch))
        return real(state, half, split)
    return step


@pytest.mark.parametrize("fault", [None, _unchanged, _half, _late_unchanged],
                         ids=["sound", "unchanged", "half_batch",
                              "late_unchanged"])
def test_training(tmp_path, monkeypatch, fault):
    import tpu_pillars_torch.train.step as step_mod

    if fault is not None:
        real = step_mod.make_train_step
        monkeypatch.setattr(step_mod, "make_train_step",
                            lambda *a, **k: fault(real(*a, **k)))
    result, lines, checks = run_tiny(tiny_cell("train.full", tmp_path))
    assert result["correct"] is (fault is None), checks
    # the window step was reached and compared
    assert all(np.isfinite(c["value"]) for c in checks.values()), lines


def test_traced_run_reads_its_metrics(tmp_path):
    result, lines, _ = run_tiny(tiny_cell("offline.full", tmp_path),
                                trace=1, seconds=1.5)
    assert result["correct"] is True
    for name in ("pad_ms.offline", "frontend_ms.offline",
                 "rpn_head_ms.offline", "postprocess_ms.offline"):
        assert result["metrics"][name]["value"] > 0
    assert list(result)[-1] == "checks"
    assert any(line.startswith("setup split") for line in lines)


def test_no_card_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-m", "pillarbench.run",
                           "--workload", "offline.full", "--seed", "1",
                           "--seconds", "1"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_jax_in_the_process_is_refused(monkeypatch):
    from pillarbench import run

    monkeypatch.setitem(sys.modules, "jax", np)
    assert run.loaded_forbidden() == ["jax"]
