"""The port's two scripts on the CPU: ``scripts/torch_quickstart.py`` runs
its chain (fixture, native loader, training, checkpoint, Detector,
global-frame mAP, submission CSV), also on 3-sweep samples, and
``scripts/torch_visualize.py`` writes the same PNG as
``scripts/visualize.py`` on the same synthetic scene, and one with a
checkpoint's predictions."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sweeps", [1, 3])
def test_quickstart_writes_checkpoint_map_and_csv(tmp_path, sweeps):
    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.detector import Detector

    out = str(tmp_path / "qs")
    res = _script("torch_quickstart").main(
        ["--steps", "2", "--device", "cpu", "--out", out,
         "--num-sweeps", str(sweeps)])
    assert os.path.exists(res["checkpoint"])
    assert np.isfinite(res["mAP"]) and 0.0 <= res["mAP"] <= 1.0
    assert res["native"] and res["points"] > 0
    lines = open(res["submission"]).read().strip().splitlines()
    assert lines[0] == "Id,PredictionString" and len(lines) == 7
    assert os.path.exists(os.path.join(out, "train.jsonl"))
    if sweeps == 1:
        # the checkpoint serves
        Detector.from_checkpoint(tiny_config(), res["checkpoint"],
                                 device="cpu")


def test_visualize_matches_jax_script(tmp_path, monkeypatch):
    viz = _script("torch_visualize")
    got = viz.main(["--tiny", "--size", "300", "--out",
                    str(tmp_path / "port.png")])
    jax_script = _script("visualize")
    want = str(tmp_path / "jax.png")
    monkeypatch.setattr(sys, "argv", ["visualize.py", "--tiny", "--size",
                                      "300", "--out", want])
    jax_script.main()
    assert open(got, "rb").read() == open(want, "rb").read()
    img = viz.read_png(got)
    assert img.shape == (300, 300, 3) and img.dtype == np.uint8
    assert (img == np.asarray((0, 255, 0), np.uint8)).all(-1).any()


def test_visualize_draws_checkpoint_predictions(tmp_path):
    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.train.checkpoint import save_checkpoint
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.utils.viz import CLASS_COLORS

    cfg = tiny_config()
    ckpt = str(tmp_path / "ck.msgpack")
    save_checkpoint(ckpt, create_train_state(cfg, TrainConfig(batch_size=1),
                                             seed=3, device="cpu"),
                    config=cfg)
    viz = _script("torch_visualize")
    out = viz.main(["--tiny", "--size", "256", "--checkpoint", ckpt,
                    "--device", "cpu", "--out", str(tmp_path / "p.png")])
    img = viz.read_png(out)
    assert img.shape == (256, 256, 3)
    from tpu_pillars_torch.detector import Detector

    det = Detector.from_checkpoint(cfg, ckpt, device="cpu")
    points, gt = viz.load_scene(cfg, clutter=2000)
    boxes, cls, _ = viz.predict_boxes(det, points)
    want = viz.render(points, cfg, gt, boxes, cls, 256)
    np.testing.assert_array_equal(img, want)
    if len(boxes):
        color = np.asarray(CLASS_COLORS[cls[0] % len(CLASS_COLORS)], np.uint8)
        assert (img == color).all(-1).any()
