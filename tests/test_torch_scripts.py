"""The port's scripts on the CPU: ``scripts/torch_quickstart.py`` runs
its chain (fixture, native loader, training, checkpoint, Detector,
global-frame mAP, submission CSV), also on 3-sweep samples, and
``scripts/torch_visualize.py`` writes the same PNG as
``scripts/visualize.py`` on the same synthetic scene, and one with a
checkpoint's predictions. ``scripts/torch_rehearsal_dataset.py`` writes the
same bytes as ``scripts/rehearsal_dataset.py`` for the same arguments;
``scripts/torch_export_artifact.py`` writes the same msgpack as
``scripts/export_artifact.py`` from the same run directory (raw and EMA
picks); ``scripts/torch_gt_sampling_ablation.py`` draws the same scene
pools, GT-sampled batches and CBGS pool as the JAX script's code for the
same seed, and its three arms run a step each."""

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


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_rehearsal_dataset_matches_jax_script(tmp_path, monkeypatch):
    args = ["--scenes", "1", "--samples-per-scene", "2",
            "--sweeps-per-sample", "2", "--num-objects", "3",
            "--points-per-object", "40", "--clutter", "400", "--seed", "5"]
    port = str(tmp_path / "port")
    res = _script("torch_rehearsal_dataset").main(["--root", port] + args)
    assert res["samples"] == 2 and os.path.isdir(res["json_dir"])
    want = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["rehearsal_dataset.py", "--root", want]
                        + args)
    _script("rehearsal_dataset").main()
    got, ref = _tree_bytes(port), _tree_bytes(want)
    assert sorted(got) == sorted(ref) and len(got) > 5
    for name in ref:
        assert got[name] == ref[name], name


@pytest.mark.parametrize("pick", ["raw", "ema"])
def test_export_artifact_matches_jax_script(tmp_path, monkeypatch, pick):
    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.train.checkpoint import (
        export_inference_checkpoint, save_checkpoint,
    )
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.weights import load_flax_msgpack

    cfg = tiny_config()
    run = tmp_path / "run"
    run.mkdir()
    state = create_train_state(cfg, TrainConfig(batch_size=1), seed=4,
                               device="cpu")
    save_checkpoint(str(run / "ckpt.msgpack"), state, config=cfg)
    export_inference_checkpoint(str(run / "ckpt.msgpack.ema"),
                                create_train_state(cfg, TrainConfig(),
                                                   seed=9, device="cpu"),
                                config=cfg)
    m_ema = 0.4 if pick == "raw" else 0.6
    with open(run / "train.log", "w") as f:
        f.write('{"event": "start", "steps": 2, "batch": 1, '
                '"device": "cpu"}\nnot json\n')
        f.write('{"event": "eval", "step": 1, "mAP": 0.1, "mAP_ema": 0.9}\n')
        f.write('{"event": "eval", "step": 2, "mAP": 0.5, "mAP_ema": '
                f'{m_ema}}}\n')
    got = str(tmp_path / "port" / "a.msgpack")
    res = _script("torch_export_artifact").main(["--run", str(run),
                                                 "--out", got])
    assert res["ema"] == (pick == "ema")
    assert os.path.exists(tmp_path / "port" / "PROVENANCE.md")
    want = str(tmp_path / "jax" / "a.msgpack")
    monkeypatch.setattr(sys, "argv", ["export_artifact.py", "--run",
                                      str(run), "--out", want])
    _script("export_artifact").main()
    assert open(got, "rb").read() == open(want, "rb").read()
    tree = load_flax_msgpack(got)
    assert "opt_state" not in tree
    if pick == "raw":
        ref = state.model.state_dict()
        from tpu_pillars_torch.weights import params_from_flax

        loaded = params_from_flax({"params": tree["params"],
                                   "batch_stats": tree["batch_stats"]}, cfg)
        for name, value in ref.items():
            if name in loaded:
                assert torch.equal(torch.as_tensor(loaded[name]), value), name


def _jax_ablation_stream(seed, batch, sampler_target, n_batches):
    """The JAX script's pools and batches (scripts/gt_sampling_ablation.py
    main, line for line) from the JAX package."""
    from tpu_pillars.config import tiny_config as jax_tiny
    from tpu_pillars.data.gt_sampler import (
        GTDatabase, GTSampleConfig, GTSampler,
    )
    from tpu_pillars.data.synthetic import make_scene, scenes_to_train_batch

    cfg = jax_tiny()
    CAR, PED = 0, 7
    rng = np.random.default_rng(seed)
    train = [make_scene(rng, cfg, num_objects=3, points_per_object=200,
                        clutter=300, class_subset=[CAR]) for _ in range(10)]
    train += [make_scene(rng, cfg, num_objects=3, points_per_object=200,
                         clutter=300, class_subset=[CAR, PED])
              for _ in range(2)]
    eval_rng = np.random.default_rng(seed + 1000)
    evals = [make_scene(eval_rng, cfg, num_objects=4, points_per_object=200,
                        clutter=300, class_subset=[CAR, PED])
             for _ in range(6)]
    db = GTDatabase.from_scenes(train, cfg.num_classes)
    sampler = (GTSampler(db, GTSampleConfig(
        target_per_class={PED: sampler_target}))
        if sampler_target else None)
    brng = np.random.default_rng(seed + 7)
    out = []
    for _ in range(n_batches):
        idx = brng.choice(len(train), batch, replace=False)
        scenes = [train[i] for i in idx]
        if sampler is not None:
            aug = []
            for s in scenes:
                pts, gb, gc = sampler(brng, s.points, s.gt_boxes,
                                      s.gt_classes, max_total=8)
                aug.append(type(s)(pts, gb, gc, []))
            scenes = aug
        out.append(scenes_to_train_batch(scenes, cfg, 8))
    return train, evals, out


def test_ablation_streams_match_jax_script():
    from tpu_pillars.train.data import class_balanced_tokens as jax_cbgs
    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.data.gt_sampler import (
        GTDatabase, GTSampleConfig, GTSampler,
    )

    abl = _script("torch_gt_sampling_ablation")
    cfg = tiny_config()
    train, evals = abl.make_pools(cfg, 0)
    for target in (0, 3):
        j_train, j_evals, j_batches = _jax_ablation_stream(0, 4, target, 3)
        for a, b in zip(train + evals, j_train + j_evals):
            np.testing.assert_array_equal(a.points, b.points)
            np.testing.assert_array_equal(a.gt_boxes, b.gt_boxes)
            np.testing.assert_array_equal(a.gt_classes, b.gt_classes)
        db = GTDatabase.from_scenes(train, cfg.num_classes)
        sampler = (GTSampler(db, GTSampleConfig(
            target_per_class={abl.PED: target})) if target else None)
        stream = abl.batches(train, cfg, 4, sampler, 7)
        for want in j_batches:
            got = next(stream)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
        if target:
            # the sampler pasted pedestrians
            assert (np.asarray(j_batches[0][3])[np.asarray(
                j_batches[0][4])] == abl.PED).sum() > 2

    class _B:
        def __init__(self, label):
            self.label = label

    class _Pool:
        def sample_tokens(self):
            return [str(i) for i in range(len(train))]

        def get_boxes_lidar(self, tok):
            return [_B(cfg.class_names[int(c)])
                    for c in train[int(tok)].gt_classes]

    from tpu_pillars.config import tiny_config as jax_tiny

    want = [int(t) for t in jax_cbgs(_Pool(), jax_tiny(), seed=0, ratio=1.0)]
    assert abl.cbgs_pool(train, cfg, 0) == want


def test_ablation_arms_run_on_the_cpu():
    res = _script("torch_gt_sampling_ablation").main(
        ["--steps", "1", "--cpu", "--cbgs"])
    assert set(res) == {"baseline", "gt_sampling", "cbgs"}
    for r in res.values():
        assert np.isfinite(r["final_loss"])
        assert 0.0 <= r["mAP"] <= 1.0
        assert 0.0 <= r["fit_mAP"] <= 1.0
        assert r["preds"] >= 0 and r["fit_preds"] >= 0
