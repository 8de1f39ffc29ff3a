"""tpu_pillars_torch's evaluation path against the JAX package on the CPU:
the Lyft mAP scorers (AP tables exactly equal: both are the same float64
numpy arithmetic), the TTA merges, ``predict_tta`` and ``evaluate_scenes``
with converted random weights (the detector tests' tolerance), the golden
held-out mAP and TTA detections of the trained checkpoint, the Lyft-format
fixture and dataset reader, ``evaluate_dataset`` and the CLI, the prefetch
thread, and the CLI's ``--dp 2`` on two CPU ranks."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.fixture import build_fixture as jax_build_fixture
from tpu_pillars.data.lyft import LyftDataset as JaxLyftDataset
from tpu_pillars.data.synthetic import make_scene as jax_make_scene
from tpu_pillars.detector import Detector as JaxDetector
from tpu_pillars.evaluation import map_eval as jax_map_eval
from tpu_pillars.evaluation import map_eval_alt as jax_map_eval_alt
from tpu_pillars.evaluation import tta as jax_tta
from tpu_pillars.evaluation.pipeline import evaluate_dataset as jax_eval_ds
from tpu_pillars.evaluation.pipeline import evaluate_scenes as jax_eval_sc
from tpu_pillars.reference_cpu.postprocess import rotated_iou_bev_np as \
    jax_iou_np
from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.data import fixture, lyft, submission, synthetic
from tpu_pillars_torch.detector import Detector, packed_to_boxes
from tpu_pillars_torch.evaluation import cli, map_eval, map_eval_alt, tta
from tpu_pillars_torch.evaluation.pipeline import (
    evaluate_dataset, evaluate_scenes,
)
from tpu_pillars_torch.reference_cpu.postprocess import rotated_iou_bev_np
from tpu_pillars_torch.train.prefetch import device_prefetch, prefetch
from tpu_pillars_torch.weights import (
    config_fingerprint, flax_msgpack_bytes, params_from_flax,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth4k.npz")
ARTIFACT = os.path.join(ROOT, "artifacts", "pointpillars_synth4k.msgpack")
CFG, TCFG = tiny_config(), tconfig.tiny_config()
SCORE_TOL, GEO_TOL = 1e-4, 5e-3      # tests/test_torch_detector.py's


# ---- scorers -------------------------------------------------------------

def _eval_lists(rng, mod):
    """GT and predictions over 3 samples and 4 classes, with exact score
    ties, duplicate predictions and near misses, as ``mod.EvalBox``."""
    names = ["car", "truck", "pedestrian", "bicycle"]
    gt, pred = [], []
    for s in range(3):
        tok = f"s{s}"
        for _ in range(6):
            cls = names[rng.integers(0, 3)]        # bicycle never in GT
            box = np.array([*rng.uniform(-20, 20, 2), rng.uniform(-1, 1),
                            *rng.uniform(1, 4, 3), rng.uniform(-3, 3)])
            gt.append(mod.EvalBox(tok, cls, box, -1.0))
            for _ in range(rng.integers(0, 3)):
                jit = box + rng.normal(0, 0.3, 7) * [1, 1, 0.3, 0.2, 0.2,
                                                     0.2, 0.2]
                pred.append(mod.EvalBox(tok, cls, jit,
                                        float(rng.choice([0.9, 0.5, 0.3]))))
        for _ in range(3):                           # false positives
            box = np.array([*rng.uniform(-20, 20, 2), 0.0, 2.0, 4.0, 1.5,
                            0.0])
            pred.append(mod.EvalBox(tok, names[rng.integers(0, 4)], box,
                                    float(rng.choice([0.9, 0.4]))))
    return gt, pred, names


@pytest.mark.parametrize("scorer", ["lyft_map", "lyft_map_alt"])
@pytest.mark.parametrize("match_rule", ["mask_argmax", "argmax_check"])
@pytest.mark.parametrize("tie_order", ["stable", "numpy", "reversed"])
def test_lyft_map_tables_equal_jax(scorer, match_rule, tie_order):
    want_fn = (jax_map_eval.lyft_map if scorer == "lyft_map"
               else jax_map_eval_alt.lyft_map_alt)
    got_fn = (map_eval.lyft_map if scorer == "lyft_map"
              else map_eval_alt.lyft_map_alt)
    jgt, jpred, names = _eval_lists(np.random.default_rng(11), jax_map_eval)
    tgt, tpred, _ = _eval_lists(np.random.default_rng(11), map_eval)
    want, wtable = want_fn(jgt, jpred, names, match_rule=match_rule,
                           tie_order=tie_order)
    got, gtable = got_fn(tgt, tpred, names, match_rule=match_rule,
                         tie_order=tie_order)
    assert got == want and 0.0 < got < 1.0
    assert list(gtable) == list(wtable)
    for t in wtable:
        np.testing.assert_array_equal(gtable[t], wtable[t])
    assert np.isnan(gtable[0.5][3])                  # no bicycle GT


def test_iou_np_and_3d_match_jax():
    rng = np.random.default_rng(2)
    b1 = rng.uniform(-3, 3, (9, 7))
    b2 = rng.uniform(-3, 3, (7, 7))
    b1[:, 3:6] = np.abs(b1[:, 3:6]) + 0.5
    b2[:, 3:6] = np.abs(b2[:, 3:6]) + 0.5
    np.testing.assert_array_equal(rotated_iou_bev_np(b1, b2),
                                  jax_iou_np(b1, b2))
    np.testing.assert_array_equal(map_eval.iou_3d_np(b1, b2),
                                  jax_map_eval.iou_3d_np(b1, b2))
    np.testing.assert_array_equal(map_eval_alt.iou_3d_pairwise(b1, b2),
                                  jax_map_eval_alt.iou_3d_pairwise(b1, b2))


# ---- TTA merges ----------------------------------------------------------

def _row(x, y, yaw, score, cls=0, w=2.0, l=4.0):
    return np.asarray([x, y, 0.0, w, l, 1.6, yaw, score, cls, 1.0],
                      np.float32)


def _union():
    """Two views' detections: overlapping same-class pairs, a pi-flipped
    duplicate, a seam-straddling pair, a cross-class overlap and lone
    boxes, with a score tie."""
    return np.stack([
        _row(0.0, 0.0, 0.1, 0.9), _row(0.4, 0.1, 0.15, 0.6),
        _row(0.2, -0.1, 0.1 + np.pi, 0.6),
        _row(10.0, 5.0, np.pi - 0.05, 0.5, cls=1),
        _row(10.1, 5.0, -np.pi + 0.05, 0.45, cls=1),
        _row(10.0, 5.0, 0.0, 0.8, cls=2),
        _row(30.0, 30.0, -0.5, 0.8, cls=2),
        _row(-12.0, 3.0, 1.0, 0.3, cls=0),
        _row(-12.5, 3.2, 1.1, 0.7, cls=0),
    ])


@pytest.mark.parametrize("method", ["nms", "wbf"])
def test_merge_packed_matches_jax(method):
    union = _union()
    want = jax_tta.merge_packed(union.copy(), CFG, method=method,
                                num_views=2)
    got = tta.merge_packed(union.copy(), TCFG, method=method, num_views=2,
                           device="cpu")
    assert got.shape == want.shape and len(got) >= 5
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert tta.merge_packed(union[:0], TCFG, method=method).shape == (0, 10)


def test_merge_nms_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tta.merge_packed(_union(), TCFG, method="nms")
    with pytest.raises(ValueError):
        tta.merge_packed(_union(), TCFG, method="mean")


def test_flips_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 10, (50, 4)).astype(np.float32)
    boxes = rng.normal(0, 5, (20, 7)).astype(np.float32)
    for mode in tta.MODES:
        np.testing.assert_array_equal(tta.flip_points(pts, mode),
                                      jax_tta.flip_points(pts, mode))
        np.testing.assert_array_equal(tta.unflip_boxes(boxes, mode),
                                      jax_tta.unflip_boxes(boxes, mode))
    with pytest.raises(ValueError):
        tta.flip_points(pts, "z")


# ---- the detector through TTA and evaluation (random weights) -----------

@pytest.fixture(scope="module")
def detectors():
    variables = random_variables(CFG, seed=5)
    return (JaxDetector(CFG, variables),
            Detector(TCFG, params_from_flax(variables, TCFG), device="cpu"),
            variables)


def _boxes_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.label == w.label
        assert abs(g.score - w.score) < SCORE_TOL
        np.testing.assert_allclose(g.to_array()[:6], w.to_array()[:6],
                                   atol=GEO_TOL)
        dyaw = (g.yaw - w.yaw + np.pi) % (2 * np.pi) - np.pi
        assert abs(dyaw) < GEO_TOL


@pytest.mark.parametrize("merge", ["nms", "wbf"])
def test_predict_tta_matches_jax(detectors, merge):
    jdet, tdet, _ = detectors
    scene = jax_make_scene(np.random.default_rng(4), CFG, num_objects=6,
                           clutter=1000)
    want = jax_tta.predict_tta(jdet, scene.points, merge=merge, token="t")
    got = tta.predict_tta(tdet, scene.points, merge=merge, token="t")
    assert len(want) > 0
    _boxes_close(got, want)
    assert all(b.token == "t" for b in got)


def test_evaluate_scenes_matches_jax(detectors):
    jdet, tdet, _ = detectors
    rng = np.random.default_rng(8)
    scenes = [jax_make_scene(rng, CFG, num_objects=6, clutter=1000)
              for _ in range(2)]
    want, wtable = jax_eval_sc(jdet, scenes)
    got, gtable = evaluate_scenes(tdet, scenes)
    assert abs(got - want) < 1e-6
    assert list(gtable) == list(wtable)


# ---- the trained checkpoint's golden evaluation --------------------------

def test_golden_heldout_map_scores_the_jax_detections():
    """The port's scorer on the golden file's JAX detections of the 8
    held-out scenes, with GT from the port's ``make_scene`` (seed 7100),
    gives the JAX ``evaluate_scenes`` mAP stored beside them."""
    cfg = tconfig.PillarsConfig()
    golden = np.load(GOLDEN)
    rng = np.random.default_rng(7100)
    scenes = [synthetic.make_scene(rng, cfg) for _ in range(8)]
    offs = golden["offsets"]
    gt, pred = [], []
    for s, sc in enumerate(scenes):
        np.testing.assert_array_equal(sc.points,
                                      golden["points"][offs[s]:offs[s + 1]])
        tok = f"scene{s}"
        pred += [map_eval.EvalBox.from_box3d(b) for b in packed_to_boxes(
            golden["packed"][s], cfg, token=tok)]
        gt += [map_eval.EvalBox(tok, cfg.class_names[int(c)],
                                np.asarray(b, np.float64), -1.0)
               for b, c in zip(sc.gt_boxes, sc.gt_classes)]
    got, _ = map_eval.lyft_map(gt, pred, cfg.class_names)
    assert got == pytest.approx(float(golden["map_heldout"]), abs=1e-12)
    assert 0.4 < got < 0.6


def test_golden_tta_detections_on_one_scene():
    """The port's ``predict_tta`` (4 views, WBF) on the trained checkpoint
    at the full config reproduces the JAX TTA detections of a held-out
    scene at the trained-weights tolerance."""
    cfg = tconfig.PillarsConfig()
    det = Detector.from_checkpoint(cfg, ARTIFACT, device="cpu")
    golden = np.load(GOLDEN)
    offs = golden["offsets"]
    got = tta.predict_tta(det, golden["points"][offs[1]:offs[2]],
                          merge="wbf")
    want = golden["tta_packed"][1]
    n = int(want[:, 9].sum())
    assert len(got) == n > 0
    for g, w in zip(got, want[:n]):
        assert g.label == cfg.class_names[int(w[8])]
        assert abs(g.score - w[7]) < 1e-3
        np.testing.assert_allclose(g.to_array()[:6], w[:6], atol=1e-2)
        assert abs((g.yaw - w[6] + np.pi) % (2 * np.pi) - np.pi) < 1e-2


# ---- the Lyft-format fixture, the dataset and evaluate_dataset -----------

@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lyft_port_fixture")
    kw = dict(num_scenes=1, samples_per_scene=3, sweeps_per_sample=2,
              seed=5)
    tdir = fixture.build_fixture(str(root / "port"), TCFG, **kw)
    jdir = jax_build_fixture(str(root / "jax"), CFG, **kw)
    return tdir, jdir


def test_fixture_and_dataset_match_jax(fixture_dirs):
    tdir, jdir = fixture_dirs
    for name in sorted(os.listdir(jdir)):
        with open(os.path.join(tdir, name)) as f, \
                open(os.path.join(jdir, name)) as g:
            assert json.load(f) == json.load(g), name
    tds, jds = lyft.LyftDataset(tdir), JaxLyftDataset(jdir)
    toks = tds.sample_tokens()
    assert toks == jds.sample_tokens() and len(toks) == 3
    for tok in toks:
        tsd, jsd = tds.lidar_sample_data(tok), jds.lidar_sample_data(tok)
        np.testing.assert_array_equal(tds.load_point_cloud(tsd),
                                      jds.load_point_cloud(jsd))
        np.testing.assert_array_equal(tds.load_sweeps(tok, 2),
                                      jds.load_sweeps(tok, 2))
        for get in ("get_boxes_global", "get_boxes_lidar"):
            tb, jb = getattr(tds, get)(tok), getattr(jds, get)(tok)
            assert [b.label for b in tb] == [b.label for b in jb]
            np.testing.assert_array_equal(
                np.stack([b.to_array() for b in tb]),
                np.stack([b.to_array() for b in jb]))
    with pytest.raises(FileNotFoundError):
        lyft.LyftDataset(os.path.dirname(tdir))


def test_evaluate_dataset_matches_jax(detectors, fixture_dirs, tmp_path):
    jdet, tdet, _ = detectors
    tdir, jdir = fixture_dirs
    tds, jds = lyft.LyftDataset(tdir), JaxLyftDataset(jdir)
    want, _, wpred = jax_eval_ds(jdet, jds, batch_size=2)
    got, table, gpred = evaluate_dataset(tdet, tds, batch_size=2)
    assert abs(got - want) < 1e-6 and len(table) == 10
    assert list(gpred) == list(wpred)
    for tok in wpred:
        _boxes_close(gpred[tok], wpred[tok])
    # the batched path is the per-sample path, box for box
    for tok in tds.sample_tokens():
        sd = tds.lidar_sample_data(tok)
        single = tdet.predict(tds.load_point_cloud(sd)[:, :4], token=tok,
                              lidar_to_global=tds.lidar_to_global(sd))
        assert len(single) == len(gpred[tok])
        for a, b in zip(single, gpred[tok]):
            np.testing.assert_allclose(a.to_array(), b.to_array(),
                                       atol=1e-5)
    # the identity view set reproduces the plain path exactly
    got1, _, gpred1 = evaluate_dataset(tdet, tds, batch_size=2,
                                       tta_modes=("none",), tta_merge="nms")
    assert got1 == got
    for tok in gpred:
        assert [b.to_array().tolist() for b in gpred1[tok]] == \
            [b.to_array().tolist() for b in gpred[tok]]
    # the submission writer round-trips the predictions
    path = str(tmp_path / "sub.csv")
    submission.write_submission(path, gpred)
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Id", "PredictionString"] and len(rows) == 4
    for tok, s in rows[1:]:
        assert len(submission.parse_prediction_string(s)) == len(gpred[tok])


def _write_ckpt(variables, path):
    with open(path, "wb") as f:
        f.write(flax_msgpack_bytes({
            "step": np.asarray(0, np.int32), "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "config_fp": config_fingerprint(TCFG)}))
    return path


def test_cli_matches_jax_mAP(detectors, fixture_dirs, tmp_path, capsys):
    jdet, _, variables = detectors
    tdir, jdir = fixture_dirs
    ckpt = _write_ckpt(variables, str(tmp_path / "ck.msgpack"))
    out = str(tmp_path / "metrics.json")
    sub = str(tmp_path / "sub.csv")
    cli.main(["--data", tdir, "--ckpt", ckpt, "--device", "cpu", "--batch",
              "2", "--out", out, "--submission", sub])
    assert "Lyft mAP(0.5:0.95)" in capsys.readouterr().out
    with open(out) as f:
        metrics = json.load(f)
    want, _, _ = jax_eval_ds(jdet, JaxLyftDataset(jdir), batch_size=2)
    assert abs(metrics["mAP"] - want) < 1e-6
    assert metrics["num_samples"] == 3 and len(metrics["ap"]) == 10
    assert os.path.exists(sub)


# ---- data parallel ----------------------------------------------------------

def test_data_parallel_cli_scores_what_one_device_scores(
        detectors, fixture_dirs, tmp_path):
    """``--dp 2 --device cpu`` evaluates on two gloo ranks and scores what
    ``--dp 1`` (one device, as in the JAX CLI) scores, within
    tests/test_eval_pipeline.py:84's 1e-9; rank 0 alone writes the
    metrics. ``--dp 1`` scores what ``evaluate_dataset`` scores."""
    _, tdet, variables = detectors
    ckpt = _write_ckpt(variables, str(tmp_path / "ck.msgpack"))
    metrics = {}
    for dp in ("1", "2"):
        out = str(tmp_path / f"metrics_dp{dp}.json")
        cli.main(["--data", fixture_dirs[0], "--ckpt", ckpt, "--device",
                  "cpu", "--batch", "2", "--dp", dp, "--out", out])
        with open(out) as f:
            metrics[dp] = json.load(f)
    want, _, _ = evaluate_dataset(tdet, lyft.LyftDataset(fixture_dirs[0]),
                                  batch_size=2)
    assert metrics["1"]["num_samples"] == 3 and metrics["1"]["mAP"] == want
    assert metrics["2"]["num_samples"] == 3
    assert metrics["2"]["mAP"] == pytest.approx(want, abs=1e-9)


# ---- prefetch ---------------------------------------------------------------

def test_prefetch_preserves_sequence():
    src = [np.full((3,), i) for i in range(20)]
    out = list(prefetch(iter(src), size=3))
    assert len(out) == 20
    for a, b in zip(src, out):
        np.testing.assert_array_equal(a, b)


def test_prefetch_forwards_exception_in_order():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = prefetch(gen(), size=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_early_close_stops_producer():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetch(gen(), size=2)
    assert next(it) == 0
    it.close()
    n = len(produced)
    assert n < 100
    import time
    time.sleep(0.3)
    assert len(produced) <= n + 3


def test_device_prefetch_moves_batches():
    batches = [(np.arange(4, dtype=np.float32) + i,
                {"n": torch.tensor([i])}) for i in range(3)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    for i, (a, d) in enumerate(out):
        assert torch.is_tensor(a) and a.device.type == "cpu"
        assert torch.equal(a, torch.arange(4, dtype=torch.float32) + i)
        assert int(d["n"]) == i
