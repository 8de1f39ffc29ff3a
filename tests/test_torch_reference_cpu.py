"""tpu_pillars_torch's CPU reference (``reference_cpu``) and
``Detector.from_torch`` against the JAX package on the CPU, at the tiny
config, inputs from a numpy seed.

* The reference functions are copies, so they must be bit-equal to the JAX
  ones: ``pillarize_np`` (the multi-sweep dt channel and an empty cloud
  included), ``decode_boxes_np``, ``rotated_nms_np``, ``postprocess_np``,
  ``flax_to_torch``, ``torch_to_flax``, ``TorchPointPillars.forward`` and
  ``CPUReferenceDetector.predict``.
* The port's ``Detector(device="cpu")`` against the port's reference, at
  the tolerance of tests/test_detector_e2e.py::
  test_jitted_pipeline_matches_cpu_reference (score 1e-4, centre and size
  5e-3, yaw 5e-3).
* ``Detector.from_torch`` from a state dict, a ``torch.save`` path and an
  ``nn.Module``: equal boxes, and the JAX ``Detector.from_torch``'s boxes
  at the tolerance tests/test_torch_detector.py holds the port to."""

import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene
from tpu_pillars.detector import Detector as JaxDetector
from tpu_pillars.reference_cpu import convert as jconvert
from tpu_pillars.reference_cpu import model as jmodel
from tpu_pillars.reference_cpu import pillarizer as jpillarizer
from tpu_pillars.reference_cpu import pipeline as jpipeline
from tpu_pillars.reference_cpu import postprocess as jpost
from torch_port_util import assert_packed_close, random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import reference_cpu as tref
from tpu_pillars_torch.detector import Detector
from tpu_pillars_torch.ops.anchors import make_anchors
from tpu_pillars_torch.reference_cpu import convert as tconvert
from tpu_pillars_torch.reference_cpu import model as tmodel
from tpu_pillars_torch.reference_cpu import postprocess as tpost
from tpu_pillars_torch.weights import params_from_flax

CFG, TCFG = tiny_config(), tconfig.tiny_config()
MS = dict(num_sweeps=3, max_points=8192, max_pillars=768,
          max_points_per_pillar=24)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the same torch reductions in the same order in
    both packages' models, and a light load beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(rng, cfg, n, f=4, margin=2.0):
    pts = np.zeros((n, f), np.float32)
    pts[:, 0] = rng.uniform(cfg.x_min - margin, cfg.x_max + margin, n)
    pts[:, 1] = rng.uniform(cfg.y_min - margin, cfg.y_max + margin, n)
    pts[:, 2] = rng.uniform(cfg.z_min - 0.5, cfg.z_max + 0.5, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    if f > 4:
        pts[:, 4] = rng.choice([0.0, 0.1, 0.2], n)       # sweep lags
    return pts


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _assert_sd_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", ["single", "multisweep", "dense", "empty"])
def test_pillarize_np_bit_equal(case, rng):
    kw = MS if case == "multisweep" else {}
    cfg, tcfg = tiny_config(**kw), tconfig.tiny_config(**kw)
    f = cfg.num_input_features
    if case == "empty":
        pts = np.zeros((0, f), np.float32)
    elif case == "dense":
        # far over both budgets: pillars and points per pillar truncate
        pts = _cloud(rng, tiny_config(x_min=-2.0, x_max=2.0, y_min=-2.0,
                                      y_max=2.0), 3000)
        pts = np.concatenate([pts, _cloud(rng, cfg, 3000)])
    else:
        pts = _cloud(rng, cfg, 1500, f)
    want = jpillarizer.pillarize_np(pts, cfg)
    got = tref.pillarize_np(pts, tcfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if case == "multisweep":                   # the dt column passes through
        assert set(np.unique(got[0][got[1]][:, 4])) <= {0.0, np.float32(0.1),
                                                        np.float32(0.2)}


def test_decode_and_wrap_bit_equal(rng):
    deltas = rng.normal(0, 0.5, (500, 7)).astype(np.float32)
    anchors = np.asarray(make_anchors(TCFG)[0][:500])
    np.testing.assert_array_equal(tref.decode_boxes_np(deltas, anchors),
                                  jpost.decode_boxes_np(deltas, anchors))
    a = rng.uniform(-20, 20, 1000)
    np.testing.assert_array_equal(tpost.wrap_angle(a), jpost.wrap_angle(a))


def test_rotated_nms_np_bit_equal(rng):
    n = 120
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform(-6, 6, (n, 2))
    boxes[:, 3:6] = rng.uniform(1.0, 4.0, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[10:20] = scores[0]                       # ties keep input order
    for thr, max_out in ((0.1, 64), (0.5, 20), (0.5, 500)):
        got = tref.rotated_nms_np(boxes, scores, thr, max_out)
        want = jpost.rotated_nms_np(boxes, scores, thr, max_out)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) <= max_out


@pytest.mark.parametrize("spread", [1.0, -8.0])
def test_postprocess_np_bit_equal(spread, rng):
    """Logits around 0 (many candidates) and far below every threshold (the
    empty early return)."""
    A, K = TCFG.num_anchors, TCFG.num_classes
    cls = (rng.normal(0, 1, (A, K)) + min(spread, 0)).astype(np.float32)
    box = rng.normal(0, 0.3, (A, 7)).astype(np.float32)
    dirl = rng.normal(0, 1, (A, 2)).astype(np.float32)
    anchors, anchor_cls = make_anchors(TCFG)
    got = tpost.postprocess_np(cls, box, dirl, anchors, anchor_cls, TCFG)
    want = jpost.postprocess_np(cls, box, dirl, np.asarray(anchors),
                                np.asarray(anchor_cls), CFG)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert (len(got[0]) > 0) == (spread > 0)


def test_flax_to_torch_and_back_bit_equal():
    variables = random_variables(CFG, seed=3)
    sd = tconvert.flax_to_torch(variables, TCFG)
    _assert_sd_equal(sd, jconvert.flax_to_torch(variables, CFG))
    assert sd["pfn.bn.num_batches_tracked"].dtype == torch.long
    # the reference module's own keys, no more and no fewer
    assert set(sd) == set(tmodel.TorchPointPillars(TCFG).state_dict())
    back = tconvert.torch_to_flax(sd, TCFG)
    _assert_tree_equal(back, jconvert.torch_to_flax(sd, CFG))
    _assert_tree_equal(back, variables)                  # the round trip
    # numpy values are taken as well as tensors
    _assert_tree_equal(
        tconvert.torch_to_flax({k: v.numpy() for k, v in sd.items()}, TCFG),
        variables)
    for missing in ("pfn.bn.running_var", "rpn.ups.2.0.weight", "dir.bias"):
        partial = {k: v for k, v in sd.items() if k != missing}
        with pytest.raises(KeyError, match=missing):
            tconvert.torch_to_flax(partial, TCFG)


def test_torch_point_pillars_forward_bit_equal(rng):
    variables = random_variables(CFG, seed=3)
    sd = tconvert.flax_to_torch(variables, TCFG)
    batch = tref.pillarize_np(_cloud(rng, CFG, 1500), TCFG)
    t_in = [torch.from_numpy(a) for a in batch]
    port = tmodel.TorchPointPillars(TCFG)
    port.load_state_dict(sd)
    ref = jmodel.TorchPointPillars(CFG)
    ref.load_state_dict(sd)
    with torch.no_grad():
        got = port.eval()(*t_in)
        want = ref.eval()(*t_in)
    assert got[0].shape == (CFG.num_anchors, CFG.num_classes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_reference_detector_matches_jax(rng):
    variables = random_variables(CFG, seed=3)
    sd = tconvert.flax_to_torch(variables, TCFG)
    port = tref.CPUReferenceDetector(TCFG, sd)
    ref = jpipeline.CPUReferenceDetector(CFG, sd)
    for cloud in (make_scene(rng, CFG, num_objects=6, clutter=1000).points,
                  np.zeros((0, 4), np.float32)):
        got = port.predict(cloud, token="t0")
        want = ref.predict(cloud, token="t0")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.to_array(), w.to_array())
            assert (g.label, g.score, g.token) == (w.label, w.score, w.token)
        for g, w in zip(port.predict_raw(cloud), ref.predict_raw(cloud)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert len(got) > 0            # untrained: the empty canvas scores 0.5


def test_detector_matches_cpu_reference(rng):
    variables = random_variables(CFG, seed=5)
    det = Detector(TCFG, params_from_flax(variables, TCFG), device="cpu")
    cpu = tref.CPUReferenceDetector(TCFG,
                                    tconvert.flax_to_torch(variables, TCFG))
    checked = 0
    for _ in range(2):
        scene = make_scene(rng, CFG, num_objects=6, clutter=1000)
        got = det.predict(scene.points, token="t0")
        ref = cpu.predict(scene.points, token="t0")
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.label == r.label and g.token == "t0"
            np.testing.assert_allclose(g.score, r.score, atol=1e-4)
            np.testing.assert_allclose(g.center, r.center, atol=5e-3)
            np.testing.assert_allclose(g.wlh, r.wlh, atol=5e-3)
            assert abs((g.yaw - r.yaw + np.pi) % (2 * np.pi) - np.pi) < 5e-3
            checked += 1
    assert checked > 0


def test_from_torch_state_dict_path_and_module(rng, tmp_path):
    variables = random_variables(CFG, seed=5)
    sd = tconvert.flax_to_torch(variables, TCFG)
    path = str(tmp_path / "reference.pth")
    torch.save(sd, path)
    module = tmodel.TorchPointPillars(TCFG)
    module.load_state_dict(sd)
    dets = [Detector.from_torch(TCFG, src, device="cpu")
            for src in (sd, path, module)]
    jdet = JaxDetector.from_torch(CFG, sd)
    total = 0
    for _ in range(2):
        cloud = make_scene(rng, CFG, num_objects=6, clutter=1000).points
        packed = [d.predict_packed(cloud).numpy() for d in dets]
        np.testing.assert_array_equal(packed[1], packed[0])
        np.testing.assert_array_equal(packed[2], packed[0])
        want = np.asarray(JaxDetector.predict_packed(jdet, cloud))
        total += assert_packed_close(packed[0], want, 1e-4, 5e-3)
        boxes = dets[0].predict(cloud, token="t1")
        assert len(boxes) == int(packed[0][:, 9].sum())
    assert total > 0
    # the weights are the converted ones, bit for bit
    want_sd = params_from_flax(variables, TCFG)
    got_sd = dets[0].model.state_dict()
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
