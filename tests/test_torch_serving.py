"""tpu_pillars_torch's serving extras against the JAX package on the CPU,
at the tiny config, inputs from a numpy seed.

* The 2-byte wires (``Detector(wire_dtype=torch.float16 | torch.int16)``):
  ``pad_points`` bit-equal to the JAX ``pad_points`` with the same wire,
  the dequantized points bit-equal to JAX's ``points.astype(f32) *
  scales``; the f16 logits within tests/test_wire_f16.py's measures of the
  f32 wire; the int16 boxes within tests/test_detector_e2e.py::
  test_int16_wire_near_exact's tolerance of the f32 wire and within the
  port-vs-JAX detector tolerance of the JAX int16 ``Detector``.
* ``predict_stream``, threaded and serial, equal to ``predict`` bit for
  bit and in order; ``detections_to_boxes`` equal to the JAX function.
* ``data.stream.SweepAccumulator`` equal to the JAX one bit for bit and to
  the port's ``LyftDataset.load_sweeps`` on every keyframe of a fixture,
  with tests/test_stream.py's cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.stream import SweepAccumulator as JaxAccumulator
from tpu_pillars.data.synthetic import make_scene
from tpu_pillars.detector import Detector as JaxDetector
from tpu_pillars.detector import detections_to_boxes as jax_det_to_boxes
from tpu_pillars.geometry.quaternion import quat_from_yaw
from tpu_pillars.geometry.transforms import Pose as JaxPose
from tpu_pillars.ops.postprocess import Detections as JaxDetections
from torch_port_util import assert_packed_close, random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import detector as tdet
from tpu_pillars_torch.data.fixture import build_fixture
from tpu_pillars_torch.data.lyft import LyftDataset
from tpu_pillars_torch.data.stream import SweepAccumulator
from tpu_pillars_torch.geometry.transforms import Pose
from tpu_pillars_torch.ops.postprocess import Detections
from tpu_pillars_torch.weights import params_from_flax

CFG, TCFG = tiny_config(), tconfig.tiny_config()
MS = dict(num_sweeps=3, max_points=8192, max_pillars=768,
          max_points_per_pillar=24)
WIRES = {"f16": (torch.float16, jnp.float16),
         "int16": (torch.int16, jnp.int16)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(wire, seed=5, **kw):
    """The JAX and the port Detector on the same random weights."""
    cfg, tcfg = tiny_config(**kw), tconfig.tiny_config(**kw)
    variables = random_variables(cfg, seed=seed)
    jw = {} if wire is None else {"wire_dtype": WIRES[wire][1]}
    tw = {} if wire is None else {"wire_dtype": WIRES[wire][0]}
    return (JaxDetector(cfg, variables, **jw),
            tdet.Detector(tcfg, params_from_flax(variables, tcfg),
                          device="cpu", **tw), cfg)


def _ms_cloud(rng, cfg, n):
    pts = np.zeros((n, 5), np.float32)
    pts[:, 0] = rng.uniform(cfg.x_min - 2, cfg.x_max + 2, n)
    pts[:, 1] = rng.uniform(cfg.y_min - 2, cfg.y_max + 2, n)
    pts[:, 2] = rng.uniform(cfg.z_min, cfg.z_max, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    pts[:, 4] = rng.choice([0.0, 0.1, 0.2], n)
    return pts


@pytest.mark.parametrize("wire", ["f16", "int16"])
@pytest.mark.parametrize("case", ["single", "multisweep", "buckets"])
def test_wire_pad_and_dequant_bit_equal(wire, case, rng):
    kw = MS if case == "multisweep" else {}
    jdet, port, cfg = _pair(wire, **kw)
    if case == "buckets":
        buckets = (1024, cfg.max_points)
        jdet = JaxDetector(cfg, jdet.variables, wire_dtype=WIRES[wire][1],
                           wire_buckets=buckets)
        port = tdet.Detector(port.config, port.model.state_dict(),
                             device="cpu", wire_dtype=WIRES[wire][0],
                             wire_buckets=buckets)
    if case == "multisweep":
        cloud = _ms_cloud(rng, cfg, 3000)
    else:
        cloud = make_scene(rng, cfg, num_objects=4, clutter=600).points
        far = rng.uniform(500, 900, (300, 4)).astype(np.float32)
        cloud = np.concatenate([cloud, far] + [cloud] * 4)
        if case == "buckets":
            cloud = cloud[:700]
    want, jn = jdet.pad_points(cloud)
    got, tn = port.pad_points(cloud)
    assert got.dtype == want.dtype == tdet.WIRE_DTYPES[WIRES[wire][0]]
    assert got.shape == want.shape and tn == jn
    np.testing.assert_array_equal(got, want)
    if case == "buckets":
        assert got.shape[0] == 1024
    if wire == "int16":
        np.testing.assert_array_equal(port._wire_scales, jdet._wire_scales)
        want_f = np.asarray(jnp.asarray(want).astype(jnp.float32)
                            * jnp.asarray(jdet._wire_scales))
    else:
        want_f = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got_f = port.dequant(port.upload(got))
    assert got_f.dtype == torch.float32
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    # the pad rows dequantize out of the detection range
    assert (np.abs(want_f[tn:, :3]) > max(abs(cfg.x_min), abs(cfg.x_max))
            ).all()


def test_wire_dtype_rejects_others():
    sd = params_from_flax(random_variables(CFG, seed=5), TCFG)
    for bad in (torch.bfloat16, torch.float64, np.float16, "int16"):
        with pytest.raises(TypeError, match="wire_dtype"):
            tdet.Detector(TCFG, sd, device="cpu", wire_dtype=bad)


def test_f16_wire_logits_close(rng):
    """tests/test_wire_f16.py's measures on the port: median |d| of the
    class logits < 1e-3, share above 0.1 < 5%; finite boxes end to end."""
    _, det32, cfg = _pair(None)
    det16 = tdet.Detector(det32.config, det32.model.state_dict(),
                          device="cpu", wire_dtype=torch.float16)
    scene = make_scene(rng, cfg, num_objects=5, clutter=800)
    p16, n = det16.pad_points(scene.points)
    assert p16.dtype == np.float16 and np.isfinite(p16).all()
    p32, _ = det32.pad_points(scene.points)
    counts = torch.tensor([int(n)])
    c32 = det32._stage1(det32.dequant(det32.upload(p32[None])), counts)[0]
    c16 = det16._stage1(det16.dequant(det16.upload(p16[None])), counts)[0]
    dc = (c32 - c16).abs().numpy()
    assert np.median(dc) < 1e-3
    assert np.mean(dc > 0.1) < 0.05
    out16 = det16.predict(scene.points)
    assert len(out16) > 0
    assert all(np.isfinite(b.to_array()).all() for b in out16)


def test_int16_wire_boxes(rng):
    """The int16 wire against the f32 wire at tests/test_detector_e2e.py::
    test_int16_wire_near_exact's tolerance, and against the JAX int16
    Detector at the port-vs-JAX tolerance."""
    jdet16, det16, cfg = _pair("int16")
    det32 = tdet.Detector(det16.config, det16.model.state_dict(),
                          device="cpu")
    total = 0
    for _ in range(2):
        scene = make_scene(rng, cfg, num_objects=5, clutter=900)
        ref = det32.predict(scene.points)
        got = det16.predict(scene.points)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.label == r.label
            np.testing.assert_allclose(g.score, r.score, atol=2e-3)
            np.testing.assert_allclose(g.center, r.center, atol=2e-2)
            np.testing.assert_allclose(g.wlh, r.wlh, atol=2e-2)
            assert abs((g.yaw - r.yaw + np.pi) % (2 * np.pi) - np.pi) < 2e-2
        want = np.asarray(jdet16.predict_packed(scene.points))
        total += assert_packed_close(det16.predict_packed(scene.points)
                                     .numpy(), want, 1e-4, 5e-3)
    assert total > 0


@pytest.mark.parametrize("wire", [None, "int16"])
def test_predict_stream_equals_predict(wire, rng):
    _, det, cfg = _pair(wire)
    clouds = [make_scene(rng, cfg, num_objects=3, clutter=300 + 50 * i).points
              for i in range(5)]
    direct = [det.predict(c) for c in clouds]
    for kw in ({}, {"threaded": False}, {"depth": 1},
               {"threaded": False, "depth": 1}):
        streamed = list(det.predict_stream(iter(clouds), **kw))
        assert len(streamed) == len(direct)
        for xs, ys in zip(streamed, direct):
            assert len(xs) == len(ys)
            for a, b in zip(xs, ys):
                np.testing.assert_array_equal(a.to_array(), b.to_array())
                assert (a.label, a.score) == (b.label, b.score)
    assert sum(len(x) for x in direct) > 0


def test_predict_stream_raises_where_the_failed_item_was(rng):
    _, det, cfg = _pair(None)
    good = make_scene(rng, cfg, num_objects=3, clutter=300).points
    bad = np.zeros((10, 2), np.float32)               # too few columns
    out = det.predict_stream(iter([good, bad, good]))
    assert len(next(out)) == len(det.predict(good))
    with pytest.raises(ValueError, match="feature columns"):
        next(out)


def test_detections_to_boxes_matches_jax(rng):
    D = 40
    boxes = rng.normal(0, 5, (D, 7)).astype(np.float32)
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 0.5
    scores = rng.uniform(0, 1, D).astype(np.float32)
    cls = rng.integers(0, CFG.num_classes, D).astype(np.int32)
    valid = rng.uniform(0, 1, D) > 0.3
    jd = JaxDetections(*(jnp.asarray(a) for a in (boxes, scores, cls, valid)))
    td = Detections(*(torch.from_numpy(a) for a in (boxes, scores, cls,
                                                     valid)))
    q, t = np.asarray(quat_from_yaw(0.7)), np.array([10.0, -5.0, 1.0])
    for jpose, tpose in ((None, None), (JaxPose(q, t), Pose(q, t))):
        want = jax_det_to_boxes(jd, CFG, token="s", lidar_to_global=jpose)
        got = tdet.detections_to_boxes(td, TCFG, token="s",
                                       lidar_to_global=tpose)
        assert len(got) == len(want) == int(valid.sum())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.to_array(), w.to_array())
            assert (g.label, g.score, g.token) == (w.label, w.score, w.token)
    # the packed path gives the same boxes
    packed = tdet.pack_detections(td).numpy()
    for g, w in zip(tdet.detections_to_boxes(td, TCFG),
                    tdet.packed_to_boxes(packed, TCFG)):
        np.testing.assert_array_equal(g.to_array(), w.to_array())


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream") / "lyft"
    json_dir = build_fixture(str(root), TCFG, num_scenes=1,
                             samples_per_scene=3, sweeps_per_sample=3,
                             seed=11)
    return LyftDataset(json_dir)


def test_accumulator_matches_load_sweeps_and_jax(ds):
    recs = sorted(ds.tables["sample_data"].values(),
                  key=lambda sd: sd["timestamp"])
    acc, jacc = SweepAccumulator(num_sweeps=3), JaxAccumulator(num_sweeps=3)
    checked = 0
    for sd in recs:
        pts = ds.load_point_cloud(sd)
        pose = ds.lidar_to_global(sd)
        cloud = acc.push(pts, pose, sd["timestamp"])
        want = jacc.push(pts, JaxPose(pose.rotation, pose.translation),
                         sd["timestamp"])
        assert cloud.dtype == want.dtype
        np.testing.assert_array_equal(cloud, want)
        assert len(acc) == len(jacc)
        if sd.get("is_key_frame"):
            np.testing.assert_array_equal(
                cloud, ds.load_sweeps(sd["sample_token"], 3))
            checked += 1
    assert checked == 3


def test_accumulator_capacity_reset_identity_and_bad_inputs():
    rng = np.random.default_rng(0)
    acc, jacc = SweepAccumulator(num_sweeps=2), JaxAccumulator(num_sweeps=2)
    ident, jident = Pose.identity(), JaxPose.identity()
    p1, p2, p3 = (rng.normal(0, 10, (n, 4)).astype(np.float32)
                  for n in (50, 60, 70))
    for p, t in ((p1, 0.0), (p2, 1e5)):
        acc.push(p, ident, t)
        jacc.push(p, jident, t)
    out = acc.push(p3, ident, 2e5)      # p1 evicted (capacity 2)
    np.testing.assert_array_equal(out, jacc.push(p3, jident, 2e5))
    assert len(out) == 130 and len(acc) == 2
    np.testing.assert_allclose(out[:70, 4], 0.0, atol=1e-7)
    np.testing.assert_allclose(out[70:, 4], 0.1, atol=1e-7)
    acc.reset()
    assert len(acc) == 0
    out = acc.push(p1, ident, 3e5)
    assert len(out) == 50 and np.allclose(out[:, 4], 0.0)
    # identity pose: the features pass through, dt is appended
    one = SweepAccumulator(num_sweeps=1)
    pts = rng.normal(0, 5, (40, 5)).astype(np.float32)
    got = one.push(pts, Pose.identity(), 42.0)
    np.testing.assert_allclose(got[:, :5], pts, atol=1e-6)
    np.testing.assert_array_equal(got[:, 5], np.zeros(40))
    with pytest.raises(ValueError):
        acc.push(np.zeros((5, 2), np.float32), ident, 0.0)
    with pytest.raises(ValueError):
        SweepAccumulator(num_sweeps=0)
