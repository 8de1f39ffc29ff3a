"""The single-sweep entry points of tpu_pillars_torch against the JAX
package on the CPU, at ``tiny_config()``:

* ``ops.voxelize.pillarize`` bit-equal to the JAX ``pillarize`` on
  tests/test_voxelize.py's cases (random cloud, hand case, points-per-pillar
  and pillar overflow, empty, out of range), for an int, a 0-d and a
  1-element count; ``pillarize_batch`` equal to ``pillarize`` row by row;
* ``ops.emit.pillarize_auto`` / ``pillarize_batch_auto`` bit-equal to the
  JAX functions of the same name (on the CPU both run the plain pillarizer);
* the single-sweep ``build_canvas_fn`` / ``build_model_fn`` against the
  JAX ``build_canvas_fn`` / ``build_model_fn`` (fused, classic with K6's
  plain version, classic with the plain PillarFeatureNet): canvas within
  tests/test_fused_pfn.py's atol 2e-4 / rtol 1e-4 (fused) or
  tests/test_pfn_pallas.py's atol 2e-5 (classic), the wire within
  tests/test_torch_model.py's rtol 1e-5 / atol 1e-4; each bit-equal to the
  port's batched form on a batch of one; against row i of a batch of
  two the canvas is bit-equal and the wire within the same tolerance (the
  RPN's convolutions round by batch size); ``build_forward_fn`` on one
  sweep bit-equal to ``Detector.predict_raw`` and, in its valid rows and
  classes, to the batch's row i;
* ``ops.nms_overlap.rotated_nms_pallas`` against the JAX function
  (tests/test_nms_pallas.py's keep-set contract), with and without
  ``class_ids``, and its valid-mask semantics;
* ``ops.postprocess.top_k_two_stage`` equal to ``lax.top_k`` (values and
  indices, heavy ties) and to ``top_k_stable``;
* the package exports ``LYFT_CLASSES`` and ``Box3D`` as the JAX one does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import tpu_pillars
from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene
from tpu_pillars.detector import build_canvas_fn as jax_canvas_fn
from tpu_pillars.detector import build_model_fn as jax_model_fn
from tpu_pillars.ops import emit_pallas as jemit
from tpu_pillars.ops import voxelize as jvox
from tpu_pillars.ops.nms import rotated_nms as jax_rotated_nms
from tpu_pillars.ops.nms_pallas import rotated_nms_pallas as jax_nms_pallas
from tpu_pillars.reference_cpu.postprocess import rotated_iou_bev_np
from torch_port_util import cloud_batch, random_variables
import tpu_pillars_torch
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import detector as tdet
from tpu_pillars_torch.ops import emit as temit
from tpu_pillars_torch.ops import nms_overlap as tnms
from tpu_pillars_torch.ops import postprocess as tpost
from tpu_pillars_torch.ops import voxelize as tvox
from tpu_pillars_torch.weights import params_from_flax

CFG, TCFG = tiny_config(), tconfig.tiny_config()
THR = 0.2
BOUNDARY_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- pillarize -------------------------------------------------------------

def _pad(points, cfg):
    out = np.full((cfg.max_points, points.shape[1]), 1e6, np.float32)
    out[:len(points)] = points
    return out, len(points)


def _random_cloud(rng, n, cfg=CFG, frac_outside=0.1):
    pts = np.zeros((n, 4), np.float32)
    span_x = cfg.x_max - cfg.x_min
    pts[:, 0] = rng.uniform(cfg.x_min - frac_outside * span_x,
                            cfg.x_max + frac_outside * span_x, n)
    pts[:, 1] = rng.uniform(cfg.y_min - 2, cfg.y_max + 2, n)
    pts[:, 2] = rng.uniform(cfg.z_min - 1, cfg.z_max + 1, n)
    pts[:, 3] = rng.uniform(0, 255, n)
    return pts


def _overflow_pillar(rng):
    n = CFG.max_points_per_pillar + 10
    pts = np.zeros((n, 4), np.float32)
    pts[:, :2] = 0.1
    pts[:, 3] = np.arange(n)
    return pts


def _overflow_pillars(rng):
    pts = np.zeros((20, 4), np.float32)
    pts[:, 0] = CFG.x_min + 0.25 + 0.5 * np.arange(20)
    pts[:, 1] = 0.1
    return pts


PILLARIZE_CASES = {
    "random": (lambda rng: _random_cloud(rng, 3000), {}),
    "hand": (lambda rng: np.array([[0.1, 0.1, 0.0, 7.0],
                                   [0.3, 0.2, 1.0, 9.0],
                                   [-5.2, 3.1, -1.0, 3.0]], np.float32), {}),
    "points_overflow": (_overflow_pillar, {}),
    "pillars_overflow": (_overflow_pillars, {"max_pillars": 8}),
    "empty": (lambda rng: np.zeros((0, 4), np.float32), {}),
    "out_of_range": (lambda rng: np.array(
        [[1e5, 0, 0, 1.0], [0, 0, CFG.z_max + 5, 1.0], [0.1, 0.1, 0.0, 1.0]],
        np.float32), {}),
}


def _assert_batch_equal(got, want):
    for name in ("features", "mask", "coords", "pillar_mask"):
        g, w = getattr(got, name), getattr(want, name)
        g = g.numpy() if torch.is_tensor(g) else g
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("count", ["int", "0-d", "1-element"])
@pytest.mark.parametrize("case", sorted(PILLARIZE_CASES))
def test_pillarize_bit_equal_to_jax(rng, case, count):
    make, kw = PILLARIZE_CASES[case]
    jcfg, tcfg = tiny_config(**kw), tconfig.tiny_config(**kw)
    padded, n = _pad(make(rng), jcfg)
    want = jvox.pillarize(jnp.asarray(padded), jnp.int32(n), jcfg)
    n_t = {"int": n, "0-d": torch.tensor(n),
           "1-element": torch.tensor([n], dtype=torch.int32)}[count]
    got = tvox.pillarize(torch.from_numpy(padded), n_t, tcfg)
    assert got.features.shape == (tcfg.max_pillars,
                                  tcfg.max_points_per_pillar,
                                  tcfg.num_decorated_features)
    _assert_batch_equal(got, want)
    if case == "points_overflow":
        np.testing.assert_array_equal(
            got.features[0, :, 3].numpy(),
            np.arange(tcfg.max_points_per_pillar))
    if case == "pillars_overflow":
        np.testing.assert_array_equal(got.coords[:, 1].numpy(), np.arange(8))
    if case == "empty":
        assert not got.pillar_mask.any() and not got.features.any()


def test_pillarize_batch_equals_pillarize_by_row(rng):
    pts, ns = cloud_batch(rng, [2500, 10, 0, 4096], TCFG)
    batch = tvox.pillarize_batch(torch.from_numpy(pts), torch.from_numpy(ns),
                                 TCFG)
    for i in range(len(ns)):
        one = tvox.pillarize(torch.from_numpy(pts[i]), int(ns[i]), TCFG)
        for name in ("features", "mask", "coords", "pillar_mask"):
            assert torch.equal(getattr(batch, name)[i],
                               getattr(one, name)), (i, name)


def test_pillarize_auto_matches_jax(rng):
    pts, ns = cloud_batch(rng, [3000, 0], TCFG)
    for i in range(2):
        want = jemit.pillarize_auto(jnp.asarray(pts[i]), jnp.int32(ns[i]),
                                    CFG)
        for n in (int(ns[i]), torch.tensor(ns[i]),
                  torch.tensor(ns[i:i + 1])):
            got = temit.pillarize_auto(torch.from_numpy(pts[i]), n, TCFG)
            _assert_batch_equal(got, want)
    want = jemit.pillarize_batch_auto(jnp.asarray(pts), jnp.asarray(ns), CFG)
    got = temit.pillarize_batch_auto(torch.from_numpy(pts),
                                     torch.from_numpy(ns), TCFG)
    _assert_batch_equal(got, want)


# ---- the single-sweep build functions -------------------------------------

FRONT_ENDS = {
    "fused": dict(fused_frontend=True),
    "classic_k6": dict(fused_frontend=False, use_pallas_pfn=True),
    "classic_plain": dict(fused_frontend=False, use_pallas_pfn=False),
}


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(11)
    variables = random_variables(CFG, seed=5)
    clouds = [make_scene(rng, CFG, num_objects=6, clutter=1000).points
              for _ in range(2)]
    return variables, clouds


def _port_model(variables):
    return tdet.Detector(TCFG, params_from_flax(variables, TCFG),
                         device="cpu")


@pytest.mark.parametrize("front", sorted(FRONT_ENDS))
def test_single_sweep_build_fns_match_jax_and_batched_rows(scenes, front):
    kw = FRONT_ENDS[front]
    variables, clouds = scenes
    port = _port_model(variables)
    padded = [port.pad_points(c) for c in clouds]
    pts = torch.from_numpy(np.stack([p for p, _ in padded]))
    ns = torch.from_numpy(np.asarray([n for _, n in padded], np.int64))
    model_fn = tdet.build_model_fn(port.model, TCFG, **kw)
    canvas_b = model_fn.canvas(pts, ns)
    wire_b = model_fn(pts, ns)
    j_canvas = jax_canvas_fn(CFG, **kw)
    j_model = jax_model_fn(CFG, **kw)
    canvas_tol = ({"atol": 2e-4, "rtol": 1e-4} if front == "fused"
                  else {"atol": 2e-5, "rtol": 0})
    for i, (p, n) in enumerate(padded):
        one = torch.from_numpy(p)
        canvas = model_fn.canvas(one, torch.tensor(n))
        assert canvas.shape == (TCFG.grid_h, TCFG.grid_w,
                                TCFG.pfn_channels)
        assert torch.equal(canvas, canvas_b[i])
        wire = model_fn(one, n)
        assert [tuple(t.shape) for t in wire] == [
            (TCFG.num_anchors,), (7, TCFG.num_anchors),
            (2, TCFG.num_anchors)]
        # the batched stage on a batch of one, bit for bit; against the
        # rows of a batch of two the RPN's convolutions round by batch
        # size (the canvas does not), so the wire is held to a tolerance
        for g, b1, b in zip(wire, model_fn(pts[i:i + 1], ns[i:i + 1]),
                            wire_b):
            assert torch.equal(g, b1[0])
            torch.testing.assert_close(g, b[i], rtol=1e-5, atol=1e-4)
        for g, b in zip(model_fn.wire(canvas), wire):
            assert torch.equal(g, b)
        want_c = np.asarray(j_canvas(variables, jnp.asarray(p),
                                     jnp.int32(n)))
        np.testing.assert_allclose(canvas.numpy(), want_c, **canvas_tol)
        want_w = j_model(variables, jnp.asarray(p), jnp.int32(n))
        for g, w in zip(wire, want_w):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-4)


def test_single_sweep_forward_equals_predict_raw_and_batched_rows(scenes):
    variables, clouds = scenes
    port = _port_model(variables)
    forward = tdet.build_forward_fn(port.model, TCFG)
    padded = [port.pad_points(c) for c in clouds]
    pts = torch.from_numpy(np.stack([p for p, _ in padded]))
    ns = torch.from_numpy(np.asarray([n for _, n in padded], np.int64))
    batch = forward(pts, ns)
    total = 0
    for i, cloud in enumerate(clouds):
        one = forward(torch.from_numpy(padded[i][0]), padded[i][1])
        assert one.boxes.shape == (TCFG.max_detections, 7)
        raw = port.predict_raw(cloud)
        for name, g, r in zip(one._fields, one, raw):
            assert torch.equal(g, r), name
        assert torch.equal(one.valid, batch.valid[i])
        assert torch.equal(one.class_ids, batch.class_ids[i])
        torch.testing.assert_close(one.boxes, batch.boxes[i], rtol=1e-5,
                                   atol=1e-4)
        torch.testing.assert_close(one.scores, batch.scores[i], rtol=1e-5,
                                   atol=1e-4)
        total += int(one.valid.sum())
    assert total > 0


# ---- rotated_nms_pallas ----------------------------------------------------

def _random_boxes(rng, n, span=10.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-span, span, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3] = rng.uniform(0.5, 3.0, n)
    b[:, 4] = rng.uniform(0.5, 6.0, n)
    b[:, 5] = rng.uniform(0.5, 3.0, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _class_shifted(rng, n, span, num_classes=9):
    b = _random_boxes(rng, n, span=span)
    cls = rng.integers(0, num_classes, n).astype(np.int32)
    b[:, 0] += cls * 4.0 * (2 * span + 2 * span)
    return b, cls


@pytest.mark.parametrize("with_classes", [False, True])
def test_rotated_nms_pallas_matches_jax(rng, with_classes):
    n = 256
    for _ in range(3):
        boxes, cls = _class_shifted(rng, n, span=30.0)
        scores = np.sort(rng.uniform(0.1, 1.0, n))[::-1].astype(np.float32)
        valid = rng.uniform(size=n) > 0.1
        kw_j = ({"class_ids": jnp.asarray(cls), "class_gap": 4.0 * 120.0}
                if with_classes else {})
        kw_t = ({"class_ids": torch.from_numpy(cls), "class_gap": 4.0 * 120.0}
                if with_classes else {})
        want = np.asarray(jax_nms_pallas(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), THR,
            interpret=True, **kw_j))
        got = tnms.rotated_nms_pallas(
            torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(valid), THR, **kw_t).numpy()
        assert got.shape == (n,)
        fix = np.asarray(jax_rotated_nms(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         jnp.asarray(valid), THR))
        for ref in (want, fix):
            if not np.array_equal(got, ref):
                # tests/test_nms_pallas.py: a divergence must trace to a
                # threshold-boundary pair involving a diverged box
                bad = np.nonzero(got != ref)[0]
                iou64 = rotated_iou_bev_np(boxes[bad], boxes)
                assert np.any(np.abs(iou64 - THR) < BOUNDARY_TOL)
        assert 0 < got.sum() < valid.sum()


def test_rotated_nms_pallas_valid_mask_and_disjoint(rng):
    boxes = np.tile(np.array([[0, 0, 0, 2, 4, 1, 0.2]], np.float32), (4, 1))
    keep = tnms.rotated_nms_pallas(
        torch.from_numpy(boxes), torch.tensor([0.9, 0.8, 0.7, 0.6]),
        torch.tensor([False, True, True, True]), 0.5)
    np.testing.assert_array_equal(keep.numpy(), [False, True, False, False])
    far = _random_boxes(rng, 64, span=500.0)
    keep = tnms.rotated_nms_pallas(torch.from_numpy(far), torch.ones(64),
                                   torch.ones(64, dtype=torch.bool), 0.1)
    assert keep.all()


# ---- top_k_two_stage -------------------------------------------------------

@pytest.mark.parametrize("n,k,rows", [(7200, 128, 16), (7201, 100, 16),
                                      (500, 500, 8), (4096, 64, 64),
                                      (720, 1024, 64)])
def test_top_k_two_stage_exact_with_ties(rng, n, k, rows):
    x = rng.normal(size=n).astype(np.float32)
    tie = rng.uniform(size=n) < 0.5
    # + 0.0 turns the rounding's -0.0 into 0.0: lax.top_k orders +0.0
    # above -0.0, a stable sort takes them as equal; scores are never -0.0
    # (tests/test_torch_anchor_major.py)
    x[tie] = np.round(x[tie] * 4) / 4 + 0.0
    x[rng.uniform(size=n) < 0.1] = 1.0           # saturated scores
    k = min(k, n)
    wv, wi = lax.top_k(jnp.asarray(x), k)
    gv, gi = tpost.top_k_two_stage(torch.from_numpy(x), k, rows=rows)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # batched along the last dim, equal to the one-stage stable selection
    xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    sv, si = tpost.top_k_stable(xb, k)
    gv, gi = tpost.top_k_two_stage(xb, k, rows=rows)
    assert torch.equal(gv, sv) and torch.equal(gi, si)


def test_package_exports_lyft_classes_and_box3d():
    assert [c.name for c in tpu_pillars_torch.LYFT_CLASSES] == [
        c.name for c in tpu_pillars.LYFT_CLASSES]
    assert tpu_pillars_torch.Box3D.__name__ == "Box3D"
    assert {"LYFT_CLASSES", "Box3D"} <= set(tpu_pillars_torch.__all__)
