"""The anchor-major API of tpu_pillars_torch against the JAX package on the
CPU, at ``tiny_config()``:

* ``SSDHead``, ``PointPillars.forward`` (PFN on running statistics, K3,
  RPN, anchor-major head) and ``features_from_batch`` against flax
  ``PointPillars.apply`` on the same ``PillarBatch``, f32 at the wire
  head's tolerance (rtol 1e-5, atol 1e-4, tests/test_torch_model.py) and
  bf16 at tests/test_bf16.py's measure
  (class-logit median |d| < 0.02, box |d| 99th percentile < 0.1); the
  anchor-major head against the wire and feature-major heads (the same
  products in another reduction order, atol 1e-5);
* ``detection_loss`` against the JAX one (rtol 1e-6) and bit-equal to
  ``detection_loss_fm`` on the transposed inputs;
* ``make_eval_forward`` against the JAX one (the same tolerance);
* ``postprocess`` and ``postprocess_t`` against the JAX functions (scores
  atol 1e-6, boxes atol 1e-5: tests/test_torch_postprocess.py), with
  ``nms_impl`` "fixpoint" and "pallas", and bit-equal to ``postprocess_w``
  on the same logits, saturated ties included;
* ``top_k_stable``, the candidate selection of every layout: values and
  indices equal to ``lax.top_k`` on tests/test_nms_pallas.py's tie-heavy
  cases, batched;
* ``resolve_nms_impl``: "auto" by device, the refusal of an unknown name
  at build time (``build_postprocess_fn``, ``Detector``); "fixpoint" and
  "pallas" keep the same sets, and the classic ``Detector`` serves the
  same boxes with either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.ops.anchors import make_anchors
from torch_port_util import cloud_batch, random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import detector as tdet
from tpu_pillars_torch import weights
from tpu_pillars_torch.models.pointpillars import PointPillars
from tpu_pillars_torch.ops import losses as tlosses
from tpu_pillars_torch.ops import postprocess as tpost
from tpu_pillars_torch.ops.emit import pillarize_batch_emit
from tpu_pillars_torch.ops.target_assigner import Targets
from tpu_pillars_torch.train.step import make_eval_forward

CFG, TCFG = tiny_config(), tconfig.tiny_config()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _model(variables):
    model = PointPillars(TCFG)
    model.load_state_dict(weights.params_from_flax(variables, TCFG))
    return model.eval()


@pytest.fixture(scope="module")
def scene():
    """Weights, two clouds, their port ``PillarBatch`` and the JAX one."""
    from tpu_pillars.ops.voxelize import PillarBatch

    variables = random_variables(CFG, seed=8)
    pts, ns = cloud_batch(np.random.default_rng(8), [3000, 1500], CFG)
    pb = pillarize_batch_emit(_t(pts), _t(ns.astype(np.int64)), TCFG)
    jpb = PillarBatch(*(jnp.asarray(x.numpy()) for x in pb))
    return variables, pts, ns, pb, jpb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax(scene, dtype):
    from tpu_pillars.models import PointPillars as JaxPointPillars

    variables, _, _, pb, jpb = scene
    jv = jax.tree.map(jnp.asarray, variables)
    jmodel = JaxPointPillars(CFG, dtype=jnp.dtype(dtype))
    want = jax.jit(jmodel.apply)(jv, jpb)
    with torch.no_grad():
        got = _model(variables)(pb, getattr(torch, dtype))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == getattr(torch, dtype), name
        assert tuple(g.shape) == w.shape == (2, CFG.num_anchors,
                                             g.shape[-1]), name
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
        elif name == "cls_logits":
            assert np.median(np.abs(g - w)) < 0.02
        else:
            assert np.percentile(np.abs(g - w), 99) < 0.1, name
    if dtype == "float32":
        want_f = jmodel.apply(jv, jpb,
                              method=JaxPointPillars.features_from_batch)
        with torch.no_grad():
            got_f = _model(variables).features_from_batch(pb)
        np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                                   rtol=1e-5, atol=1e-4)


def test_anchor_major_head_against_wire_and_feature_major():
    v = random_variables(CFG, seed=2)
    rng = np.random.default_rng(2)
    feat = _t(rng.normal(0, 1, (2, CFG.feature_h, CFG.feature_w,
                                3 * CFG.rpn_up_channels)).astype(np.float32))
    model = _model(v)
    with torch.no_grad():
        cls, box, dirl = model.head(feat)
        cls_t, box_t, dir_t = model.head.feature_major(feat)
        own, box_p, dir_p = model.head.wire(feat)
    for am, fm in ((cls, cls_t), (box, box_t), (dirl, dir_t)):
        torch.testing.assert_close(am.transpose(1, 2), fm, rtol=0, atol=1e-5)
    _, anchor_cls = make_anchors(CFG)
    A, a_loc = CFG.num_anchors, CFG.anchors_per_loc
    hw = A // a_loc
    own_cls = torch.from_numpy(np.array(anchor_cls, np.int64))
    torch.testing.assert_close(cls[:, torch.arange(A), own_cls], own,
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(
        box.reshape(2, hw, a_loc, 7).permute(0, 3, 2, 1).reshape(2, 7, A),
        box_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(
        dirl.reshape(2, hw, a_loc, 2).permute(0, 3, 2, 1).reshape(2, 2, A),
        dir_p, rtol=0, atol=1e-5)


def test_detection_loss_matches_jax_and_the_feature_major_loss():
    from tpu_pillars.ops.losses import detection_loss as jax_loss
    from tpu_pillars.ops.target_assigner import Targets as JTargets

    rng = np.random.default_rng(0)
    B, K, A = 2, CFG.num_classes, 3000
    cls = rng.normal(0, 3, (B, A, K)).astype(np.float32)
    box = rng.normal(0, 1, (B, A, 7)).astype(np.float32)
    dirl = rng.normal(0, 2, (B, A, 2)).astype(np.float32)
    pos = rng.random((B, A)) < 0.02
    neg = ~pos & (rng.random((B, A)) < 0.9)
    onehot = np.zeros((B, K, A), np.float32)
    onehot[np.arange(B)[:, None], rng.integers(0, K, (B, A)),
           np.arange(A)[None]] = 1.0
    onehot *= pos[:, None]
    reg = (rng.normal(0, 1, (B, 7, A)) * pos[:, None]).astype(np.float32)
    dirt = ((rng.random((B, A)) < 0.5) & pos).astype(np.int32)
    tgt = (onehot, reg, dirt, (pos | neg).astype(np.float32),
           pos.astype(np.float32), pos.sum(1).astype(np.float32))
    want = jax.vmap(lambda c, b, d, t: jax_loss(c, b, d, t, CFG))(
        jnp.asarray(cls), jnp.asarray(box), jnp.asarray(dirl),
        JTargets(*(jnp.asarray(x) for x in tgt)))
    targets = Targets(*(_t(x) for x in tgt))
    got = tlosses.detection_loss(_t(cls), _t(box), _t(dirl), targets, TCFG)
    fm = tlosses.detection_loss_fm(_t(cls.transpose(0, 2, 1)),
                                   _t(box.transpose(0, 2, 1)),
                                   _t(dirl.transpose(0, 2, 1)), targets,
                                   TCFG)
    for name, g, w, f in zip(got._fields, got, want, fm):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   err_msg=name)
        assert torch.equal(g, f), name


def test_eval_forward_matches_jax(scene):
    from tpu_pillars.train import make_eval_forward as jax_eval_forward

    variables, pts, ns, _, _ = scene
    want = jax.jit(jax_eval_forward(CFG))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(pts),
        jnp.asarray(ns))
    got = make_eval_forward(TCFG)(_model(variables), _t(pts),
                                  _t(ns.astype(np.int64)))
    assert not any(g.requires_grad for g in got)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


# ---- postprocess in three layouts ------------------------------------------

def _anchor_major(rng, batch, ties=False):
    """(B, A, K) class logits, mostly background, 60 own-class hot anchors a
    sample (40 of them saturated to sigmoid == 1.0 with ``ties``); (B, A, 7)
    residuals, (B, A, 2) direction logits."""
    _, anchor_cls = make_anchors(CFG)
    A, K = CFG.num_anchors, CFG.num_classes
    cls = rng.normal(-4.0, 1.0, (batch, A, K)).astype(np.float32)
    for b in range(batch):
        hot = rng.choice(A, 60, replace=False)
        cls[b, hot, anchor_cls[hot]] = rng.normal(3.0, 1.0, 60)
        if ties:
            cls[b, hot[:40], anchor_cls[hot[:40]]] = 40.0
    box = rng.normal(0, 0.1, (batch, A, 7)).astype(np.float32)
    dirl = rng.normal(0, 1.0, (batch, A, 2)).astype(np.float32)
    return cls, box, dirl


def _wire_of(cls, box, dirl):
    """The same logits in the serving wire's layout."""
    _, anchor_cls = make_anchors(CFG)
    B, A, _ = cls.shape
    a_loc = CFG.anchors_per_loc
    hw = A // a_loc
    own = cls[:, np.arange(A), anchor_cls]
    box_p = box.reshape(B, hw, a_loc, 7).transpose(0, 3, 2, 1).reshape(
        B, 7, A)
    dir_p = dirl.reshape(B, hw, a_loc, 2).transpose(0, 3, 2, 1).reshape(
        B, 2, A)
    return own, box_p, dir_p


def _anchors_t():
    from tpu_pillars_torch.ops.anchors import make_anchors as t_anchors

    anchors, anchor_cls = t_anchors(TCFG)
    return _t(np.array(anchors)), _t(np.array(anchor_cls, np.int64))


def _assert_detections_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("nms_impl", ["fixpoint", "pallas"])
@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
def test_postprocess_layouts_match_jax_and_the_wire(nms_impl, ties):
    from tpu_pillars.ops.postprocess import postprocess as jax_post

    rng = np.random.default_rng(5 + ties)
    cls, box, dirl = _anchor_major(rng, 2, ties)
    anchors, anchor_cls = _anchors_t()
    got = tpost.postprocess(_t(cls), _t(box), _t(dirl), anchors, anchor_cls,
                            TCFG, nms_impl)
    got_t = tpost.postprocess_t(_t(cls.transpose(0, 2, 1)),
                                _t(box.transpose(0, 2, 1)),
                                _t(dirl.transpose(0, 2, 1)), anchors,
                                anchor_cls, TCFG, nms_impl)
    got_w = tpost.postprocess_w(*(_t(x) for x in _wire_of(cls, box, dirl)),
                                anchors, anchor_cls, TCFG, nms_impl)
    _assert_detections_equal(got, got_t)
    _assert_detections_equal(got, got_w)
    ja, jc = make_anchors(CFG)
    for b in range(2):
        want = jax_post(jnp.asarray(cls[b]), jnp.asarray(box[b]),
                        jnp.asarray(dirl[b]), jnp.asarray(ja),
                        jnp.asarray(jc), CFG, nms_impl=nms_impl)
        valid = np.asarray(want.valid)
        assert valid.sum() > 0
        np.testing.assert_array_equal(got.valid[b].numpy(), valid)
        np.testing.assert_array_equal(got.class_ids[b].numpy(),
                                      np.asarray(want.class_ids))
        np.testing.assert_allclose(got.scores[b].numpy(),
                                   np.asarray(want.scores), atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy(),
                                   np.asarray(want.boxes), atol=1e-5)
    if ties:
        assert ((got.scores == 1.0).sum(dim=1) >= 2).all()


def test_fixpoint_and_pallas_keep_the_same_sets():
    """Candidates crowded into a 4 x 4 block of cells, residuals near zero,
    so that NMS suppresses many of them."""
    rng = np.random.default_rng(9)
    anchors, anchor_cls = _anchors_t()
    A, K = CFG.num_anchors, CFG.num_classes
    a_loc, W = CFG.anchors_per_loc, CFG.feature_w
    block = ((np.arange(4)[:, None] + 18) * W + np.arange(4) + 20
             ).reshape(-1, 1) * a_loc + np.arange(a_loc)
    own_cls = anchor_cls.numpy()
    for ties in (False, True):
        cls = np.full((3, A, K), -10.0, np.float32)
        for b in range(3):
            hot = rng.choice(block.reshape(-1), 150, replace=False)
            cls[b, hot, own_cls[hot]] = 40.0 if ties else rng.normal(
                3.0, 1.0, 150)
        box = rng.normal(0, 0.02, (3, A, 7)).astype(np.float32)
        dirl = rng.normal(0, 1.0, (3, A, 2)).astype(np.float32)
        args = (_t(cls), _t(box), _t(dirl), anchors, anchor_cls, TCFG)
        fix = tpost.postprocess(*args, "fixpoint")
        _assert_detections_equal(fix, tpost.postprocess(*args, "pallas"))
        assert 0 < int(fix.valid.sum()) < 3 * 100


def test_top_k_stable_matches_lax_top_k():
    from jax import lax

    rng = np.random.default_rng(0)
    for n, k in [(7200, 128), (7201, 100), (500, 500), (4096, 64)]:
        x = rng.normal(size=(3, n)).astype(np.float32)
        tie = rng.uniform(size=(3, n)) < 0.5
        # + 0.0 turns the rounding's -0.0 into 0.0: lax.top_k orders +0.0
        # above -0.0, a stable sort takes them as equal; scores are never
        # -0.0 (sigmoids, or -1.0 below the threshold)
        x[tie] = np.round(x[tie] * 4) / 4 + 0.0
        gv, gi = tpost.top_k_stable(_t(x), k)
        for b in range(3):
            wv, wi = lax.top_k(jnp.asarray(x[b]), k)
            np.testing.assert_array_equal(gv[b].numpy(), np.asarray(wv))
            np.testing.assert_array_equal(gi[b].numpy(), np.asarray(wi))
    # one dimension, as the JAX function takes it
    x = rng.normal(size=1000).astype(np.float32)
    gv, gi = tpost.top_k_stable(_t(x), 10)
    np.testing.assert_array_equal(gi.numpy(),
                                  np.asarray(lax.top_k(jnp.asarray(x), 10)[1]))


def test_resolve_nms_impl():
    assert tpost.resolve_nms_impl("auto", "cpu") == "fixpoint"
    assert tpost.resolve_nms_impl("auto", torch.device("cuda", 0)) == \
        "pallas"
    for name in ("fixpoint", "pallas"):
        for dev in ("cpu", "cuda"):
            assert tpost.resolve_nms_impl(name, dev) == name
    with pytest.raises(ValueError, match="nms_impl"):
        tpost.resolve_nms_impl("fastest", "cpu")
    with pytest.raises(ValueError, match="nms_impl"):
        tdet.build_postprocess_fn(TCFG, "cpu", nms_impl="fastest")
    sd = weights.params_from_flax(random_variables(CFG, seed=1), TCFG)
    with pytest.raises(ValueError, match="nms_impl"):
        tdet.Detector(TCFG, sd, device="cpu", nms_impl="fastest")


def test_detector_serves_the_same_boxes_with_either_nms(scene):
    variables, pts, ns, _, _ = scene
    sd = weights.params_from_flax(variables, TCFG)
    out = [tdet.Detector(TCFG, sd, device="cpu", fused_frontend=False,
                         nms_impl=impl).predict_packed_batch(pts, ns)
           for impl in ("auto", "fixpoint", "pallas")]
    assert out[0][..., 9].sum() > 0
    for o in out[1:]:
        assert torch.equal(o, out[0])
