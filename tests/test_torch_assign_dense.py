"""The dense and banded target assigners of tpu_pillars_torch against the
JAX package on the CPU, at ``tiny_config()``:

* ``ops.iou.rotated_iou_bev_paired`` against the JAX function (rtol 1e-5,
  atol 1e-6), with a leading dim;
* the dense one-sample ``assign_targets`` (the (A, G) IoU over every anchor
  and GT slot) against the JAX ``assign_targets`` on the cases of
  tests/test_losses_targets.py (a GT equal to an anchor, class matching,
  the force match of a low-IoU GT, no GT, a synthetic scene: every field
  equal, ``reg_targets`` within 1e-6; padded zero GT give finite targets)
  and on each sample of tests/test_torch_assign.py's scene families under
  its ``_compare`` contract (equal except a <= 0.1% boundary set, 3e-3 for
  exact duplicate GTs: the two IoUs round apart by an ulp, which moves an
  anchor at a threshold or a tie);
* the port's class-blocked ``make_classwise_assigner`` equal to the dense
  ``assign_targets`` where no class exceeds its capacity
  (tests/test_losses_targets.py::test_classwise_assigner_matches_dense);
* ``make_classwise_assigner(band_cells=)`` against the JAX banded assigner
  at a band narrower than the largest class's reach (the ``_compare``
  contract), and equal to the port's dense assigners at a band that holds
  every reach (every field equal, ``reg_targets`` within 1e-6), and to the
  JAX dense one under the ``_compare`` contract;
* the train step's ``assigner="banded"`` equal to ``"dense"`` bit for bit
  over two steps where the band holds the grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_assign import SCENES, _compare
from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene as jax_make_scene
from tpu_pillars.ops import iou as jiou
from tpu_pillars.ops import target_assigner as jta
from tpu_pillars.ops.anchors import make_anchors
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.ops import iou as tiou
from tpu_pillars_torch.ops import target_assigner as tta

CFG, TCFG = tiny_config(), tconfig.tiny_config()
ANCHORS, ANCHOR_CLS = make_anchors(CFG)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(targets):
    return type(targets)(*(np.asarray(x) for x in targets))


def _assert_targets_equal(got, want):
    got, want = _np(got), _np(want)
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape, name
        if name == "reg_targets":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ---- the paired IoU --------------------------------------------------------

def test_paired_iou_matches_jax():
    rng = np.random.default_rng(0)
    G, K = 6, 50
    b1 = np.c_[rng.uniform(-4, 4, (G, 2)), rng.normal(0, 1, (G, 1)),
               rng.uniform(0.5, 4, (G, 3)), rng.uniform(-np.pi, np.pi, (G, 1))]
    b2 = np.c_[rng.uniform(-5, 5, (G * K, 2)), rng.normal(0, 1, (G * K, 1)),
               rng.uniform(0.5, 4, (G * K, 3)),
               rng.uniform(-np.pi, np.pi, (G * K, 1))]
    b1 = b1.astype(np.float32)
    b2 = b2.astype(np.float32).reshape(G, K, 7)
    b2[:, 0] = b1                                     # self pairs: IoU 1
    want = np.asarray(jiou.rotated_iou_bev_paired(jnp.asarray(b1),
                                                  jnp.asarray(b2)))
    assert (want > 0).sum() > 20
    got = tiou.rotated_iou_bev_paired(_t(b1), _t(b2))
    assert tuple(got.shape) == (G, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 0].numpy(), 1.0, rtol=1e-5)
    lead = tiou.rotated_iou_bev_paired(_t(np.stack([b1, b1[::-1]])),
                                       _t(np.stack([b2, b2[::-1]])))
    assert torch.equal(lead[0], got) and torch.equal(lead[1], got.flip(0))


# ---- the dense (A, G) assigner ---------------------------------------------

def _pad_gt(boxes, classes, G=8):
    gb = np.zeros((G, 7), np.float32)
    gc = np.zeros((G,), np.int32)
    gv = np.zeros((G,), bool)
    gb[:len(boxes)] = boxes
    gc[:len(classes)] = classes
    gv[:len(boxes)] = True
    return gb, gc, gv


def _equal_anchor():
    idx = np.nonzero((ANCHOR_CLS == 0) & (ANCHORS[:, 6] == 0.0)
                     & (np.abs(ANCHORS[:, 0]) < 1)
                     & (np.abs(ANCHORS[:, 1]) < 1))[0][0]
    return _pad_gt(ANCHORS[idx:idx + 1].copy(), [0])


def _pedestrian():
    ped = list(CFG.class_names).index("pedestrian")
    s = CFG.classes[ped]
    return _pad_gt(np.array([[0.2, 0.3, s.z_center, s.width, s.length,
                              s.height, 0.1]], np.float32), [ped])


def _low_iou_car():
    return _pad_gt(np.array([[0.31, 0.22, -1.0, 0.9, 2.2, 0.8, 0.3]],
                            np.float32), [0])


def _scene():
    scene = jax_make_scene(np.random.default_rng(3), CFG, num_objects=10,
                           clutter=100)
    return _pad_gt(scene.gt_boxes[:16], scene.gt_classes[:16], G=16)


DENSE_CASES = {
    "equal_anchor": _equal_anchor,
    "pedestrian": _pedestrian,
    "low_iou_car": _low_iou_car,
    "no_gt": lambda: _pad_gt(np.zeros((0, 7), np.float32), []),
    "scene": _scene,
}


def _dense_both(gb, gc, gv, iou_chunk=4096):
    want = jta.assign_targets(jnp.asarray(ANCHORS), jnp.asarray(ANCHOR_CLS),
                              jnp.asarray(gb), jnp.asarray(gc),
                              jnp.asarray(gv), CFG, iou_chunk=iou_chunk)
    got = tta.assign_targets(_t(ANCHORS), _t(ANCHOR_CLS.astype(np.int64)),
                             _t(gb), _t(gc.astype(np.int64)), _t(gv), TCFG,
                             iou_chunk=iou_chunk)
    return got, want


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_assign_targets_matches_jax(case):
    got, want = _dense_both(*DENSE_CASES[case]())
    _assert_targets_equal(got, want)
    assert torch.isfinite(got.reg_targets).all()
    if case == "no_gt":
        assert float(got.num_pos) == 0.0 and bool((got.cls_weights == 1).all())
    else:
        assert float(got.num_pos) >= 1.0


def _batch1(targets):
    return type(targets)(*(np.asarray(x)[None] for x in targets))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_dense_assign_targets_matches_jax_on_scene_families(scene):
    make, max_flip = SCENES[scene]
    gt, cls, valid = make()
    for b in range(gt.shape[0]):
        got, want = _dense_both(gt[b], cls[b], valid[b], iou_chunk=997)
        _compare(_batch1(got), _batch1(want), max_flip)


def test_classwise_equals_dense_without_overflow():
    gb, gc, gv = _scene()
    dense = tta.assign_targets(_t(ANCHORS), _t(ANCHOR_CLS.astype(np.int64)),
                               _t(gb), _t(gc.astype(np.int64)), _t(gv), TCFG)
    cw = tta.make_classwise_assigner(TCFG, max_gt_per_class=8)(
        _t(gb)[None], _t(gc.astype(np.int64))[None], _t(gv)[None])
    assert float(dense.num_pos) > 0
    _assert_targets_equal(type(cw)(*(x[0] for x in cw)), dense)


# ---- the banded assigner ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_banded():
    return jax.jit(jax.vmap(jta.make_classwise_assigner(CFG, band_cells=12)))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_banded_matches_jax(jax_banded, scene):
    make, max_flip = SCENES[scene]
    gt, cls, valid = make()
    got = tta.make_classwise_assigner(TCFG, band_cells=12)(
        _t(gt), _t(cls.astype(np.int64)), _t(valid))
    want = jax_banded(jnp.asarray(gt), jnp.asarray(cls), jnp.asarray(valid))
    _compare(_np(got), _np(want), max_flip)


def test_banded_wide_enough_equals_dense():
    """32 cells (32 m at the tiny config) hold every class's reach (a bus
    GT against a bus anchor: two 6.5 m circumradii), so the band changes
    nothing: equal to the port's class-blocked dense assigner, and to the
    JAX dense ``assign_targets`` sample by sample (``_compare``)."""
    gt, cls, valid = SCENES["random"][0]()
    args = (_t(gt), _t(cls.astype(np.int64)), _t(valid))
    banded = tta.make_classwise_assigner(TCFG, band_cells=32)(*args)
    dense = tta.make_classwise_assigner(TCFG)(*args)
    _assert_targets_equal(banded, dense)
    for b in range(gt.shape[0]):
        _, want = _dense_both(gt[b], cls[b], valid[b])
        _compare(_batch1(type(banded)(*(x[b] for x in banded))),
                 _batch1(want), SCENES["random"][1])


def test_banded_train_step_equals_dense():
    """``make_train_step(assigner="banded")``: at the tiny config the band
    (``train.step.BAND_CELLS``, clipped to the 40 x 40 feature grid) holds
    the whole grid, so two steps give the dense assigner's losses and
    weights bit for bit."""
    from tpu_pillars_torch.data.synthetic import (
        make_scene, scenes_to_train_batch,
    )
    from tpu_pillars_torch.train import state as tstate
    from tpu_pillars_torch.train.step import batch_to_device, make_train_step

    rng = np.random.default_rng(21)
    scenes = [make_scene(rng, TCFG, num_objects=6, points_per_object=60,
                         clutter=400) for _ in range(2)]
    batch = batch_to_device(scenes_to_train_batch(scenes, TCFG, 16), "cpu")
    tcfg = tstate.TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    runs = []
    for name in ("dense", "banded"):
        st = tstate.create_train_state(TCFG, tcfg, seed=0, device="cpu")
        step = make_train_step(TCFG, assigner=name)
        losses = []
        for _ in range(2):
            st, lb = step(st, batch)
            losses.append([float(x) for x in lb])
        runs.append((losses, st.model.state_dict()))
    (l_dense, s_dense), (l_band, s_band) = runs
    assert l_band == l_dense
    assert l_dense[0][-1] > 0                    # num_pos
    for key in s_dense:
        assert torch.equal(s_band[key], s_dense[key]), key
