"""tpu_pillars_torch's target assignment (K5 + epilogue) vs the JAX package
on the CPU, at ``tiny_config()``.

* ``group_gt_by_class`` bit-equal, including "first cap per class in input
  order".
* K5's plain version (``windowed_best_iou_plain``, what the wrapper runs on
  a CPU tensor) against the JAX kernel ``windowed_best_iou(...,
  interpret=True)``: IoU within 2e-5 wherever either side is > 0, both <= 0
  elsewhere (the TPU kernel leaves -1 where its block gate skipped every
  GT, the port 0), the best GT equal wherever the IoU is > 0 and not tied
  within 2e-5, the GT-side best values within 2e-5.
* K5's block-level gate (``tile_circles``, ``tile_gate_plain``) is
  conservative: a (GT, tile) pair it skips has no anchor that passes the
  per-anchor f32 gate, for GT over the grid and beyond, large and rotated,
  and GT at the per-anchor gate's edge.
* ``windowed_best_iou_plain`` gives the five semantics the kernel must
  reproduce exactly (class with no valid GT, anchors whose valid GT all
  read 0, invalid slot, valid GT with no positive IoU, ties both ways),
  and agrees with the JAX kernel where the two packages agree.
* ``make_windowed_assigner`` against JAX's windowed assigner (interpret)
  and JAX's dense ``make_classwise_assigner``, on the four scene families
  of tests/test_assign_pallas.py, under its ``_compare`` contract: Targets
  equal except a <= 0.1% boundary set (3e-3 for exact duplicate GTs)
  explained by a threshold or a tie; all-invalid GT equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.ops.assign_pallas import (
    make_windowed_assigner as jax_windowed_assigner,
    windowed_best_iou as jax_windowed_best_iou,
)
from tpu_pillars.ops.target_assigner import (
    group_gt_by_class as jax_group, make_classwise_assigner,
)
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.ops import assign as tassign
from tpu_pillars_torch.ops.target_assigner import group_gt_by_class

CFG, TCFG = tiny_config(), tconfig.tiny_config()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
IOU_TOL = 2e-5


def _random_gt(rng, b, g, cfg=CFG):
    gt = np.zeros((b, g, 7), np.float32)
    cls = rng.integers(0, cfg.num_classes, (b, g)).astype(np.int32)
    valid = rng.random((b, g)) < 0.8
    for i in range(b):
        for j in range(g):
            spec = cfg.classes[cls[i, j]]
            gt[i, j] = [rng.uniform(cfg.x_min, cfg.x_max),
                        rng.uniform(cfg.y_min, cfg.y_max), spec.z_center,
                        spec.width * rng.uniform(0.8, 1.25),
                        spec.length * rng.uniform(0.8, 1.25), spec.height,
                        rng.uniform(-np.pi, np.pi)]
    return gt, cls, valid


def _crowded():
    b, g = 1, 16
    gt = np.zeros((b, g, 7), np.float32)
    cls = np.zeros((b, g), np.int32)
    valid = np.ones((b, g), bool)
    for j in range(10):           # crowd of cars around (3, -2)
        gt[0, j] = [3 + 0.4 * j, -2 + 0.2 * j, -1.0, 1.9, 4.7, 1.7, 0.2 * j]
    gt[0, 10] = [CFG.x_min, CFG.y_min, -1.0, 1.9, 4.7, 1.7, 0.0]
    gt[0, 11] = [CFG.x_max - 0.01, CFG.y_max - 0.01, -1.0, 1.9, 4.7, 1.7,
                 1.2]
    gt[0, 12] = [CFG.x_max + 30, 0.0, -1.0, 1.9, 4.7, 1.7, 0.0]  # outside
    cls[0, 13] = 2
    gt[0, 13] = [-5, 6, -0.1, 2.9, 12.3, 3.4, -0.7]
    gt[0, 14] = [0, 0, -1.0, 1.9, 4.7, 1.7, 0.0]
    valid[0, 15] = False
    return gt, cls, valid


def _duplicates():
    gt = np.zeros((1, 4, 7), np.float32)
    cls = np.zeros((1, 4), np.int32)
    valid = np.ones((1, 4), bool)
    gt[0, 0] = [2.25, 1.75, -1.0, 1.9, 4.7, 1.7, 0.5]
    gt[0, 1] = gt[0, 0]
    gt[0, 2] = [2.25, 1.75, -1.0, 1.9, 4.7, 1.7, 0.5 + np.pi]  # same quad
    gt[0, 3] = [-8, -8, -1.0, 1.9, 4.7, 1.7, 0.0]
    return gt, cls, valid


SCENES = {
    "random": (lambda: _random_gt(np.random.default_rng(0), 2, 12), 1e-3),
    "crowded_edges": (_crowded, 1e-3),
    "duplicates": (_duplicates, 3e-3),
}


def _batch2(gt, cls, valid):
    """Append an all-invalid sample to a one-sample scene: every JAX kernel
    call then has batch 2 and shares one trace (the interpret-mode trace of
    the kernel is the slow part of this file)."""
    if gt.shape[0] == 2:
        return gt, cls, valid
    return (np.concatenate([gt, np.zeros_like(gt)]),
            np.concatenate([cls, np.zeros_like(cls)]),
            np.concatenate([valid, np.zeros_like(valid)]))


def _port_targets(gt, cls, valid):
    assign = tassign.make_windowed_assigner(TCFG)
    t = assign(torch.from_numpy(gt), torch.from_numpy(cls.astype(np.int64)),
               torch.from_numpy(valid))
    return type(t)(*(np.asarray(x.numpy()) for x in t))


def _jax_targets(gt, cls, valid, windowed):
    args = (jnp.asarray(gt), jnp.asarray(cls), jnp.asarray(valid))
    if windowed:
        t = jax_windowed_assigner(CFG, interpret=True)(*args)
    else:
        t = jax.vmap(make_classwise_assigner(CFG))(*args)
    return type(t)(*(np.asarray(x) for x in t))


def _compare(got, want, max_flip_frac):
    """tests/test_assign_pallas.py::_compare on two Targets."""
    pos_g = got.reg_weights > 0
    pos_w = want.reg_weights > 0
    flip = pos_g != pos_w
    assert flip.mean() <= max_flip_frac, flip.mean()
    stable = ~flip
    reg_diff = (np.abs(got.reg_targets - want.reg_targets).max(axis=1)
                > 1e-4) & stable & pos_g
    boundary = flip | reg_diff
    assert boundary.mean() <= max_flip_frac, boundary.mean()
    ok = ~boundary
    np.testing.assert_allclose(got.reg_targets * ok[:, None, :],
                               want.reg_targets * ok[:, None, :], atol=1e-4)
    np.testing.assert_array_equal(got.dir_targets * ok,
                                  want.dir_targets * ok)
    np.testing.assert_array_equal(got.cls_onehot * ok[:, None, :],
                                  want.cls_onehot * ok[:, None, :])
    assert ((got.cls_weights != want.cls_weights) & ok).mean() \
        <= max_flip_frac
    assert abs(float(got.num_pos.sum()) - float(want.num_pos.sum())) <= \
        max(4, flip.sum())


def test_group_gt_by_class_bit_equal():
    rng = np.random.default_rng(3)
    gt = rng.normal(0, 5, (3, 40, 7)).astype(np.float32)
    cls = rng.integers(0, CFG.num_classes, (3, 40)).astype(np.int32)
    cls[0, :30] = 4               # one class over its cap: first 16 kept
    valid = rng.random((3, 40)) < 0.7
    got_b, got_v = group_gt_by_class(torch.from_numpy(gt),
                                     torch.from_numpy(cls),
                                     torch.from_numpy(valid),
                                     CFG.num_classes, 16)
    for b in range(3):
        want_b, want_v = jax_group(jnp.asarray(gt[b]), jnp.asarray(cls[b]),
                                   jnp.asarray(valid[b]), CFG.num_classes, 16)
        np.testing.assert_array_equal(got_b[b].numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(want_v))
    assert int(got_v[0, 4].sum()) == 16


def test_anchor_planes_match_jax():
    from tpu_pillars.ops.assign_pallas import _anchor_planes

    jp, _, _, _ = _anchor_planes(CFG)
    Hf, L = CFG.feature_h, CFG.feature_w * len(CFG.anchor_yaws)
    want = jp[:, :, :Hf, :L].reshape(CFG.num_classes, 12, Hf * L)
    np.testing.assert_array_equal(tassign.anchor_planes(TCFG), want)


@pytest.mark.parametrize("scene", ["random", "crowded_edges", "duplicates"])
def test_best_iou_plain_matches_jax_kernel(scene):
    gt, cls, valid = _batch2(*SCENES[scene][0]())
    gt_c, gv_c = group_gt_by_class(torch.from_numpy(gt),
                                   torch.from_numpy(cls),
                                   torch.from_numpy(valid),
                                   CFG.num_classes, 16)
    best, best_gt, gval, ganc = (x.numpy() for x in tassign.windowed_best_iou(
        gt_c, gv_c, TCFG))
    j = jax_windowed_best_iou(jnp.asarray(gt_c.numpy()),
                              jnp.asarray(gv_c.numpy()), CFG, 16,
                              interpret=True)
    jbest, jbest_gt, jgval, janc = (np.asarray(x) for x in j)
    assert best.shape == jbest.shape and best_gt.shape == jbest_gt.shape
    live = (best > 0) | (jbest > 0)
    assert live.any()
    np.testing.assert_allclose(best[live], jbest[live], atol=IOU_TOL, rtol=0)
    assert (best[~live] <= 0).all() and (jbest[~live] <= 0).all()

    # the best GT wherever the IoU is positive and the runner-up is not
    # within the tolerance (the per-pair IoUs come from the plain dense
    # formulation)
    iou = _dense_iou(gt_c, gv_c)
    top2 = np.sort(iou, axis=2)[..., -2:] if iou.shape[2] > 1 else None
    clear = live if top2 is None else live & (top2[..., 1] - top2[..., 0]
                                              > IOU_TOL)
    np.testing.assert_array_equal(best_gt[clear], jbest_gt[clear])

    gv = gv_c.numpy()
    np.testing.assert_allclose(gval[gv], jgval[gv], atol=IOU_TOL, rtol=0)
    claim = gv & (gval > 0)
    # a GT's best anchor: equal unless another anchor ties within tolerance
    Ac = best.shape[2]
    for b, c, g in zip(*np.nonzero(claim)):
        if ganc[b, c, g] != janc[b, c, g]:
            row = iou[b, c, :, :]  # (Ac, Gc)
            assert abs(row[janc[b, c, g], g] - gval[b, c, g]) <= IOU_TOL
        assert 0 <= ganc[b, c, g] < Ac
    assert (gval[~gv] == -1).all() and (ganc[~gv] == 0).all()


def _dense_iou(gt_c, gv_c):
    """(B, C, Ac, Gc) IoU of every pair, plain formulation."""
    return np.stack([tassign.class_iou_plain(gt_c[b], gv_c[b], TCFG).numpy()
                     for b in range(gt_c.shape[0])]).transpose(0, 1, 3, 2)


@pytest.mark.parametrize("scene", ["random", "crowded_edges", "duplicates"])
@pytest.mark.parametrize("reference", ["windowed", "dense"])
def test_targets_match_jax(scene, reference):
    make, max_flip = SCENES[scene]
    gt, cls, valid = make()
    n = gt.shape[0]
    got = _port_targets(gt, cls, valid)
    want = _jax_targets(*_batch2(gt, cls, valid),
                        windowed=reference == "windowed")
    want = type(want)(*(x[:n] for x in want))
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape, name
    _compare(got, want, max_flip)
    if scene == "random":
        assert float(want.num_pos.sum()) > 0


def test_empty_and_all_invalid_equal():
    gt = np.zeros((2, 8, 7), np.float32)
    cls = np.zeros((2, 8), np.int32)
    valid = np.zeros((2, 8), bool)
    got = _port_targets(gt, cls, valid)
    for windowed in (True, False):
        want = _jax_targets(gt, cls, valid, windowed)
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert float(got.num_pos.sum()) == 0.0


def test_padded_zero_gt_gives_finite_targets():
    gt, cls, valid = _random_gt(np.random.default_rng(1), 2, 6)
    gt[:, 3:] = 0.0                       # zero-size padded slots
    valid[:, 3:] = False
    got = _port_targets(gt, cls, valid)
    for name, x in zip(got._fields, got):
        assert np.isfinite(x).all(), name


def _anchor_tiles(cfg):
    """(Ac,) tile index of each class-block anchor: TILE_ROWS feature rows
    by TILE_LANES anchors of a row, row-major."""
    Hf, L = cfg.feature_h, cfg.feature_w * len(cfg.anchor_yaws)
    tc = -(-L // tassign.TILE_LANES)
    r = np.arange(Hf)[:, None] // tassign.TILE_ROWS
    lane = np.arange(L)[None, :] // tassign.TILE_LANES
    return torch.from_numpy((r * tc + lane).reshape(-1))


def _gate_scene(rng, b, g, cfg=TCFG):
    """(b, C, g, 7) GT over the grid and 30 m beyond its edge, half at a
    class's size and half up to 30 m long, at any yaw; plus, per class,
    g // 4 GT placed at the per-anchor gate's edge of a random anchor
    (centre distance = summed circumradii, times 1 +- 1e-6)."""
    C = cfg.num_classes
    planes = tassign.anchor_planes(cfg)
    gt = np.zeros((b, C, g, 7), np.float32)
    for c, spec in enumerate(cfg.classes):
        gt[:, c, :, 0] = rng.uniform(cfg.x_min - 30, cfg.x_max + 30, (b, g))
        gt[:, c, :, 1] = rng.uniform(cfg.y_min - 30, cfg.y_max + 30, (b, g))
        big = rng.random((b, g)) < 0.5
        gt[:, c, :, 3] = np.where(big, rng.uniform(0.1, 12.0, (b, g)),
                                  spec.width)
        gt[:, c, :, 4] = np.where(big, rng.uniform(0.1, 30.0, (b, g)),
                                  spec.length)
        gt[:, c, :, 5] = spec.height
        gt[:, c, :, 6] = rng.uniform(-np.pi, np.pi, (b, g))
        for i in range(b):
            for j in range(g // 4):
                a = rng.integers(planes.shape[2])
                gr = 0.5 * np.hypot(gt[i, c, j, 3], gt[i, c, j, 4])
                d = (gr + planes[c, 11, a]) * (1 + rng.choice([-1e-6, 1e-6]))
                th = rng.uniform(-np.pi, np.pi)
                gt[i, c, j, 0] = planes[c, 8, a] + d * np.cos(th)
                gt[i, c, j, 1] = planes[c, 9, a] + d * np.sin(th)
    return torch.from_numpy(gt)


def test_tile_gate_skips_no_pair_the_anchor_gate_passes():
    """K5's block-level gate is conservative: wherever ``tile_gate_plain``
    (the kernel's test, in its f32 order, on ``tile_circles``) skips a
    (GT, tile) pair, no anchor of the tile passes the per-anchor f32 gate
    of ``class_iou_plain`` (dx^2 + dy^2 > (r_gt + r_anchor)^2 reads 0). It
    also skips most pairs: a tile is near square, so its circle is tight."""
    gt_c = _gate_scene(np.random.default_rng(11), 2, 32)
    gv_c = torch.ones(gt_c.shape[:3], dtype=torch.bool)
    skip = tassign.tile_gate_plain(gt_c, TCFG)               # (B, C, G, T)
    T = tassign.tile_circles(TCFG).shape[1]
    assert skip.shape == gt_c.shape[:3] + (T,)
    planes = torch.from_numpy(np.array(tassign.anchor_planes(TCFG)))
    pay = tassign.gt_payload(gt_c, gv_c)
    dx = pay[..., 8, None] - planes[None, :, None, 8]
    dy = pay[..., 9, None] - planes[None, :, None, 9]
    rr = pay[..., 11, None] + planes[None, :, None, 11]
    passes = ~(dx * dx + dy * dy > rr * rr)                  # (B, C, G, Ac)
    tile = _anchor_tiles(TCFG)
    hit = torch.zeros(skip.shape, dtype=torch.int32).index_add_(
        3, tile, passes.to(torch.int32)) > 0
    assert hit.any() and (~hit).any()
    assert not (skip & hit).any(), int((skip & hit).sum())
    assert skip.float().mean() > 0.5, skip.float().mean()


def _semantics_scene():
    """Sample 0, class 0: slot 0 invalid, slot 1 valid far outside the
    grid, slot 2 a car on an anchor, slot 3 its duplicate (anchor ties),
    slot 4 a 12 x 12 m square that holds many anchors whole (GT ties);
    class 1 only an invalid slot. Sample 1: no valid GT."""
    G = 16
    gt_c = np.zeros((2, CFG.num_classes, G, 7), np.float32)
    gv_c = np.zeros((2, CFG.num_classes, G), bool)
    car = [0.5, 0.5, -1.0, 1.9, 4.7, 1.7, 0.0]
    gt_c[0, 0, 0] = car
    gt_c[0, 0, 1] = [CFG.x_max + 50, 0.0, -1.0, 1.9, 4.7, 1.7, 0.3]
    gt_c[0, 0, 2] = car
    gt_c[0, 0, 3] = car
    gt_c[0, 0, 4] = [-10.0, -10.0, -1.0, 12.0, 12.0, 1.7, 0.0]
    gv_c[0, 0, 1:5] = True
    gt_c[0, 1, 0] = car
    return torch.from_numpy(gt_c), torch.from_numpy(gv_c)


def test_best_iou_plain_semantics():
    """``windowed_best_iou_plain`` (the card's reference) on the five cases
    the kernel must reproduce exactly: a class with no valid GT reads best
    -1 / best_gt 0; an anchor whose valid GT all read 0 reads 0 / the first
    valid slot; an invalid slot reads (-1, 0), a valid GT with no positive
    IoU (here one far outside the grid) (0, 0); anchor ties go to the first
    slot, GT ties to the lowest anchor. Held against the JAX kernel where
    the two packages agree (positive IoUs, invalid slots); the far GT is
    where they differ (JAX (-1, 0), module docstring)."""
    gt_c, gv_c = _semantics_scene()
    best, best_gt, gval, ganc = tassign.windowed_best_iou(gt_c, gv_c, TCFG)
    assert best_gt.dtype == ganc.dtype == torch.int64
    assert (best[1] == -1).all() and (best[0, 1:] == -1).all()
    assert (best_gt[1] == 0).all() and (best_gt[0, 1:] == 0).all()
    iou = tassign.class_iou_plain(gt_c[0], gv_c[0], TCFG)[0]   # (G, Ac)
    none = (iou[1:5] <= 0).all(dim=0)
    assert none.any()
    assert (best[0, 0][none] == 0).all() and (best_gt[0, 0][none] == 1).all()
    assert gval[0, 0, 0] == -1 and ganc[0, 0, 0] == 0
    assert (gval[0, 0, 5:] == -1).all() and (ganc[0, 0, 5:] == 0).all()
    assert gval[0, 0, 1] == 0.0 and ganc[0, 0, 1] == 0
    car = iou[2] == iou[2].max()
    assert iou[2].max() > 0.5 and torch.equal(iou[2], iou[3])
    assert (best_gt[0, 0][car] == 2).all()
    top = (iou[4] == iou[4].max()).nonzero()[:, 0]
    assert iou[4].max() > 0 and len(top) > 1
    assert ganc[0, 0, 4] == top.min() and gval[0, 0, 4] == iou[4].max()

    j = jax_windowed_best_iou(jnp.asarray(gt_c.numpy()),
                              jnp.asarray(gv_c.numpy()), CFG, 16,
                              interpret=True)
    jbest, jbest_gt, jgval, janc = (np.asarray(x) for x in j)
    pos = best.numpy() > 0
    np.testing.assert_allclose(best.numpy()[pos], jbest[pos], atol=IOU_TOL,
                               rtol=0)
    np.testing.assert_array_equal(best_gt.numpy()[0, 0][car.numpy()],
                                  jbest_gt[0, 0][car.numpy()])
    for g in (2, 4):
        assert abs(float(gval[0, 0, g]) - jgval[0, 0, g]) <= IOU_TOL
        assert janc[0, 0, g] == int(ganc[0, 0, g])
    inval = ~gv_c.numpy()
    assert (jgval[inval] == -1).all() and (janc[inval] == 0).all()
    assert jgval[0, 0, 1] == -1 and janc[0, 0, 1] == 0


def test_assign_wrapper_refuses_wrong_inputs():
    gt = torch.zeros((1, CFG.num_classes, 4, 7), dtype=torch.float64)
    gv = torch.ones((1, CFG.num_classes, 4), dtype=torch.bool)
    with pytest.raises(TypeError):
        tassign.windowed_best_iou(gt, gv, TCFG)
    with pytest.raises(ValueError):
        tassign.windowed_best_iou(gt.float()[0], gv, TCFG)
