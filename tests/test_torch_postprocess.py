"""tpu_pillars_torch NMS overlap matrix (K4), class-blocked NMS and the
serving postprocess vs the JAX package on the CPU. The JAX overlap kernel
runs in interpret mode, the port its plain version. Overlap matrices must be
equal except pairs whose float64 IoU is within 1e-4 of the threshold, and
keep sets equal (tests/test_nms_pallas.py's contract)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.ops.anchors import make_anchors
from tpu_pillars.ops.nms_pallas import (
    overlap_matrix_pallas, rotated_nms_pallas,
)
from tpu_pillars.ops.postprocess import postprocess_w as jax_postprocess_w
from tpu_pillars.reference_cpu.postprocess import rotated_iou_bev_np
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.ops import anchors as tanchors
from tpu_pillars_torch.ops import box_coder as tcoder
from tpu_pillars_torch.ops import iou as tiou
from tpu_pillars_torch.ops import nms_overlap as tnms
from tpu_pillars_torch.ops import postprocess as tpost

THR = 0.2
BOUNDARY_TOL = 1e-4


def _random_boxes(rng, n, span=10.0):
    b = np.zeros((n, 7), dtype=np.float32)
    b[:, 0:2] = rng.uniform(-span, span, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3] = rng.uniform(0.5, 3.0, n)
    b[:, 4] = rng.uniform(0.5, 6.0, n)
    b[:, 5] = rng.uniform(0.5, 3.0, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _class_shifted(rng, n, span, num_classes=9):
    b = _random_boxes(rng, n, span=span)
    cls = rng.integers(0, num_classes, n)
    b[:, 0] += cls * 4.0 * (2 * span + 2 * span)
    return b, cls


def _boundary_only(got, want, boxes):
    if np.array_equal(got, want):
        return
    bad = np.argwhere(got != want)
    iou64 = np.diagonal(rotated_iou_bev_np(boxes[bad[:, 0]],
                                           boxes[bad[:, 1]]))
    assert np.all(np.abs(iou64 - THR) < BOUNDARY_TOL), (
        f"{len(bad)} non-boundary flips, worst |iou-thr|="
        f"{np.max(np.abs(iou64 - THR)):.2e}")


SCENES = {
    "dense": lambda rng: _random_boxes(rng, 128, span=6.0),
    "ragged": lambda rng: _random_boxes(rng, 200, span=8.0),
    "class_shifted": lambda rng: _class_shifted(rng, 256, span=8.0)[0],
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_overlap_matrix_matches_jax(rng, scene):
    boxes = SCENES[scene](rng)
    want = np.asarray(overlap_matrix_pallas(jnp.asarray(boxes), THR,
                                            interpret=True))
    got = tnms.overlap_matrix(torch.from_numpy(boxes)[None], THR)[0].numpy()
    _boundary_only(got, want, boxes)
    assert got.sum() > 0


def test_rotated_iou_matches_oracle(rng):
    a, b = _random_boxes(rng, 40, span=4.0), _random_boxes(rng, 50, span=4.0)
    got = tiou.rotated_iou_bev(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), rotated_iou_bev_np(a, b),
                               atol=1e-4)


def test_keep_sets_match_jax(rng):
    n = 256
    boxes, cls, valid = [], [], []
    for _ in range(3):
        b, c = _class_shifted(rng, n, span=30.0)
        boxes.append(b)
        cls.append(c)
        valid.append(rng.uniform(size=n) > 0.1)
    boxes, cls, valid = np.stack(boxes), np.stack(cls), np.stack(valid)
    got = tnms.rotated_nms_overlap(
        torch.from_numpy(boxes), torch.from_numpy(valid), THR,
        class_ids=torch.from_numpy(cls), class_gap=4.0 * 120.0).numpy()
    scores = jnp.ones((n,), jnp.float32)
    for s in range(3):
        want = np.asarray(rotated_nms_pallas(
            jnp.asarray(boxes[s]), scores, jnp.asarray(valid[s]), THR,
            class_ids=jnp.asarray(cls[s], jnp.int32), class_gap=4.0 * 120.0,
            interpret=True))
        np.testing.assert_array_equal(got[s], want)


def test_keep_valid_mask_semantics():
    # an invalid top box neither keeps nor suppresses
    boxes = np.tile(np.array([[0, 0, 0, 2, 4, 1, 0.2]], np.float32), (4, 1))
    valid = np.array([[False, True, True, True]])
    keep = tnms.rotated_nms_overlap(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(keep.numpy()[0], [False, True, False, False])


def test_box_coder_round_trip(rng):
    anchors = _random_boxes(rng, 64)
    boxes = _random_boxes(rng, 64)
    back = tcoder.decode_boxes(
        tcoder.encode_boxes(torch.from_numpy(boxes),
                            torch.from_numpy(anchors)),
        torch.from_numpy(anchors))
    np.testing.assert_allclose(back.numpy(), boxes, atol=1e-4)


def test_wrap_angle_matches_jax():
    from tpu_pillars.ops.postprocess import wrap_angle

    a = np.linspace(-12.0, 12.0, 4001, dtype=np.float32)
    a = np.concatenate([a, np.float32([np.pi, -np.pi, 3 * np.pi, 0.0])])
    np.testing.assert_array_equal(
        tpost.wrap_angle(torch.from_numpy(a)).numpy(),
        np.asarray(wrap_angle(jnp.asarray(a))))


def _wire(rng, cfg, batch, ties=False):
    A = cfg.num_anchors
    own = rng.normal(-4.0, 1.0, (batch, A)).astype(np.float32)
    for b in range(batch):
        hot = rng.choice(A, 60, replace=False)
        own[b, hot] = rng.normal(3.0, 1.0, 60)
        if ties:
            # saturated scores: sigmoid(40) == 1.0 exactly in f32, so these
            # anchors tie and only the lowest-index rule orders them
            own[b, hot[:40]] = 40.0
    box_p = rng.normal(0, 0.1, (batch, 7, A)).astype(np.float32)
    dir_p = rng.normal(0, 1.0, (batch, 2, A)).astype(np.float32)
    return own, box_p, dir_p


@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
def test_postprocess_w_matches_jax(rng, ties):
    cfg, tcfg = tiny_config(), tconfig.tiny_config()
    own, box_p, dir_p = _wire(rng, cfg, 2, ties=ties)
    anchors, anchor_cls = make_anchors(cfg)
    t_anchors, t_cls = tanchors.make_anchors(tcfg)
    got = tpost.postprocess_w(
        torch.from_numpy(own), torch.from_numpy(box_p),
        torch.from_numpy(dir_p), torch.from_numpy(np.array(t_anchors)),
        torch.from_numpy(np.array(t_cls, np.int64)), tcfg)
    for b in range(2):
        want = jax_postprocess_w(
            jnp.asarray(own[b]), jnp.asarray(box_p[b]), jnp.asarray(dir_p[b]),
            jnp.asarray(anchors), jnp.asarray(anchor_cls), cfg,
            nms_impl="pallas")
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
        # several saturated boxes survive NMS, so their order was decided by
        # the tie rule alone
        assert ((got.scores == 1.0).sum(dim=1) >= 2).all()


def test_top_k_stable_breaks_ties_low_index():
    x = torch.tensor([[0.5, 1.0, 0.2, 1.0, 1.0, -1.0]])
    vals, idx = tpost.top_k_stable(x, 4)
    assert idx.tolist() == [[1, 3, 4, 0]]
    assert vals.tolist() == [[1.0, 1.0, 1.0, 0.5]]
