"""tpu_pillars_torch's K11 streaming front end, K7 tiled rotated IoU and the
dense ``rotated_nms`` against the JAX package on the CPU.

* K11: the port's plain version (what the wrapper runs on a CPU tensor)
  against ``points_to_canvas_stream(..., interpret=True)`` at
  ``tiny_config()``, rtol/atol 5e-6 with the occupancy equal (the gate of
  tests/test_stream_pfn.py); the drop-in canvas against the port's fused
  ``Detector.canvas``; on the trained checkpoint at the full config, the
  stream canvas through ``wire`` and ``postprocess`` reproduces the JAX
  golden detections of a held-out scene.
* K11's pillar budget as a cutoff (``stream_budget_cutoff_plain``, the
  rule of the kernel's budget pass) against the sidecar on the cases of
  tests/stream_budget_cases.py: fewer than P runs, exactly P, a cut inside
  a 64-cell tile, an empty sample, a run at cell H*W - 1, runs of N and
  more than N points; the plain canvas zeroes exactly the cells past it.
* K7: the plain version against ``rotated_iou_bev_tiled`` (interpret mode)
  with the same blocks, atol 1e-5 (both tile alike; the rest is f32
  rounding of the same formula); the self-IoU diagonal at 1 (atol 1e-4)
  and far boxes at 0, as tests/test_iou_pallas.py holds them.
* ``ops.nms.rotated_nms``: the keep mask equals JAX's on random boxes with
  no IoU within 1e-4 of the threshold.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.ops.iou import rotated_iou_bev as jax_iou_dense
from tpu_pillars.ops.iou import iou_3d as jax_iou_3d
from tpu_pillars.ops.iou import rotated_iou_bev_chunked as jax_iou_chunked
from tpu_pillars.ops.iou_pallas import rotated_iou_bev_tiled as jax_tiled
from tpu_pillars.ops.nms import rotated_nms as jax_rotated_nms
from tpu_pillars.ops.stream_pfn import points_to_canvas_stream as jax_stream
import stream_budget_cases
from torch_port_util import assert_packed_close, random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.detector import Detector, pack_detections
from tpu_pillars_torch.ops import iou as tiou
from tpu_pillars_torch.ops import iou_tiled, stream_pfn
from tpu_pillars_torch.ops.nms import rotated_nms
from tpu_pillars_torch.weights import params_from_flax

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth4k.npz")
ARTIFACT = os.path.join(ROOT, "artifacts", "pointpillars_synth4k.msgpack")


def _stream_points(rng, cfg, b, n_live, hot_cells=0):
    """tests/test_stream_pfn.py's clouds: uniform over the range widened
    by 10-20%, optionally with hot cells over the kept-points cap."""
    M, F = cfg.max_points, cfg.num_input_features
    pts = np.zeros((b, M, F), np.float32)
    pts[..., 0] = rng.uniform(cfg.x_min * 1.1, cfg.x_max * 1.1, (b, M))
    pts[..., 1] = rng.uniform(cfg.y_min * 1.1, cfg.y_max * 1.1, (b, M))
    pts[..., 2] = rng.uniform(cfg.z_min * 1.2, cfg.z_max * 1.2, (b, M))
    for f in range(3, F):
        pts[..., f] = rng.uniform(0.0, 1.0, (b, M))
    n_hot = min(8 * cfg.max_points_per_pillar, n_live // 2)
    for i in range(b):
        for h in range(hot_cells):
            cx = rng.uniform(cfg.x_min + 1, cfg.x_max - 1)
            cy = rng.uniform(cfg.y_min + 1, cfg.y_max - 1)
            sl = slice(h * n_hot, (h + 1) * n_hot)
            pts[i, sl, 0] = cx + rng.uniform(-0.1, 0.1, n_hot)
            pts[i, sl, 1] = cy + rng.uniform(-0.1, 0.1, n_hot)
    return pts, np.full((b,), n_live, np.int32)


def _stream_weights(rng, cfg):
    D, C = cfg.num_input_features + 5, cfg.pfn_channels
    return ((rng.standard_normal((D, C)) * 0.3).astype(np.float32),
            (rng.standard_normal((C,)) * 0.1).astype(np.float32))


STREAM_CASES = {
    "no_hot_cells": (dict(), dict(b=2, n_live=3000), None),
    "hot_cells": (dict(), dict(b=2, n_live=3000, hot_cells=3), None),
    "budget_overflow": (dict(max_pillars=64), dict(b=2, n_live=2000), None),
    "counts_0_1_100": (dict(), dict(b=3, n_live=100), [0, 1, 100]),
    "multisweep": (dict(num_sweeps=2), dict(b=2, n_live=1500), None),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_canvas_matches_jax(case):
    kw, draw, counts = STREAM_CASES[case]
    cfg, tcfg = tiny_config(**kw), tconfig.tiny_config(**kw)
    rng = np.random.default_rng(sorted(STREAM_CASES).index(case))
    pts, num = _stream_points(rng, cfg, **draw)
    if counts is not None:
        num = np.asarray(counts, np.int32)
    w, b = _stream_weights(rng, cfg)
    want = np.asarray(jax_stream(jnp.asarray(pts), jnp.asarray(num),
                                 jnp.asarray(w), jnp.asarray(b), cfg,
                                 interpret=True))
    got = stream_pfn.points_to_canvas_stream(
        torch.from_numpy(pts), torch.from_numpy(num), torch.from_numpy(w),
        torch.from_numpy(b), tcfg).numpy()
    assert got.shape == want.shape == (len(num), cfg.grid_h, cfg.grid_w,
                                       cfg.pfn_channels)
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=5e-6)
    occ_g, occ_w = np.any(got != 0, axis=-1), np.any(want != 0, axis=-1)
    np.testing.assert_array_equal(occ_g, occ_w)
    assert occ_w.sum() > 50
    if counts is not None:
        assert not got[0].any() and occ_g[1].sum() == 1
    if "max_pillars" in kw:
        assert (occ_g.sum(axis=(1, 2)) == kw["max_pillars"]).all()


def test_stream_sidecar_start_rows():
    cfg = tconfig.tiny_config(max_pillars=3)
    HW = cfg.grid_h * cfg.grid_w
    gid = torch.tensor([[2, 2, 5, 7, 7, 7, 9, HW, HW],
                        [4, 4, 4, 4, HW, HW, HW, HW, HW],
                        [HW] * 9], dtype=torch.int32)
    got = stream_pfn.stream_sidecar(gid, cfg)
    assert got.tolist() == [[0, 2, 3], [0, -1, -1], [-1, -1, -1]]


@pytest.mark.parametrize("case", stream_budget_cases.CASES)
def test_stream_budget_cutoff_plain(case):
    """The budget as a cutoff: ``stream_budget_cutoff_plain`` gives the id
    of the P-th run (H*W - 1 with fewer runs); the sidecar's first P runs
    are exactly the runs at or below it; the plain canvas occupies exactly
    those cells and zeroes every cell past it."""
    cfg = tconfig.tiny_config(max_points_per_pillar=32)
    HW = cfg.grid_h * cfg.grid_w
    gid_np, runs = stream_budget_cases.budget_batch(cfg)
    s = stream_budget_cases.CASES.index(case)
    cells = runs[s]
    want = stream_budget_cases.expected_cutoff(cells, cfg)
    gid = torch.from_numpy(gid_np)
    cut = stream_pfn.stream_budget_cutoff_plain(gid, cfg)
    assert cut.dtype == torch.int32 and cut.shape == (len(runs),)
    assert int(cut[s]) == want
    start = stream_pfn.stream_sidecar(gid, cfg)[s]
    kept = cells[cells <= want]
    np.testing.assert_array_equal(gid_np[s][start[start >= 0].numpy()], kept)
    assert len(kept) == min(len(cells), cfg.max_pillars)
    pts, w_eff, w_dec = (torch.from_numpy(x) for x in
                         stream_budget_cases.budget_inputs(cfg, gid.shape))
    canvas = stream_pfn.stream_canvas_from_sorted_plain(gid, pts, w_eff,
                                                        w_dec, cfg)
    occ = canvas[s].reshape(HW, -1).ne(0).any(-1).numpy()
    expect = np.zeros(HW, bool)
    expect[kept] = True
    np.testing.assert_array_equal(occ, expect)
    assert not occ[want + 1:].any()


def test_stream_canvas_is_the_fused_canvas():
    """The drop-in: the stream canvas equals the fused front end's canvas
    (the port's Detector) to rounding, cell for cell."""
    cfg = tconfig.tiny_config()
    variables = random_variables(tiny_config(), seed=3)
    det = Detector(cfg, params_from_flax(variables, cfg), device="cpu")
    pts, num = _stream_points(np.random.default_rng(7), cfg, b=2,
                              n_live=3500, hot_cells=2)
    pts, num = torch.from_numpy(pts), torch.from_numpy(num)
    w, b = det.model.pfn.folded()
    got = stream_pfn.points_to_canvas_stream(pts, num, w, b, cfg)
    want = det.canvas(pts, num)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.ne(0).any(-1), want.ne(0).any(-1))


def test_stream_wrapper_refuses_wrong_inputs():
    cfg = tconfig.tiny_config()
    gid = torch.zeros((1, 8), dtype=torch.int32)
    w_eff, w_dec = torch.zeros((4, 32)), torch.zeros((8, 32))
    with pytest.raises(ValueError):
        stream_pfn.stream_canvas_from_sorted(gid, torch.zeros((1, 8, 3)),
                                             w_eff, w_dec, cfg)
    with pytest.raises(ValueError):
        stream_pfn.stream_canvas_from_sorted(
            gid, torch.zeros((1, 8, 9)), torch.zeros((9, 32)), w_dec, cfg)
    with pytest.raises(ValueError):
        stream_pfn.points_to_canvas_stream(
            torch.zeros((1, 8, 5)), torch.zeros(1, dtype=torch.int32),
            torch.zeros((9, 32)), torch.zeros(32), cfg)


def test_stream_path_reproduces_golden_scene():
    """Trained checkpoint, full config: the stream canvas, then the
    detector's wire and postprocess, against the JAX golden detections of
    one held-out scene (the trained-weights tolerance)."""
    cfg = tconfig.PillarsConfig()
    det = Detector.from_checkpoint(cfg, ARTIFACT, device="cpu")
    golden = np.load(GOLDEN)
    offs = golden["offsets"]
    padded, n = det.pad_points(golden["points"][offs[0]:offs[1]])
    w, b = det.model.pfn.folded()
    canvas = stream_pfn.points_to_canvas_stream(
        torch.from_numpy(padded[None]), torch.tensor([n]), w, b, cfg)
    got = pack_detections(det.postprocess(*det.wire(canvas)))[0].numpy()
    assert assert_packed_close(got, golden["packed"][0], 1e-3, 1e-2) > 0


def _random_boxes(rng, n, span=8.0):
    b = np.zeros((n, 7), dtype=np.float32)
    b[:, 0:2] = rng.uniform(-span, span, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3] = rng.uniform(0.5, 3.0, n)
    b[:, 4] = rng.uniform(0.5, 6.0, n)
    b[:, 5] = rng.uniform(0.5, 3.0, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("n,m,bi,bj", [(50, 37, 32, 32), (45, 19, 32, 16),
                                       (20, 15, 16, 16), (64, 64, 128, 128)])
def test_tiled_iou_matches_jax(n, m, bi, bj):
    rng = np.random.default_rng(n * 100 + m)
    b1, b2 = _random_boxes(rng, n), _random_boxes(rng, m)
    want = np.asarray(jax_tiled(jnp.asarray(b1), jnp.asarray(b2),
                                block_i=bi, block_j=bj, interpret=True))
    got = iou_tiled.rotated_iou_bev_tiled(torch.from_numpy(b1),
                                          torch.from_numpy(b2), bi, bj)
    assert got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert (want > 0).sum() > 10


def test_tiled_iou_self_and_far():
    b = _random_boxes(np.random.default_rng(0), 24)
    t = torch.from_numpy(b)
    iou = iou_tiled.rotated_iou_bev_tiled(t, t, 24, 24).numpy()
    np.testing.assert_allclose(np.diag(iou), 1.0, atol=1e-4)
    far = t.clone()
    far[:, 0] += 1000.0
    z = iou_tiled.rotated_iou_bev_tiled(t, far, 24, 24).numpy()
    np.testing.assert_allclose(z, 0.0, atol=1e-6)


def test_tiled_iou_batched_equals_per_sample():
    rng = np.random.default_rng(4)
    b1 = torch.from_numpy(np.stack([_random_boxes(rng, 40) for _ in range(3)]))
    b2 = torch.from_numpy(np.stack([_random_boxes(rng, 30) for _ in range(3)]))
    got = iou_tiled.rotated_iou_bev_tiled(b1, b2, 16, 16)
    assert got.shape == (3, 40, 30)
    for s in range(3):
        assert torch.equal(got[s], iou_tiled.rotated_iou_bev_tiled(
            b1[s], b2[s], 16, 16))
    with pytest.raises(ValueError):
        iou_tiled.rotated_iou_bev_tiled(b1, b2[0], 16, 16)
    empty = iou_tiled.rotated_iou_bev_tiled(b1[0, :0], b2[0], 16, 16)
    assert empty.shape == (0, 30)


def test_chunked_and_3d_iou_match_jax():
    rng = np.random.default_rng(5)
    b1, b2 = _random_boxes(rng, 70), _random_boxes(rng, 33)
    for jfn, tfn in ((lambda a, b: jax_iou_chunked(a, b, chunk=16),
                      lambda a, b: tiou.rotated_iou_bev_chunked(a, b, 16)),
                     (jax_iou_3d, tiou.iou_3d),
                     (jax_iou_dense, tiou.rotated_iou_bev)):
        want = np.asarray(jfn(jnp.asarray(b1), jnp.asarray(b2)))
        got = tfn(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
        assert got.shape == (70, 33)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_nms_matches_jax(seed):
    rng = np.random.default_rng(seed)
    K, thr = 96, 0.2
    boxes = _random_boxes(rng, K, span=6.0)
    valid = rng.random(K) < 0.9
    iou = np.asarray(jax_iou_dense(jnp.asarray(boxes), jnp.asarray(boxes)))
    off = ~np.eye(K, dtype=bool)
    assert np.abs(iou[off] - thr).min() > 1e-4     # no boundary pairs
    scores = np.sort(rng.random(K).astype(np.float32))[::-1].copy()
    want = np.asarray(jax_rotated_nms(jnp.asarray(boxes),
                                      jnp.asarray(scores),
                                      jnp.asarray(valid), thr))
    got = rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(valid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()
