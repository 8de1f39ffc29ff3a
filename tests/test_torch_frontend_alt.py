"""The front end's alternative kernels in tpu_pillars_torch vs the JAX
package on the CPU, bit for bit. The JAX Pallas kernels run in interpret
mode, at the sizes of the JAX package's own tests; the port runs its
kernels' plain versions (CPU tensors).

* K10: the plain bitonic network against ``sort_points_by_pillar_bitonic``
  at a power-of-two M, a padded M and an all-invalid sample, and against
  the port's stable ``torch.sort`` path, with and without the payload
  carried;
* K8: the plain rank and histogram against ``rank_and_hist`` — the rank
  saturated at 64 (the JAX contract: exact below 64, >= 64 above), the
  histogram exactly — including 200 points in one cell; and
  ``pillarize_batch_binned`` against the JAX one and ``pillarize_batch``;
* K9: the plain block gather against ``scatter_to_bev_emit``, including a
  dense full grid, and against the port's K3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.ops import binning_pallas as jbin
from tpu_pillars.ops import voxelize as jvox
from tpu_pillars.ops.bev_pallas import scatter_to_bev_emit as jbev_emit
from tpu_pillars.ops.sort_pallas import sort_points_by_pillar_bitonic as jsort
from torch_port_util import cloud_batch, dense_cell_batch
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.ops import bev as tbev
from tpu_pillars_torch.ops import binning as tbin
from tpu_pillars_torch.ops import sort as tsort
from tpu_pillars_torch.ops import voxelize as tvox

CFG = tiny_config()
TCFG = tconfig.tiny_config()


def _dup_cloud(rng, cfg, b, m, frac_out=0.2):
    """tests/test_sort_pallas.py's clouds: half the points share one x, so
    many pillars hold many points (stability matters)."""
    pts = np.zeros((b, m, 4), np.float32)
    pts[..., 0] = rng.uniform(cfg.x_min - 10, cfg.x_max + 10, (b, m))
    pts[..., 1] = rng.uniform(cfg.y_min - 10, cfg.y_max + 10, (b, m))
    pts[..., 2] = rng.uniform(cfg.z_min - 1, cfg.z_max + 1, (b, m))
    pts[..., 3] = rng.uniform(0, 1, (b, m))
    narrow = rng.integers(0, 2, (b, m)).astype(bool)
    pts[..., 0] = np.where(narrow, np.float32(cfg.x_min + 1.0), pts[..., 0])
    n = rng.integers(int(m * (1 - frac_out)), m + 1, (b,)).astype(np.int32)
    return pts, n


@pytest.mark.parametrize("m", [4096, 1536])       # power of two and padded
def test_bitonic_plain_matches_jax(rng, m):
    pts, n = _dup_cloud(rng, CFG, 2, m)
    want_k, want_p = jsort(jnp.asarray(pts), jnp.asarray(n), CFG,
                           carry_payload=False, interpret=True)
    args = (torch.from_numpy(pts), torch.from_numpy(n), TCFG)
    for carry in (True, False):
        got_k, got_p = tsort.sort_points_by_pillar_bitonic(
            *args, carry_payload=carry)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    ref_k, ref_p = tvox.sort_points_by_pillar(*args)
    assert torch.equal(got_k, ref_k) and torch.equal(got_p, ref_p)


def test_bitonic_plain_all_invalid(rng):
    pts, _ = _dup_cloud(rng, CFG, 1, 1024)
    n = np.zeros((1,), np.int32)
    want_k, want_p = jsort(jnp.asarray(pts), jnp.asarray(n), CFG,
                           carry_payload=False, interpret=True)
    got_k, got_p = tsort.sort_points_by_pillar_bitonic(
        torch.from_numpy(pts), torch.from_numpy(n), TCFG)
    assert (got_k.numpy() == CFG.grid_h * CFG.grid_w).all()
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("m", [1, 2, 5, 64, 300])
def test_bitonic_plain_is_the_stable_order(rng, m):
    """Any M (padded to a power of two), negative keys and heavy ties: the
    keys, the order and the carried payload are those of a stable sort."""
    key = rng.integers(-3, 4, (3, m)).astype(np.int32)
    key[0, :2] = np.iinfo(np.int32).max         # pad-valued real keys
    pay = rng.normal(size=(3, m, 2)).astype(np.float32)
    got_k, order, got_p = tsort.bitonic_sort(torch.from_numpy(key),
                                             torch.from_numpy(pay))
    want_order = np.argsort(key, axis=1, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(got_k.numpy(),
                                  np.take_along_axis(key, want_order, 1))
    np.testing.assert_array_equal(
        got_p.numpy(), np.take_along_axis(pay, want_order[..., None], 1))
    assert tsort.bitonic_sort(torch.from_numpy(key))[2] is None


def _rank_both(rows, cols, h_bins, w_pad, **jkw):
    jr, jh = jbin.rank_and_hist(jnp.asarray(rows), jnp.asarray(cols), h_bins,
                                w_pad, interpret=True, **jkw)
    tr, th = tbin.rank_and_hist(torch.from_numpy(rows),
                                torch.from_numpy(cols), h_bins, w_pad)
    return np.asarray(jr), np.asarray(jh), tr.numpy(), th.numpy()


def test_rank_and_hist_values_match_jax():
    h_bins, w_pad = 8, 128
    rows = np.asarray([[0, 0, 0, 2, 2, 0, h_bins, 0]], np.int32)
    cols = np.asarray([[5, 5, 9, 5, 5, 5, 0, 5]], np.int32)
    jr, jh, tr, th = _rank_both(rows, cols, h_bins, w_pad, chunk=4)
    valid = rows < h_bins
    np.testing.assert_array_equal(tr[valid], jr[valid])
    np.testing.assert_array_equal(tr[0], [0, 1, 0, 0, 1, 2, 0, 3])
    np.testing.assert_array_equal(th, jh)


@pytest.mark.parametrize("chunk", [32, 1024])
def test_rank_saturates_at_cap_like_jax(chunk):
    """200 points in one cell (tests/test_binning_pallas.py): the JAX rank
    above 63 depends on its chunk, the port's is 64; min(rank, 64) agrees
    and the histogram holds 64."""
    h_bins, w_pad, n = 8, 128, 200
    rows = np.zeros((1, n), np.int32)
    cols = np.full((1, n), 3, np.int32)
    jr, jh, tr, th = _rank_both(rows, cols, h_bins, w_pad, chunk=chunk)
    np.testing.assert_array_equal(tr, np.minimum(jr, 64))
    np.testing.assert_array_equal(tr[0], np.minimum(np.arange(n), 64))
    np.testing.assert_array_equal(th, jh)
    assert th[0, 0, 3] == 64.0


def _saturating_cloud(rng):
    """tests/test_binning_pallas.py's dense cells: 2,000 points in eight
    cells (ranks far past 64), input order riding the intensity, beside a
    uniform cloud."""
    n = 2000
    pts = np.full((2, CFG.max_points, 4), 1e6, np.float32)
    pts[0, :n, 0] = rng.choice([0.1, 0.7, -3.2, 5.9], n)
    pts[0, :n, 1] = rng.choice([0.1, -1.3], n)
    pts[0, :n, 2] = 0.0
    pts[0, :n, 3] = np.arange(n)
    rest, _ = cloud_batch(rng, [3000], CFG, margin=4.0)
    pts[1] = rest[0]
    return pts, np.asarray([n, 3000], np.int32)


BINNED = {
    "random": lambda rng: cloud_batch(rng, [3000, 4096, 1, 0], CFG,
                                      margin=4.0),
    "saturating": _saturating_cloud,
    "one_cell": lambda rng: dense_cell_batch(rng, CFG),
}


@pytest.mark.parametrize("case", sorted(BINNED))
def test_binned_matches_jax(rng, case):
    pts, ns = BINNED[case](rng)
    args = (torch.from_numpy(pts), torch.from_numpy(ns), TCFG)
    rows, cols = tbin.cell_rows_cols(*args)
    jr, jh, tr, th = _rank_both(rows.numpy(), cols.numpy(), TCFG.grid_h,
                                tbin.padded_width(TCFG))
    valid = rows.numpy() < TCFG.grid_h
    np.testing.assert_array_equal(tr[valid], np.minimum(jr, 64)[valid])
    np.testing.assert_array_equal(th, jh)

    got = tbin.pillarize_batch_binned(*args)
    want = jbin.pillarize_batch_binned(jnp.asarray(pts), jnp.asarray(ns),
                                       CFG, interpret=True)
    own = tvox.pillarize_batch(*args)
    for name in ("features", "mask", "coords", "pillar_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert torch.equal(getattr(got, name), getattr(own, name)), name


def test_binned_pillar_budget(rng):
    """More occupied cells than pillars: the first P by ascending id."""
    jcfg, tcfg = tiny_config(max_pillars=64), tconfig.tiny_config(
        max_pillars=64)
    pts, ns = cloud_batch(rng, [4096, 4096], jcfg, margin=4.0)
    got = tbin.pillarize_batch_binned(torch.from_numpy(pts),
                                      torch.from_numpy(ns), tcfg)
    want = jvox.pillarize_batch(jnp.asarray(pts), jnp.asarray(ns), jcfg)
    assert got.pillar_mask.all()
    for name in ("features", "mask", "coords", "pillar_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _bev_inputs(rng, dense):
    """(feats, pid, mask) of a pillarized random cloud, or every pillar
    slot occupied with ids packed at the grid start (tile edges where the
    range spans a whole tile)."""
    if dense:
        B, P = 2, TCFG.max_pillars
        pid = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)).copy()
        mask = np.ones((B, P), bool)
    else:
        pts, ns = cloud_batch(rng, [3000, 4096, 0], CFG)
        batch = tvox.pillarize_batch(torch.from_numpy(pts),
                                     torch.from_numpy(ns), TCFG)
        coords = batch.coords.numpy()
        pid = (coords[..., 0] * TCFG.grid_w + coords[..., 1]).astype(
            np.int32)
        mask = batch.pillar_mask.numpy()
    feats = rng.normal(size=pid.shape + (64 if dense else 32,)).astype(
        np.float32)
    return feats, pid, mask


@pytest.mark.parametrize("dense", [False, True])
def test_block_gather_matches_jax(rng, dense):
    feats, pid, mask = _bev_inputs(rng, dense)
    want = jbev_emit(jnp.asarray(feats), jnp.asarray(pid), jnp.asarray(mask),
                     CFG, interpret=True)
    args = (torch.from_numpy(feats), torch.from_numpy(pid),
            torch.from_numpy(mask), TCFG)
    got = tbev.scatter_to_bev_emit(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tbev.scatter_to_bev(*args))


def test_block_gather_empty_and_sparse():
    """No valid pillar, and two pillars at opposite grid corners."""
    C, P, HW = 8, 16, TCFG.grid_h * TCFG.grid_w
    feats = torch.arange(2 * P * C, dtype=torch.float32).reshape(2, P, C)
    pid = torch.zeros((2, P), dtype=torch.int32)
    pid[1, :2] = torch.tensor([0, HW - 1], dtype=torch.int32)
    mask = torch.zeros((2, P), dtype=torch.bool)
    mask[1, :2] = True
    got = tbev.scatter_to_bev_emit(feats, pid, mask, TCFG)
    assert torch.equal(got, tbev.scatter_to_bev(feats, pid, mask, TCFG))
    assert not got[0].any()
    assert torch.equal(got[1, 0, 0], feats[1, 0])
    assert torch.equal(got[1, -1, -1], feats[1, 1])
