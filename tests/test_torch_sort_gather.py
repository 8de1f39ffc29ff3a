"""K10's and K9's wrappers in tpu_pillars_torch vs the JAX package on the
CPU, bit for bit (equality throughout: both are permutations and copies).
The JAX Pallas kernels run in interpret mode; the port runs its kernels'
plain versions (CPU tensors). On the card the same wrappers launch
``csrc/radix_sort.cu`` and ``csrc/bev_gather.cu`` (``tests/test_torch_cuda.py``).

* K10: ``sort_points_by_pillar_bitonic``, with the payload carried and
  gathered after, against the JAX one; ``bitonic_sort`` against the JAX
  ``_sort_batched`` and the stable ``torch.sort`` for negative keys,
  INT32_MAX, all-equal keys, M = 1, 1,536 and 20,000; the wrapper refuses
  ``key_bits`` outside 1..32. On a CPU tensor the wrapper runs the plain
  network whatever ``key_bits`` says: the key widths are exercised on the
  card (``test_radix_kernel_key_bits``, ``chip_smoke.py``);
* K9's sidecar: ``block_row_ranges_plain`` against the JAX wrapper's
  comparison count, written in numpy, at the kernel's tile size, for empty,
  sparse, dense and last-cell samples, and a grid that is not a multiple
  of the tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import PillarsConfig
from tpu_pillars.ops.sort_pallas import _sort_batched
from tpu_pillars.ops.sort_pallas import sort_points_by_pillar_bitonic as jsort
from tpu_pillars_torch import _build
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.ops import bev as tbev
from tpu_pillars_torch.ops import sort as tsort
from tpu_pillars_torch.ops import voxelize as tvox

INT32_MAX = np.iinfo(np.int32).max
INT32_MIN = np.iinfo(np.int32).min


def _full_size_cloud(rng, cfg, b, m):
    """Points over the full grid and beyond it (sentinel keys), half of
    them on one x so that many share a pillar (stability matters)."""
    pts = np.zeros((b, m, 4), np.float32)
    pts[..., 0] = rng.uniform(cfg.x_min - 10, cfg.x_max + 10, (b, m))
    pts[..., 1] = rng.uniform(cfg.y_min - 10, cfg.y_max + 10, (b, m))
    pts[..., 2] = rng.uniform(cfg.z_min - 1, cfg.z_max + 1, (b, m))
    pts[..., 3] = rng.uniform(0, 1, (b, m))
    narrow = rng.integers(0, 2, (b, m)).astype(bool)
    pts[..., 0] = np.where(narrow, np.float32(cfg.x_min + 1.0), pts[..., 0])
    n = np.asarray([m, m * 3 // 4], np.int32)[:b]
    return pts, n


@pytest.mark.parametrize("carry", [True, False])
def test_sort_by_pillar_matches_jax(rng, carry):
    cfg, tcfg = PillarsConfig(), tconfig.PillarsConfig()
    pts, n = _full_size_cloud(rng, cfg, 2, 1536)
    want_k, want_p = jsort(jnp.asarray(pts), jnp.asarray(n), cfg,
                           carry_payload=carry, interpret=True)
    args = (torch.from_numpy(pts), torch.from_numpy(n), tcfg)
    got_k, got_p = tsort.sort_points_by_pillar_bitonic(*args,
                                                       carry_payload=carry)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    ref_k, ref_p = tvox.sort_points_by_pillar(*args)
    assert torch.equal(got_k, ref_k) and torch.equal(got_p, ref_p)


def _keys(rng, kind, m):
    if kind == "mixed":                 # negatives, INT32_MIN and _MAX
        key = rng.integers(-5, 50, (2, m)).astype(np.int32)
        key[0, : min(m, 3)] = INT32_MAX
        key[1, m // 2] = INT32_MIN
    elif kind == "equal":
        key = np.full((2, m), 7, np.int32)
    else:                               # every key the pad value
        key = np.full((2, m), INT32_MAX, np.int32)
    return key


@pytest.mark.parametrize("kind", ["mixed", "equal", "int32_max"])
@pytest.mark.parametrize("m", [1, 1536, 20000])
def test_bitonic_sort_matches_jax_and_stable_sort(rng, m, kind):
    key = _keys(rng, kind, m)
    pay = rng.normal(size=(2, m, 4)).astype(np.float32)
    m_pad = max(128, 1 << (m - 1).bit_length())
    want = _sort_batched(jnp.asarray(key), jnp.asarray(pay), m_pad, True,
                         True)
    got = tsort.bitonic_sort(torch.from_numpy(key), torch.from_numpy(pay))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ref_k, ref_o = torch.sort(torch.from_numpy(key), dim=1, stable=True)
    assert torch.equal(got[0], ref_k) and torch.equal(got[1].long(), ref_o)


@pytest.mark.parametrize("key_bits", [0, 33])
def test_bitonic_sort_refuses_key_bits(key_bits):
    key = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="key_bits"):
        tsort.bitonic_sort(key, key_bits=key_bits)


def test_kernel_sources_exist():
    """Every kernel the build names has its source; K10's is the radix
    sort."""
    assert "radix_sort" in _build.KERNELS
    assert "bitonic_sort" not in _build.KERNELS
    for name in _build.KERNELS:
        assert (_build.SRC_DIR / f"{name}.cu").is_file(), name


HW_TINY = 80 * 80


def _ranges_case(rng, case):
    """(pid, mask, hw) with where(mask, pid, hw) ascending per sample."""
    if case == "empty":
        pid = np.zeros((2, 16), np.int32)
        return pid, np.zeros_like(pid, bool), HW_TINY
    if case == "dense":                 # every cell holds a pillar
        pid = np.broadcast_to(np.arange(HW_TINY, dtype=np.int32),
                              (2, HW_TINY)).copy()
        return pid, np.ones_like(pid, bool), HW_TINY
    if case == "sparse":                # a few pillars, masked ones last
        pid = np.zeros((3, 40), np.int32)
        mask = np.zeros_like(pid, bool)
        for b, n in enumerate((25, 1, 0)):
            pid[b, :n] = np.sort(rng.choice(HW_TINY, n, replace=False))
            mask[b, :n] = True
        return pid, mask, HW_TINY
    if case == "last_cell":
        # sample 0: one full tile, then cell HW - 1; sample 1: cell HW - 1
        # alone; masked rows after both
        tile = tbev.GATHER_TILE_CELLS
        pid = np.zeros((2, tile + 6), np.int32)
        mask = np.zeros_like(pid, bool)
        pid[0, :tile + 1] = np.append(np.arange(3 * tile, 4 * tile),
                                      HW_TINY - 1)
        mask[0, :tile + 1] = True
        pid[1, 0] = HW_TINY - 1
        mask[1, 0] = True
        return pid, mask, HW_TINY
    # "ragged": a grid that is not a multiple of the tile, sentinels
    # counted in the last tile's bound
    hw = 1000
    pid = np.zeros((2, 30), np.int32)
    mask = np.zeros_like(pid, bool)
    pid[0, :20] = np.sort(rng.choice(hw, 20, replace=False))
    mask[0, :20] = True
    pid[1, :2] = [0, hw - 1]
    mask[1, :2] = True
    return pid, mask, hw


@pytest.mark.parametrize("case", ["empty", "sparse", "dense", "last_cell",
                                  "ragged"])
def test_block_row_ranges_plain_matches_jax_count(rng, case):
    pid, mask, hw = _ranges_case(rng, case)
    eff = np.where(mask, pid, hw)
    assert (np.diff(eff, axis=1) >= 0).all()
    tile = tbev.GATHER_TILE_CELLS
    bounds = np.arange(-(-hw // tile) + 1, dtype=np.int32) * tile
    want = (eff[:, :, None] < bounds[None, None, :]).sum(1, dtype=np.int32)
    args = (torch.from_numpy(pid), torch.from_numpy(mask), hw)
    got = tbev.block_row_ranges_plain(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tbev.block_row_ranges(*args), got)
    with pytest.raises(TypeError):
        tbev.block_row_ranges(args[0].long(), args[1], hw)
    # each tile's rows [lo[t], lo[t + 1]) hold exactly its valid pillars
    for b in range(pid.shape[0]):
        for t in range(len(bounds) - 1):
            rows = eff[b, want[b, t]:want[b, t + 1]]
            inside = (eff[b] >= bounds[t]) & (eff[b] < bounds[t + 1])
            assert len(rows) == inside.sum()
            assert ((rows >= bounds[t]) & (rows < bounds[t + 1])).all()
