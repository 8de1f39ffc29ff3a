"""tpu_pillars_torch front end vs the JAX package on the CPU: sort +
pillarize (bit-equal), the K1 emit table (bit-equal table/count/pid, sums to
1e-4; K1's run rule, ``emit_runs_plain``, against the plain table and the
runs of tests/emit_run_cases.py), the K2 fused PFN (atol 2e-4, rtol 1e-4 —
tests/test_fused_pfn.py's tolerance) and the K3 scatter (bit-equal). The JAX Pallas kernels run in
interpret mode; the port runs its kernels' plain versions (CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import multisweep_config, tiny_config
from tpu_pillars.ops import emit_pallas as jemit
from tpu_pillars.ops import fused_pfn as jfused
from tpu_pillars.ops import voxelize as jvox
from tpu_pillars.ops.bev_pallas import scatter_to_bev_ring
import emit_run_cases
from torch_port_util import cloud_batch, dense_cell_batch
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.ops import bev as tbev
from tpu_pillars_torch.ops import emit as temit
from tpu_pillars_torch.ops import fused_pfn as tfused
from tpu_pillars_torch.ops import voxelize as tvox

CFG = tiny_config()
TCFG = tconfig.tiny_config()


def _cloud(rng, ns, cfg=CFG, f=4, margin=2.0):
    return cloud_batch(rng, ns, cfg, f=f, margin=margin)


def _dense_cell(rng):
    return dense_cell_batch(rng, CFG)


def _pair(cfg_name, **kw):
    """(jax config, port config) of one family."""
    fam = {"tiny": (tiny_config, tconfig.tiny_config),
           "multisweep": (multisweep_config, tconfig.multisweep_config)}
    j, t = fam[cfg_name]
    return j(**kw), t(**kw)


CASES = {
    "random": lambda rng: _cloud(rng, [3000, 4096, 1, 0]),
    "one_cell": lambda rng: _dense_cell(rng),
    "budget": lambda rng: _cloud(rng, [4096, 4096]),
    "empty": lambda rng: _cloud(rng, [0, 0]),
}


def _configs(case):
    if case == "budget":
        return tiny_config(max_pillars=64), tconfig.tiny_config(max_pillars=64)
    return CFG, TCFG


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_and_pillarize_bit_equal(rng, case):
    jcfg, tcfg = _configs(case)
    pts, ns = CASES[case](rng)
    jg, jp = jemit.sort_points_by_pillar(jnp.asarray(pts), jnp.asarray(ns),
                                         jcfg)
    tg, tp = tvox.sort_points_by_pillar(torch.from_numpy(pts),
                                        torch.from_numpy(ns), tcfg)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    want = jvox.pillarize_batch(jnp.asarray(pts), jnp.asarray(ns), jcfg)
    got = tvox.pillarize_batch(torch.from_numpy(pts), torch.from_numpy(ns),
                               tcfg)
    for name in ("mask", "coords", "pillar_mask", "features"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _emit_both(gid, pts, n_pts, p_budget, hw):
    B, M, F = pts.shape
    jt, jm = jemit.emit_table_flat(jnp.asarray(gid), jnp.asarray(pts), n_pts,
                                   F, p_budget, hw, interpret=True)
    jt = np.asarray(jt).reshape(B, -1, jt.shape[-1])[:, :p_budget,
                                                     :n_pts * F]
    jm = np.asarray(jm).reshape(B, 8, -1)[:, :, :p_budget]
    tt, tm = temit.emit_table(torch.from_numpy(gid), torch.from_numpy(pts),
                              n_pts, p_budget, hw)
    return (jt, jm, tt.numpy().reshape(B, p_budget, n_pts * F),
            tm.numpy().reshape(B, 8, p_budget))


def _assert_emit_equal(jt, jm, tt, tm):
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm[:, :2], jm[:, :2])      # count, pid
    np.testing.assert_allclose(tm[:, 2:5], jm[:, 2:5], atol=1e-4)
    assert not tm[:, 5:].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_emit_matches_jax(rng, case):
    jcfg, tcfg = _configs(case)
    pts, ns = CASES[case](rng)
    tg, tp = tvox.sort_points_by_pillar(torch.from_numpy(pts),
                                        torch.from_numpy(ns), tcfg)
    tp = tfused.center_points(tg, tp, tcfg)
    jt, jm, tt, tm = _emit_both(tg.numpy(), tp.numpy(),
                                tcfg.max_points_per_pillar,
                                tcfg.max_pillars,
                                tcfg.grid_h * tcfg.grid_w)
    _assert_emit_equal(jt, jm, tt, tm)
    if case == "budget":
        assert (tm[:, 0] > 0).all()          # the pillar budget was hit
    if case == "empty":
        assert not tt.any() and not tm.any()
    if case == "one_cell":
        assert tm[0, 0].max() == tcfg.max_points_per_pillar


def test_emit_multisweep_f5(rng):
    jcfg, tcfg = _pair("multisweep", num_sweeps=3, max_points=4096,
                       max_pillars=2000, max_points_per_pillar=16)
    pts, ns = _cloud(rng, [3500, 900], cfg=jcfg, f=5, margin=-60.0)
    tg, tp = tvox.sort_points_by_pillar(torch.from_numpy(pts),
                                        torch.from_numpy(ns), tcfg)
    jt, jm, tt, tm = _emit_both(tg.numpy(), tp.numpy(), 16, 2000,
                                tcfg.grid_h * tcfg.grid_w)
    _assert_emit_equal(jt, jm, tt, tm)


def _run_batch(f):
    return emit_run_cases.run_batch(TCFG, f=f, chunk=temit.EMIT_CHUNK_ROWS)


@pytest.mark.parametrize("f", [4, 5])
def test_emit_runs_plain_holds_the_run_structure(f):
    """K1's run rule on emit_run_cases' streams (more runs than P, exactly
    P, runs across chunk edges, a run far longer than N, an empty sample,
    every id valid with a run at cell H*W - 1): ``kept`` is min(runs, P),
    ``starts`` each kept run's first row and the end of the last; the
    plain table's rows and meta follow from them."""
    gid, pts, runs = _run_batch(f)
    S, M = gid.shape
    P, N = TCFG.max_pillars, TCFG.max_points_per_pillar
    HW = TCFG.grid_h * TCFG.grid_w
    starts, kept = temit.emit_runs_plain(torch.from_numpy(gid), P, HW)
    table, meta = temit.emit_table_plain(torch.from_numpy(gid),
                                         torch.from_numpy(pts), N, P, HW)
    assert starts.shape == (S, P + 1) and starts.dtype == torch.int32
    starts, kept = starts.numpy(), kept.numpy()
    table = table.numpy().reshape(S, P, N, f)
    meta = meta.numpy().reshape(S, 8, P)
    for s, (cells, lens) in enumerate(runs):
        k = min(len(cells), P)
        assert kept[s] == k, emit_run_cases.CASES[s]
        first = np.concatenate([[0], np.cumsum(lens)])
        n_set = k + 1 if k else 0
        np.testing.assert_array_equal(starts[s, :n_set], first[:n_set])
        assert (starts[s, n_set:] == -1).all()
        cnt = np.minimum(lens[:k], N)
        np.testing.assert_array_equal(meta[s, 0, :k], cnt)
        np.testing.assert_array_equal(meta[s, 1, :k], cells[:k])
        assert not meta[s, :, k:].any() and not table[s, k:].any()
        for r in range(k):
            kept_pts = pts[s, first[r]:first[r] + cnt[r]]
            np.testing.assert_array_equal(table[s, r, :cnt[r]], kept_pts)
            assert not table[s, r, cnt[r]:].any()
            np.testing.assert_array_equal(
                meta[s, 2:5, r], np.add.accumulate(kept_pts[:, :3])[-1])
    assert emit_run_cases.CASES[-1] == "last_cell_full"
    assert (gid[-1] < HW).all() and gid[-1, -1] == HW - 1


@pytest.mark.parametrize("f", [4, 5])
def test_emit_run_cases_match_jax(f):
    gid, pts, _ = _run_batch(f)
    jt, jm, tt, tm = _emit_both(gid, pts, TCFG.max_points_per_pillar,
                                TCFG.max_pillars, TCFG.grid_h * TCFG.grid_w)
    _assert_emit_equal(jt, jm, tt, tm)


def test_emit_centered_table_matches_jax(rng):
    pts, ns = _cloud(rng, [3000, 1500])
    jt, jm = jfused.emit_centered_table(jnp.asarray(pts), jnp.asarray(ns),
                                        CFG, interpret=True)
    tt, tm = tfused.emit_centered_table(torch.from_numpy(pts),
                                        torch.from_numpy(ns), TCFG)
    P, NF = TCFG.max_pillars, TCFG.max_points_per_pillar * 4
    jt = np.asarray(jt).reshape(2, -1, jt.shape[-1])[:, :P, :NF]
    jm = np.asarray(jm).reshape(2, 8, -1)[:, :, :P]
    _assert_emit_equal(jt, jm, tt.numpy().reshape(2, P, NF),
                       tm.numpy().reshape(2, 8, P))


def _pfn_weights(rng, cfg):
    D, C = cfg.num_decorated_features, cfg.pfn_channels
    w = (rng.normal(size=(D, C)) * 0.3).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    return w, b


def test_fold_decoration_matches_jax(rng):
    w, b = _pfn_weights(rng, CFG)
    je, jd = jfused.fold_decoration(jnp.asarray(w), jnp.asarray(b), CFG)
    te, td = tfused.fold_decoration(torch.from_numpy(w), torch.from_numpy(b),
                                    TCFG)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("case", ["random", "one_cell"])
def test_fused_pfn_matches_jax(rng, case):
    pts, ns = CASES[case](rng)
    w, b = _pfn_weights(rng, CFG)
    # one shared emit table (the JAX one, cut to the port's layout) feeds
    # the JAX kernel, its XLA twin and the port
    jt, jm = jfused.emit_centered_table(jnp.asarray(pts), jnp.asarray(ns),
                                        CFG, interpret=True)
    we, wd = jfused.fold_decoration(jnp.asarray(w), jnp.asarray(b), CFG)
    want_k, pid_k, cnt_k = jfused.pfn_from_table(jt, jm, we, wd, CFG,
                                                 interpret=True)
    want_x, _, _ = jfused.pfn_from_table_xla(jt, jm, we, wd, CFG)
    B, P = len(ns), TCFG.max_pillars
    NF = TCFG.max_points_per_pillar * 4
    table = np.asarray(jt).reshape(B, -1, jt.shape[-1])[:, :P, :NF]
    meta = np.asarray(jm).reshape(B, 8, -1)[:, :, :P]
    got, pid, cnt = tfused.pfn_from_table(
        torch.from_numpy(np.ascontiguousarray(table.reshape(B * P, NF))),
        torch.from_numpy(np.ascontiguousarray(meta.reshape(B * 8, P))),
        torch.from_numpy(np.array(we)), torch.from_numpy(np.array(wd)),
        TCFG)
    for want in (want_k, want_x):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :P],
                                   atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(pid_k)[:, :P])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_k)[:, :P])


def test_pillarize_pfn_fused_matches_jax(rng):
    pts, ns = _cloud(rng, [3000, 4096, 1, 0])
    w, b = _pfn_weights(rng, CFG)
    jf, jp, jmask = jfused.pillarize_pfn_fused(
        jnp.asarray(pts), jnp.asarray(ns), jnp.asarray(w), jnp.asarray(b),
        CFG, interpret=True)
    tf, tp, tmask = tfused.pillarize_pfn_fused(
        torch.from_numpy(pts), torch.from_numpy(ns), torch.from_numpy(w),
        torch.from_numpy(b), TCFG)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tp.numpy() * tmask.numpy(),
                                  np.asarray(jp) * np.asarray(jmask))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-4,
                               rtol=1e-4)


def test_scatter_bit_equal(rng):
    pts, ns = _cloud(rng, [3000, 4096, 0])
    batch = tvox.pillarize_batch(torch.from_numpy(pts), torch.from_numpy(ns),
                                 TCFG)
    W = TCFG.grid_w
    pid = (batch.coords[..., 0] * W + batch.coords[..., 1]).to(torch.int32)
    feats = torch.from_numpy(rng.normal(size=(3, TCFG.max_pillars, 32))
                             .astype(np.float32))
    want = scatter_to_bev_ring(jnp.asarray(feats.numpy()),
                               jnp.asarray(pid.numpy()),
                               jnp.asarray(batch.pillar_mask.numpy()), CFG,
                               interpret=True)
    got = tbev.scatter_to_bev(feats, pid, batch.pillar_mask, TCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the canonical spec's scatter agrees too
    spec = tvox.scatter_to_bev(feats, batch.coords, batch.pillar_mask, TCFG)
    np.testing.assert_array_equal(got.numpy(), spec.numpy())
