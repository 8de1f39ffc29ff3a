"""Sorted pillar-id streams that pin K1's run structure (each pillar's
points are one contiguous run of the sorted stream; only a sample's first P
runs and each run's first N points are kept), one sample per case, drawn
with numpy from a seed. Shared by the CPU tests of the plain run rule and
the card test of the kernel; imports neither JAX nor torch."""

import numpy as np

CASES = ("more_than_p", "exactly_p", "chunk_edges", "long_run", "empty",
         "last_cell_full")


def run_batch(cfg, f=4, seed=0, chunk=1024):
    """(len(CASES), M) int32 ascending ids (H*W sentinel), (len(CASES), M,
    f) float32 points, and per sample its runs' (cells, lengths) in order:

    * more_than_p: P + 300 runs; exactly_p: P runs (1-3 points each);
    * chunk_edges: runs whose edges fall just before, on and just after the
      ``chunk``-id boundaries: one straddles the first boundary, one ends
      on the second, one fills the third chunk exactly;
    * long_run: a run of 2.5 chunks (far longer than N) between short runs,
      and runs of exactly N and N + 1 points;
    * empty: no run;
    * last_cell_full: every one of the M ids valid (no sentinel), the last
      run at cell H*W - 1.
    M (``cfg.max_points``) must hold at least 4 chunks."""
    rng = np.random.default_rng(seed)
    HW = cfg.grid_h * cfg.grid_w
    P, N, M = cfg.max_pillars, cfg.max_points_per_pillar, cfg.max_points
    assert M >= 4 * chunk
    gid = np.full((len(CASES), M), HW, np.int32)
    runs = []
    for s, case in enumerate(CASES):
        if case in ("more_than_p", "exactly_p"):
            n = P + 300 if case == "more_than_p" else P
            lens = rng.integers(1, 4, n)
        elif case == "chunk_edges":
            lens = np.array([chunk - 24, 50, chunk - 26, chunk, 20, 900])
        elif case == "long_run":
            lens = np.array([3, chunk * 5 // 2, 5, N, N + 1, 2])
        elif case == "empty":
            lens = np.zeros(0, np.int64)
        else:
            lens = rng.integers(1, 4, M)
            lens = lens[:np.searchsorted(np.cumsum(lens), M)]
            lens = np.append(lens, M - lens.sum())
        cells = np.sort(rng.choice(HW - 1, len(lens), replace=False))
        if case == "last_cell_full":
            cells[-1] = HW - 1
        rows = np.repeat(cells, lens)
        assert len(rows) <= M, case
        assert case != "last_cell_full" or len(rows) == M
        gid[s, :len(rows)] = rows
        runs.append((cells, np.asarray(lens)))
    pts = rng.standard_normal((len(CASES), M, f)).astype(np.float32)
    return gid, pts, runs
