"""Sorted pillar-id streams that pin K11's pillar budget (only a sample's
first P runs are kept), one sample per case, drawn with numpy from a seed.
Shared by the CPU test of the plain budget rule and the card test of the
kernel; imports neither JAX nor torch."""

import numpy as np

CASES = ("fewer", "exactly", "cut_in_tile", "empty", "last_cell",
         "long_runs")


def budget_batch(cfg, seed=0):
    """(len(CASES), M) int32 ascending ids (H*W sentinel) and, per sample,
    its run cells in order:

    * fewer: P // 2 runs; exactly: P runs;
    * cut_in_tile: P + 200 runs on consecutive cells from cell 10, so the
      P-th run (cell P + 9) lies inside a 64-cell tile and the runs past
      the budget continue in the same tile;
    * empty: no run; last_cell: 100 runs and one at cell H*W - 1;
    * long_runs: 40 runs, alternately of exactly N and N + 13 points.
    Other runs hold 1-3 points."""
    rng = np.random.default_rng(seed)
    HW = cfg.grid_h * cfg.grid_w
    P, N, M = cfg.max_pillars, cfg.max_points_per_pillar, cfg.max_points
    gid = np.full((len(CASES), M), HW, np.int32)
    runs = []
    for s, case in enumerate(CASES):
        if case == "fewer":
            cells = rng.choice(HW, P // 2, replace=False)
        elif case == "exactly":
            cells = rng.choice(HW, P, replace=False)
        elif case == "cut_in_tile":
            cells = np.arange(10, 10 + P + 200)
        elif case == "empty":
            cells = np.zeros(0, np.int64)
        elif case == "last_cell":
            cells = np.append(rng.choice(HW - 1, 100, replace=False), HW - 1)
        else:
            cells = rng.choice(HW, 40, replace=False)
        cells = np.sort(cells)
        if case == "long_runs":
            lens = np.where(np.arange(len(cells)) % 2 == 0, N, N + 13)
        else:
            lens = rng.integers(1, 4, len(cells))
        rows = np.repeat(cells, lens)
        assert len(rows) <= M, case
        gid[s, :len(rows)] = rows
        runs.append(cells)
    return gid, runs


def expected_cutoff(cells, cfg):
    """The id of the P-th run, or H*W - 1 with fewer runs."""
    P = cfg.max_pillars
    return int(cells[P - 1]) if len(cells) >= P else cfg.grid_h * \
        cfg.grid_w - 1


def budget_inputs(cfg, shape, seed=1, f=4):
    """Cell-centred points (B, M, f) and folded weights w_eff (f, C), w_dec
    (8, C) whose bias row keeps every kept cell's features positive, so a
    cell is occupied exactly when its run is kept."""
    rng = np.random.default_rng(seed)
    C = cfg.pfn_channels
    pts = (rng.standard_normal(shape + (f,)) * 0.1).astype(np.float32)
    w_eff = (rng.standard_normal((f, C)) * 0.3).astype(np.float32)
    w_dec = (rng.standard_normal((8, C)) * 0.1).astype(np.float32)
    w_dec[5] = 5.0
    return pts, w_eff, w_dec
