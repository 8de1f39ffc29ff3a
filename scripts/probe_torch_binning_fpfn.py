#!/usr/bin/env python3
"""K8 (binning) and K2 (fused PFN) on one NVIDIA card, at the main paths'
shapes: each kernel's device time by name, which ``chip_smoke.py`` does not
show.

    python3 scripts/probe_torch_binning_fpfn.py [--root DIR] [--label A]
        [--skip-ptxas] [--k2-counts] [--host-split]

``--root`` is the checkout whose ``tpu_pillars_torch`` is timed (default:
this one), so one call can time two trees with the same probe, each in
processes of its own (for example A B B A B B, A the parent commit unpacked
with ``git archive``). Inputs, as ``chip_smoke.py`` makes them: 8
lidar-like sweeps of 100,000 points (seed 0) at ``PillarsConfig()``.

* K8 on the batch's cells (the classic drop-in's input: rows and cols of
  (8, 131,072) points), checked bit for bit against its plain version, and
  again with every point invalid, beside ``zero_()`` of its histogram (the
  card's write rate, for scale);
* K2 on the fused path's table and meta of the same batch with the
  committed checkpoint's folded PFN, checked against its plain version
  (atol / rtol 1e-5, ids and counts equal), and again with every pillar
  empty (count 0: zeros only).

For each: the device time per call of every kernel it launches
(``torch.profiler``, mean of 20 calls after a warm-up; a memset or a torch
op in the wrapper shows as a kernel of its own), their sum, and the
wrapper's time as ``chip_smoke.py`` takes it (CUDA events around 20
back-to-back calls, median of 5) and, for K8 and K2 on the batch, the
host's time per call (the wall clock of 200 calls not waited for). Prints
the card (``nvidia-smi`` name and
power limit), the compiler's register, shared-memory and spill report of
``csrc/binning.cu`` and ``csrc/fused_pfn.cu`` with their own flags
(``-Xptxas -v``; ``--skip-ptxas`` leaves it out) and, last, one JSON line.
``--k2-counts`` also times K2 with the batch's counts capped at 2, 4, 8
and 16, with its pillars shuffled within each sample, and with every
count 1, 2, 3 or 4 (how K2's time follows its rows and their layout);
``--host-split`` times, on the host, K2's wrapper and its parts (the
``torch.empty`` calls, the device guard, the current stream, the C call).
Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from probe_torch_emit_pfn import ptxas_report, report

KERNELS = ("binning", "fused_pfn")


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=here,
                   help="checkout whose tpu_pillars_torch is timed")
    p.add_argument("--label", default="",
                   help="a name for this tree in the output")
    p.add_argument("--skip-ptxas", action="store_true",
                   help="leave out the compiler's report")
    p.add_argument("--k2-counts", action="store_true",
                   help="time K2 on capped, shuffled and uniform counts")
    p.add_argument("--host-split", action="store_true",
                   help="time K2's wrapper on the host, part by part")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_torch_binning_fpfn: needs a CUDA card")
    import chip_smoke as cs
    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops import binning, emit, fused_pfn, voxelize

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"tree: {args.label or root} ({root})")
    _build.build_all()
    res = {"label": args.label, "root": root, "card": card,
           "pid": os.getpid()}
    if not args.skip_ptxas:
        res["ptxas"] = ptxas_report(str(_build.BUILD_DIR), KERNELS)
        for name, lines in res["ptxas"].items():
            for ln in lines:
                print(f"ptxas {name}: {ln}")

    cfg = PillarsConfig()
    dev = torch.device("cuda")
    det = Detector.from_checkpoint(cfg, os.path.join(
        root, "artifacts", "pointpillars_synth4k.msgpack"))
    clouds = cs.lidar_batch(np.random.default_rng(cs.SEED), cfg, cs.BATCH,
                            cs.POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = torch.from_numpy(np.stack([q for q, _ in padded])).to(dev)
    counts = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)
    B = points.shape[0]
    P, N, H = cfg.max_pillars, cfg.max_points_per_pillar, cfg.grid_h

    # K8 on the drop-in's cells, and with every point invalid
    w_pad = binning.padded_width(cfg)
    rows, cols = binning.cell_rows_cols(points, counts, cfg)
    args8 = (rows, cols, H, w_pad)
    none8 = (torch.full_like(rows, H), cols, H, w_pad)
    rank, hist = binning.rank_and_hist(*args8)
    want = binning.rank_and_hist_plain(*args8)
    z_rank, z_hist = binning.rank_and_hist(*none8)
    ok = (torch.equal(rank, want[0]) and torch.equal(hist, want[1])
          and not z_rank.any() and not z_hist.any())
    print(f"K8: {int((rows < H).sum())} valid points, "
          f"{int((hist > 0).sum())} occupied cells, "
          f"{int((hist == 64).sum())} of 64 points or more; bit-equal to "
          f"its plain version, zeros with every point invalid: {ok}")
    if not ok:
        sys.exit(1)
    res["k8_big_cells"] = int((hist == 64).sum())
    del want, z_rank, z_hist
    report(res, "K8", lambda: binning.rank_and_hist(*args8),
           cs.cuda_ms(lambda: binning.rank_and_hist(*args8), 20), host=True)
    report(res, "K8 all invalid", lambda: binning.rank_and_hist(*none8),
           cs.cuda_ms(lambda: binning.rank_and_hist(*none8), 20))
    fill = torch.empty_like(hist)
    report(res, "zero_ of K8's histogram", fill.zero_, None)
    del rank, hist, fill

    # K2 on the fused path's table and meta, and with every pillar empty
    gid, pts = voxelize.sort_points_by_pillar(points, counts, cfg)
    pts = fused_pfn.center_points(gid, pts, cfg)
    table, meta = emit.emit_table(gid, pts, N, P, cfg.grid_h * cfg.grid_w)
    w_pfn, b_pfn = det.model.pfn.folded()
    w_eff, w_dec = fused_pfn.fold_decoration(w_pfn, b_pfn, cfg)
    args2 = (table, meta, w_eff, w_dec, cfg)
    meta0 = meta.clone()
    meta0.view(B, 8, P)[:, 0] = 0.0
    none2 = (table, meta0, w_eff, w_dec, cfg)
    got = fused_pfn.pfn_from_table(*args2)
    want = fused_pfn.pfn_from_table_plain(*args2)
    err = float((got[0] - want[0]).abs().max())
    kept = int(meta.view(B, 8, P)[:, 0].sum())
    ok = (torch.allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
          and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
          and not fused_pfn.pfn_from_table(*none2)[0].any())
    print(f"K2: {kept} kept points in {B * P} pillars, max |d| {err:.3e} "
          f"against its plain version (bit-equal: "
          f"{torch.equal(got[0], want[0])}), zeros with every pillar "
          f"empty: {ok}")
    if not ok:
        sys.exit(1)
    res["k2_kept_points"] = kept
    res["k2_max_abs_err"] = err
    del got, want
    report(res, "K2", lambda: fused_pfn.pfn_from_table(*args2),
           cs.cuda_ms(lambda: fused_pfn.pfn_from_table(*args2), 20),
           host=True)
    report(res, "K2 all empty", lambda: fused_pfn.pfn_from_table(*none2),
           cs.cuda_ms(lambda: fused_pfn.pfn_from_table(*none2), 20))
    if args.k2_counts:
        k2_counts(res, report, fused_pfn, args2)
    if args.host_split:
        host_split(res, _build, fused_pfn, args2)
    print(json.dumps(res))


def k2_counts(res, report, fused_pfn, args2):
    """K2 on the batch's table with its counts capped, its pillars shuffled
    within each sample (the same rows, dense pillars spread out), and every
    count set to 1..4 (a regular layout)."""
    import torch

    table, meta, w_eff, w_dec, cfg = args2
    B, P = meta.shape[0] // 8, meta.shape[1]
    variants = {}
    for cap in (2, 4, 8, 16):
        m = meta.clone()
        m.view(B, 8, P)[:, 0].clamp_(max=float(cap))
        variants[f"capped at {cap}"] = (table, m)
    gen = torch.Generator(table.device).manual_seed(0)
    perm = torch.stack([torch.randperm(P, device=table.device, generator=gen)
                        for _ in range(B)])
    m = meta.view(B, 8, P).gather(2, perm[:, None, :].expand(B, 8, P))
    t = table.view(B, P, -1).gather(
        1, perm[:, :, None].expand(B, P, table.shape[1]))
    variants["shuffled"] = (t.reshape(table.shape).contiguous(),
                            m.reshape(meta.shape).contiguous())
    for k in (1, 2, 3, 4):
        m = meta.clone()
        c = m.view(B, 8, P)[:, 0]
        c.copy_(torch.where(c > 0, torch.full_like(c, float(k)), c))
        variants[f"every count {k}"] = (table, m)
    for name, (t, m) in variants.items():
        rows = int(m.view(B, 8, P)[:, 0].clamp(max=cfg.max_points_per_pillar)
                   .sum())
        res[f"K2 {name} rows"] = rows
        report(res, f"K2 {name} ({rows} rows)",
               lambda t=t, m=m: fused_pfn.pfn_from_table(t, m, w_eff, w_dec,
                                                         cfg), None)


def host_split(res, _build, fused_pfn, args2):
    """Host time per call (200 calls not waited for) of K2's wrapper and of
    its parts, in microseconds."""
    import torch

    from probe_torch_emit_pfn import host_ms

    table, meta, w_eff, w_dec, cfg = args2
    B, P = meta.shape[0] // 8, meta.shape[1]
    dev = table.device
    outs = (torch.empty((B, P, 64), device=dev),
            torch.empty((B, P), dtype=torch.int32, device=dev),
            torch.empty((B, P), device=dev))
    ptrs = [t.data_ptr() for t in (table, meta, w_eff, w_dec) + outs]
    ints = [B * P, P, cfg.max_points_per_pillar, 4, 64, cfg.grid_w,
            cfg.x_min, cfg.y_min, cfg.voxel_x, cfg.voxel_y]
    fn = _build.function("fused_pfn", "fused_pfn", "pppppppiiiiiiffff")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def guard():
        with torch.cuda.device(dev):
            pass

    parts = {
        "wrapper": lambda: fused_pfn.pfn_from_table(*args2),
        "three torch.empty": lambda: (
            torch.empty((B, P, 64), device=dev),
            torch.empty((B, P), dtype=torch.int32, device=dev),
            torch.empty((B, P), device=dev)),
        "torch.cuda.device enter and exit": guard,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "the C call (one kernel launch)": lambda: fn(*ptrs, *ints, stream),
        "_build.launch": lambda: _build.launch(
            "fused_pfn", "fused_pfn", "pppppppiiiiiiffff", table, meta,
            w_eff, w_dec, *outs, *ints),
    }
    for name, f in parts.items():
        us = host_ms(f) * 1e3
        res[f"host us {name}"] = us
        print(f"host: {name} {us:.2f} us", flush=True)


if __name__ == "__main__":
    main()
