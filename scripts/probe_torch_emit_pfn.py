#!/usr/bin/env python3
"""K1 (emit) and K6 (classic PFN) on one NVIDIA card, at the serving
batch's shapes: each kernel's device time by name, which ``chip_smoke.py``
does not show.

    python3 scripts/probe_torch_emit_pfn.py [--root DIR] [--label A]
        [--skip-ptxas]

``--root`` is the checkout whose ``tpu_pillars_torch`` is timed (default:
this one), so one call can time two trees with the same probe, each in
processes of its own (for example A B B A B B, A the parent commit unpacked
with ``git archive``). Inputs, as ``chip_smoke.py`` makes them: 8
lidar-like sweeps of 100,000 points (seed 0) at ``PillarsConfig()``.

* K1 on the batch sorted and centred (the fused path's input), checked bit
  for bit against its plain version, and again with every sample empty
  (all ids the sentinel: zeros only), beside ``zero_()`` of a table of the
  same size (the card's write rate, for scale);
* K6 on the classic ``PillarBatch`` of the same batch with the committed
  checkpoint's folded PFN, checked against its plain version (atol / rtol
  1e-5), and again with every pillar masked.

For each: the device time per call of every kernel it launches
(``torch.profiler``, mean of 20 calls after a warm-up; a wrapper that fills
its outputs with ``torch.zeros`` shows the fill as a kernel of its own), their
sum, and the wrapper's time as ``chip_smoke.py`` takes it (CUDA events
around 20 back-to-back calls, median of 5). Prints the card (``nvidia-smi``
name and power limit), the compiler's register, shared-memory and spill
report of ``csrc/emit.cu`` and ``csrc/pfn.cu`` with their own flags
(``-Xptxas -v``; ``--skip-ptxas`` leaves it out) and, last, one JSON line.
Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNELS = ("emit", "pfn")


def ptxas_report(build_dir, names=KERNELS):
    """Registers, shared memory and spills of the sources ``names`` (K1's
    and K6's by default), each with its own flags."""
    from tpu_pillars_torch import _build

    out = {}
    os.makedirs(build_dir, exist_ok=True)
    for name in names:
        cmd = ([_build._nvcc()] + _build.NVCC_FLAGS
               + _build.EXTRA_FLAGS.get(name, []) + [
                   "-Xptxas", "-v", "-o",
                   os.path.join(build_dir, f"probe_{name}.so"),
                   str(_build.SRC_DIR / f"{name}.cu")])
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        out[name] = [ln.strip() for ln in (res.stdout + res.stderr)
                     .splitlines() if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]
    return out


def device_ms(fn, n=20):
    """Device time per call of each kernel that ``fn`` launches, in ms
    (``torch.profiler``, CUDA activity, ``n`` calls after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", 0) or 0
        if total > 0:
            out[ev.key[:70]] = total / n / 1e3
    return out


def host_ms(fn, n=200):
    """Host time per call of ``fn`` in ms: the wall clock of ``n`` calls
    that are not waited for (the enqueue alone), after a warm-up."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def report(res, what, fn, wrapper_ms, host=False):
    per = device_ms(fn)
    row = {"kernels": per, "sum": sum(per.values()), "wrapper_ms": wrapper_ms}
    if host:
        row["host_ms"] = host_ms(fn)
    res[what] = row
    print(f"{what}: device " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         per.items())
          + f" ms; sum {row['sum']:.4f} ms"
          + (f"; wrapper {wrapper_ms:.4f} ms" if wrapper_ms else "")
          + (f"; host {row['host_ms']:.4f} ms" if host else ""),
          flush=True)


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=here,
                   help="checkout whose tpu_pillars_torch is timed")
    p.add_argument("--label", default="",
                   help="a name for this tree in the output")
    p.add_argument("--skip-ptxas", action="store_true",
                   help="leave out the compiler's report")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_torch_emit_pfn: needs a CUDA card")
    import chip_smoke as cs
    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops import emit, fused_pfn, pfn, voxelize

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
        res["ptxas"] = ptxas_report(str(_build.BUILD_DIR))
        for name, lines in res["ptxas"].items():
            for ln in lines:
                print(f"ptxas {name}: {ln}")

    cfg = PillarsConfig()
    dev = torch.device("cuda")
    det = Detector.from_checkpoint(cfg, os.path.join(
        root, "artifacts", "pointpillars_synth4k.msgpack"),
        fused_frontend=False)
    clouds = cs.lidar_batch(np.random.default_rng(cs.SEED), cfg, cs.BATCH,
                            cs.POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = torch.from_numpy(np.stack([q for q, _ in padded])).to(dev)
    counts = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)
    B = points.shape[0]
    P, N = cfg.max_pillars, cfg.max_points_per_pillar
    HW = cfg.grid_h * cfg.grid_w

    # K1 on the fused path's input, and with every sample empty
    gid, pts = voxelize.sort_points_by_pillar(points, counts, cfg)
    pts = fused_pfn.center_points(gid, pts, cfg)
    args1 = (gid, pts, N, P, HW)
    empty1 = (torch.full_like(gid, HW), pts, N, P, HW)
    table, meta = emit.emit_table(*args1)
    want = emit.emit_table_plain(*args1)
    z_t, z_m = emit.emit_table(*empty1)
    ok = (torch.equal(table, want[0]) and torch.equal(meta, want[1])
          and not z_t.any() and not z_m.any())
    print(f"K1: bit-equal to its plain version, zeros with every sample "
          f"empty: {ok}")
    if not ok:
        sys.exit(1)
    res["k1_table_bytes"] = table.numel() * 4
    res["k1_meta_bytes"] = meta.numel() * 4
    del want, z_t, z_m
    report(res, "K1", lambda: emit.emit_table(*args1),
           cs.cuda_ms(lambda: emit.emit_table(*args1), 20))
    report(res, "K1 all empty", lambda: emit.emit_table(*empty1),
           cs.cuda_ms(lambda: emit.emit_table(*empty1), 20))
    fill = torch.empty_like(table)
    report(res, "zero_ of K1's table", fill.zero_, None)
    del table, meta, fill

    # K6 on the classic batch, and with every pillar masked
    w_pfn, b_pfn = det.model.pfn.folded()
    pb = emit.pillarize_batch_emit(points, counts, cfg)
    D = pb.features.shape[-1]
    args6 = (pb.features.reshape(B * P, N, D), pb.mask.reshape(B * P, N),
             w_pfn, b_pfn)
    none6 = (args6[0], torch.zeros_like(args6[1]), w_pfn, b_pfn)
    got = pfn.pfn_fused(*args6)
    err = float((got - pfn.pfn_fused_plain(*args6)).abs().max())
    slots = int(args6[1].sum())
    ok = (torch.allclose(got, pfn.pfn_fused_plain(*args6), atol=1e-5,
                         rtol=1e-5) and not pfn.pfn_fused(*none6).any())
    print(f"K6: {slots} valid slots of {B * P * N}, max |d| {err:.3e} "
          f"against its plain version, zeros with every pillar masked: {ok}")
    if not ok:
        sys.exit(1)
    res["k6_valid_slots"] = slots
    res["k6_max_abs_err"] = err
    report(res, "K6", lambda: pfn.pfn_fused(*args6),
           cs.cuda_ms(lambda: pfn.pfn_fused(*args6), 20))
    report(res, "K6 all masked", lambda: pfn.pfn_fused(*none6),
           cs.cuda_ms(lambda: pfn.pfn_fused(*none6), 20))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
