#!/usr/bin/env python3
"""Per-launch times of K4 (NMS overlap matrix) and K5 (target assigner) on
one NVIDIA card, at the main path's inputs: how far they swing within a
process, and whether the swing follows the card's clocks.

    python3 scripts/probe_torch_nms_overlap.py [--root DIR] [--label A]
        [--launches 300]

``--root`` is the checkout whose ``tpu_pillars_torch`` is timed (default:
this one), so one call can time two trees with the same probe, each in
processes of its own (for example A B B A, A the parent commit unpacked
with ``git archive``). Inputs, as ``chip_smoke.py`` makes them: K4 on the
class-blocked top-1,024 candidates that ``Detector.predict_packed_batch``
(the committed trained checkpoint) passes to the overlap matrix on the
serving batch (8 lidar-like sweeps of 100,000 points, seed 0), and the
same boxes moved so that no pair passes its circumradius gate ("far") or
every pair does ("piled"); K5 on the class-grouped GT of the first batch-8
training batch (seed 0).

For each kernel it makes ``--launches`` calls of its wrapper twice: under
``torch.profiler``, for the device time of each launch of the kernel
alone, and with CUDA events around each call, behind a head start
(``torch.cuda._sleep``) so that the card is never idle for want of work
enqueued before the call (the wrapper as ``chip_smoke.py`` times it,
including its own small launches and their enqueueing by the host). It
prints min / median / max in ms, and
``nvidia-smi``'s SM clock, power draw and temperature before, during (every
50 ms; min / median / max) and after each series. The kernel's result is
checked against its plain version first. Prints the card (name and power
limit), the compiler's register, shared-memory and spill report of both
sources (``-Xptxas -v``) and, last, one JSON line. Needs a card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

SMI_FIELDS = "clocks.sm,power.draw,temperature.gpu"


def ptxas_report(names, build_dir):
    """Registers, shared memory and spills of the named kernels' sources,
    built with their own flags and ``-Xptxas -v``."""
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
                             timeout=300)
        out[name] = [ln.strip() for ln in (res.stdout + res.stderr)
                     .splitlines() if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]
    return out


def smi_once():
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return [float(x) for x in out.stdout.strip().splitlines()[0].split(",")]


class SmiDuring:
    """``nvidia-smi`` sampling every 50 ms while the block runs; the
    process is stopped on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.strip().splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                pass
        self.rows = rows


def stats(xs):
    import numpy as np

    xs = np.asarray(xs, np.float64)
    return {"min": float(xs.min()), "median": float(np.median(xs)),
            "max": float(xs.max()), "n": int(xs.size)}


def per_launch(fn, n):
    """ms of each of ``n`` calls of ``fn``, CUDA events around each, after a
    warm-up and behind a head start of ~0.1 s of sleep on the stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def kernel_per_launch(fn, n, kernel):
    """Device ms of each launch of the kernel whose name holds ``kernel``
    over ``n`` calls of ``fn`` (``torch.profiler``, after a warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(times) != n:
        sys.exit(f"the profiler saw {len(times)} launches of {kernel}, "
                 f"not {n}")
    return times


def series(name, timer):
    before_smi = smi_once()
    with SmiDuring() as during:
        times = timer()
    after_smi = smi_once()
    out = {"ms": stats(times), "smi_before": before_smi,
           "smi_after": after_smi}
    if during.rows:
        cols = list(zip(*during.rows))
        out["smi_during"] = {f: stats(c) for f, c in
                             zip(SMI_FIELDS.split(","), cols)}
    ms = out["ms"]
    sm = out.get("smi_during", {}).get("clocks.sm")
    print(f"{name}: min {ms['min']:.4f} / median {ms['median']:.4f} / max "
          f"{ms['max']:.4f} ms over {ms['n']} launches; SM clock before "
          f"{before_smi[0]:.0f}, during "
          + (f"{sm['min']:.0f}-{sm['max']:.0f} (median {sm['median']:.0f})"
             if sm else "not read")
          + f", after {after_smi[0]:.0f} MHz; power {before_smi[1]:.1f} -> "
          f"{after_smi[1]:.1f} W; {before_smi[2]:.0f} -> {after_smi[2]:.0f} C",
          flush=True)
    return out


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=here,
                   help="checkout whose tpu_pillars_torch is timed")
    p.add_argument("--label", default="",
                   help="a name for this tree in the output")
    p.add_argument("--launches", type=int, default=300)
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_torch_nms_overlap: needs a CUDA card")
    import chip_smoke as cs
    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops import assign, nms_overlap
    from tpu_pillars_torch.train.loop import synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"tree: {args.label or root} ({root})")
    _build.build_all()
    res_ptxas = ptxas_report(("nms_overlap", "assign"), str(_build.BUILD_DIR))
    for name, lines in res_ptxas.items():
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    cfg = PillarsConfig()
    dev = torch.device("cuda")
    res = {"label": args.label, "root": root, "card": card,
           "pid": os.getpid(), "ptxas": res_ptxas}

    # K4's inputs: the candidates the serving batch passes to the matrix
    det = Detector.from_checkpoint(cfg, os.path.join(root, "artifacts",
                                                     "pointpillars_synth4k"
                                                     ".msgpack"))
    clouds = cs.lidar_batch(np.random.default_rng(cs.SEED), cfg, cs.BATCH,
                            cs.POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = torch.from_numpy(np.stack([q for q, _ in padded])).to(dev)
    counts = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)
    seen = []
    launch_overlap = nms_overlap.overlap_matrix

    def recording(boxes, thr):
        seen.append((boxes.clone(), thr))
        return launch_overlap(boxes, thr)

    nms_overlap.overlap_matrix = recording
    try:
        det.predict_packed_batch(points, counts)
    finally:
        nms_overlap.overlap_matrix = launch_overlap
    torch.cuda.synchronize()
    if len(seen) != 1:
        sys.exit(f"the batch call ran the overlap matrix {len(seen)} times")
    del det, points, counts
    boxes, thr = seen[0]
    B, K, _ = boxes.shape
    got = nms_overlap.overlap_matrix(boxes, thr)
    want = nms_overlap.overlap_matrix_plain(boxes, thr)
    torch.cuda.synchronize()
    flips = int((got != want).sum())
    print(f"K4: B {B}, K {K}, {flips} pairs differ from the plain version")
    res["flips"] = flips
    call4 = functools.partial(nms_overlap.overlap_matrix, boxes, thr)
    res["k4_kernel"] = series("K4 kernel", lambda: kernel_per_launch(
        call4, args.launches, "nms_overlap_kernel"))
    res["k4_wrapper"] = series("K4 wrapper", lambda: per_launch(
        call4, args.launches))
    # what bounds K4: the same shapes with no pair passing the gate (boxes
    # 20 m apart) and with every pair passing it (all centres at 0)
    grid = torch.arange(K, device=dev)
    far, piled = boxes.clone(), boxes.clone()
    far[..., 0], far[..., 1] = 20.0 * (grid % 64), 20.0 * (grid // 64)
    piled[..., 0:2] = 0.0
    for name, bx in (("far", far), ("piled", piled)):
        res[f"k4_kernel_{name}"] = series(
            f"K4 kernel, {name}", lambda: kernel_per_launch(functools.partial(
                nms_overlap.overlap_matrix, bx, thr), 100,
                "nms_overlap_kernel"))

    # K5's inputs: the first training batch's GT, grouped by class
    tcfg = TrainConfig(batch_size=cs.BATCH)
    gt = next(synthetic_batches(cfg, tcfg, seed=cs.SEED))[2:]
    gt_c, gv_c = cs._grouped(cfg, dev, gt)
    best, _, _, _ = assign.windowed_best_iou(gt_c, gv_c, cfg)
    wbest, _, _, _ = assign.windowed_best_iou_plain(gt_c, gv_c, cfg)
    torch.cuda.synchronize()
    err = float((best - wbest).abs().max())
    print(f"K5: max |d best IoU| {err:.2e} against the plain version")
    if err > cs.K5_IOU_TOL:
        sys.exit("K5 differs from its plain version")
    call5 = functools.partial(assign.windowed_best_iou, gt_c, gv_c, cfg)
    res["k5_kernel"] = series("K5 kernel", lambda: kernel_per_launch(
        call5, args.launches, "assign_kernel"))
    res["k5_wrapper"] = series("K5 wrapper", lambda: per_launch(
        call5, args.launches))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
