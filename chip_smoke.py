#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda`` or ``CUDA_HOME``), and
imports nothing of JAX. Phases; any failure exits non-zero before the last
line:

  1. Print the card (``nvidia-smi`` name and power limit) and build the four
     CUDA kernels of ``tpu_pillars_torch/csrc`` from source.
  2. On a batch of 8 lidar-like sweeps of ~100k points at the full
     ``PillarsConfig()``, run each kernel and its plain PyTorch version on
     the card on the same inputs: K1 emit and K3 scatter must be bit-equal,
     K2 fused PFN within atol 1e-5 / rtol 1e-5, K4 NMS overlap equal except
     pairs whose IoU lies within 1e-4 of the threshold. Times each (CUDA
     events, median), with its bound and, where one PyTorch call computes
     the same function, that call's time.
  3. The main path: ``Detector.from_checkpoint`` on the committed trained
     checkpoint; ``predict`` on the 8 golden scenes of
     ``tests/data/torch_golden_synth4k.npz`` (written by
     ``scripts/make_torch_golden.py`` from the JAX package) must reproduce
     the JAX detections; ``predict_packed_batch`` at batch 8 is timed by
     stage. Every kernel must have launched during these calls.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "artifacts", "pointpillars_synth4k.msgpack")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth4k.npz")

BATCH = 8
POINTS_PER_SWEEP = 100_000
SEED = 0
NMS_BOUNDARY_TOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K4 operations per candidate pair, counted from csrc/nms_overlap.cu (each
# arithmetic op, comparison and select counts one): the circumradius gate,
# and the recentring + two half-edge integrals + IoU of a pair that passes it
K4_OPS_GATE = 8
K4_OPS_HOT = 1500


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def lidar_batch(rng, cfg, n_sweeps, n_points):
    """Lidar-like sweeps: ground returns whose density falls with range, plus
    box-shaped objects. (B, n, 4) f32 [x, y, z, intensity]."""
    import numpy as np

    out = np.zeros((n_sweeps, n_points, 4), np.float32)
    for b in range(n_sweeps):
        n_obj_pts = n_points // 4
        n_ground = n_points - n_obj_pts
        r = np.exp(rng.uniform(np.log(2.0), np.log(80.0), n_ground))
        th = rng.uniform(-np.pi, np.pi, n_ground)
        ground = np.stack([r * np.cos(th), r * np.sin(th),
                           rng.normal(-1.7, 0.05, n_ground)], axis=1)
        n_obj = 50
        ctr = rng.uniform(-60.0, 60.0, (n_obj, 2))
        size = rng.uniform([1.5, 3.5, 1.4], [2.5, 6.0, 2.0], (n_obj, 3))
        which = rng.integers(0, n_obj, n_obj_pts)
        local = rng.uniform(-0.5, 0.5, (n_obj_pts, 3)) * size[which]
        obj = np.stack([ctr[which, 0] + local[:, 0],
                        ctr[which, 1] + local[:, 1],
                        -1.0 + local[:, 2]], axis=1)
        xyz = np.concatenate([ground, obj])
        out[b, :, :3] = xyz
        out[b, :, 3] = rng.uniform(0.0, 1.0, n_points)
    return out


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    """Median per-call time of ``fn`` in ms, CUDA events around ``iters``
    calls, after one warm-up call."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "tpu_pillars_torch")):
        fail(f"no tpu_pillars_torch package beside {__file__}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, ROOT)

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector, packed_to_boxes
    from tpu_pillars_torch.ops import bev, emit, fused_pfn, nms_overlap
    from tpu_pillars_torch.ops.voxelize import sort_points_by_pillar

    # ---- phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")

    cfg = PillarsConfig()
    dev = torch.device("cuda")
    det = Detector.from_checkpoint(cfg, CKPT)
    rng = np.random.default_rng(SEED)
    clouds = lidar_batch(rng, cfg, BATCH, POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = torch.from_numpy(np.stack([p for p, _ in padded])).to(dev)
    counts = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)

    # K4's inputs are the class-blocked candidates of the main path: record
    # them from one batch call
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

    # ---- phase 2: every kernel against its plain version, on the card
    rows = {}
    P, N, C = cfg.max_pillars, cfg.max_points_per_pillar, cfg.pfn_channels
    F = cfg.num_input_features
    HW = cfg.grid_h * cfg.grid_w

    gid, pts = sort_points_by_pillar(points, counts, cfg)
    pts = fused_pfn.center_points(gid, pts, cfg)
    args1 = (gid, pts, N, P, HW)
    table, meta = emit.emit_table(*args1)
    table_p, meta_p = emit.emit_table_plain(*args1)
    if not (torch.equal(table, table_p) and torch.equal(meta, meta_p)):
        fail("K1 emit differs from its plain version")
    n_valid = int((gid < HW).sum())
    cnt = meta.reshape(BATCH, 8, P)[:, 0]
    kept_pts = float(cnt.sum())
    n_pillars = int((cnt > 0).sum())
    print(f"inputs: {n_valid} valid points, {n_pillars} kept pillars, "
          f"{int(kept_pts)} kept points over {BATCH} sweeps")
    rows["emit"] = dict(
        err=0.0, ms=cuda_ms(lambda: emit.emit_table(*args1), 20),
        plain_ms=cuda_ms(lambda: emit.emit_table_plain(*args1), 3),
        library_ms=None,
        bound=bound(n_valid * (4 + 4 * F) + table.numel() * 4
                    + meta.numel() * 4, 0.0))

    w_eff, w_dec = fused_pfn.fold_decoration(det._pfn_w, det._pfn_b, cfg)
    args2 = (table, meta, w_eff, w_dec, cfg)
    feats, pid, cnt2 = fused_pfn.pfn_from_table(*args2)
    feats_p, pid_p, _ = fused_pfn.pfn_from_table_plain(*args2)
    if not torch.equal(pid, pid_p):
        fail("K2 pillar ids differ from the plain version")
    if not torch.allclose(feats, feats_p, atol=1e-5, rtol=1e-5):
        fail(f"K2 fused PFN differs from its plain version: max |d| "
             f"{(feats - feats_p).abs().max().item():.3e}")
    rows["fused_pfn"] = dict(
        err=(feats - feats_p).abs().max().item(),
        ms=cuda_ms(lambda: fused_pfn.pfn_from_table(*args2), 20),
        plain_ms=cuda_ms(lambda: fused_pfn.pfn_from_table_plain(*args2), 3),
        library_ms=None,
        bound=bound(kept_pts * F * 4 + 5 * BATCH * P * 4 + feats.numel() * 4,
                    kept_pts * C * 2 * F + BATCH * P * C * 14))

    mask = cnt2 > 0.0
    args3 = (feats, pid, mask, cfg)
    canvas = bev.scatter_to_bev(*args3)
    canvas_p = bev.scatter_to_bev_plain(*args3)
    if not torch.equal(canvas, canvas_p):
        fail("K3 BEV scatter differs from its plain version")
    flat_idx = (pid.long() + torch.arange(BATCH, device=dev)[:, None] * HW)[
        mask]
    src = feats[mask]

    def library_scatter():
        return torch.zeros((BATCH * HW, C), device=dev).index_copy_(
            0, flat_idx, src)

    if not torch.equal(library_scatter().reshape(canvas.shape), canvas):
        fail("K3 yardstick index_copy_ differs from the kernel")
    rows["bev_scatter"] = dict(
        err=0.0, ms=cuda_ms(lambda: bev.scatter_to_bev(*args3), 20),
        plain_ms=cuda_ms(lambda: bev.scatter_to_bev_plain(*args3), 5),
        library_ms=cuda_ms(library_scatter, 20),
        bound=bound(n_pillars * C * 4 + BATCH * P * 5 + canvas.numel() * 4,
                    0.0))

    if len(seen) != 1:
        fail(f"the batch call ran the overlap matrix {len(seen)} times")
    boxes, thr = seen[0]
    over = nms_overlap.overlap_matrix(boxes, thr)
    over_p = nms_overlap.overlap_matrix_plain(boxes, thr)
    flips = (over != over_p).nonzero()
    if len(flips):
        b, j, i = flips.unbind(1)
        iou = overlap_iou64(boxes[b, j].cpu().numpy(),
                            boxes[b, i].cpu().numpy())
        worst = float(np.max(np.abs(iou - thr)))
        if worst >= NMS_BOUNDARY_TOL:
            fail(f"K4 overlap: {len(flips)} pairs differ from the plain "
                 f"version, one {worst:.2e} from the threshold")
    pay = nms_overlap.payloads(boxes)
    K = boxes.shape[1]
    d = pay[:, :, None, 8:10] - pay[:, None, :, 8:10]
    rr = pay[:, :, None, 11] + pay[:, None, :, 11]
    upper = torch.ones(K, K, dtype=torch.bool, device=dev).triu(1)
    hot = int((((d * d).sum(-1) - rr * rr <= 0.0) & upper).sum())
    pairs = BATCH * K * (K - 1) // 2
    print(f"K4: {hot} of {pairs} upper-triangle pairs pass the gate, "
          f"{len(flips)} boundary flips, {int(over.sum())} overlaps")
    rows["nms_overlap"] = dict(
        err=float(len(flips)),
        ms=cuda_ms(lambda: nms_overlap.overlap_matrix(boxes, thr), 20),
        plain_ms=cuda_ms(lambda: nms_overlap.overlap_matrix_plain(boxes, thr),
                         3),
        library_ms=None,
        bound=bound(boxes.numel() * 4 + over.numel(),
                    pairs * K4_OPS_GATE + hot * K4_OPS_HOT))
    del canvas_p, over_p, feats_p, table_p, meta_p
    torch.cuda.empty_cache()

    # ---- phase 3: the main path
    golden = np.load(GOLDEN)
    offs = golden["offsets"]
    golden_clouds = [golden["points"][offs[s]:offs[s + 1]]
                     for s in range(len(offs) - 1)]
    _build.reset_launches()
    n_boxes = 0
    for s, cloud in enumerate(golden_clouds):
        got = det.predict(cloud)
        want = packed_to_boxes(golden["packed"][s], cfg)
        check_boxes(got, want, s)
        n_boxes += len(got)
    out = det.predict_packed_batch(points, counts)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"golden: {len(golden_clouds)} scenes, {n_boxes} boxes match the "
          f"JAX detections")
    print(f"launches on the main path: {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} did not launch on the main path")
    out = out.cpu().numpy()
    if out.shape != (BATCH, cfg.max_detections, 10) or \
            not np.isfinite(out).all():
        fail(f"batch output {out.shape} is not finite (B, D, 10)")
    if out[..., 9].sum() == 0:
        fail("the batch call detected nothing")

    stage_split(det, points, counts, clouds)

    sources = {"emit": "emit.cu", "fused_pfn": "fused_pfn.cu",
               "bev_scatter": "bev_scatter.cu",
               "nms_overlap": "nms_overlap.cu"}
    replaces = {"emit": "tpu_pillars/ops/emit_pallas.py:113",
                "fused_pfn": "tpu_pillars/ops/fused_pfn.py:102",
                "bev_scatter": "tpu_pillars/ops/bev_pallas.py:330",
                "nms_overlap": "tpu_pillars/ops/nms_pallas.py:82"}
    kernels = []
    for name, r in rows.items():
        b_ms, b_by = r["bound"]
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {b_ms:.4f} ms ({b_by}), "
              f"{launches[name]} launches on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_pillars_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def overlap_iou64(a, b):
    """Float64 rotated BEV IoU of box pairs a[n], b[n] (polygon clipping),
    the referee for pairs where kernel and plain version disagree."""
    import numpy as np

    def corners(x):
        c, s = math.cos(x[6]), math.sin(x[6])
        lx = np.array([x[4], -x[4], -x[4], x[4]]) / 2
        ly = np.array([x[3], x[3], -x[3], -x[3]]) / 2
        return np.stack([x[0] + c * lx - s * ly, x[1] + s * lx + c * ly], 1)

    def clip(poly, p, q):
        # keep the part of poly left of the directed edge p -> q
        out = []
        side = lambda v: ((q[0] - p[0]) * (v[1] - p[1])  # noqa: E731
                          - (q[1] - p[1]) * (v[0] - p[0]))
        for k in range(len(poly)):
            u, v = poly[k], poly[(k + 1) % len(poly)]
            su, sv = side(u), side(v)
            if su >= 0:
                out.append(u)
            if su * sv < 0:
                out.append(u + (v - u) * (su / (su - sv)))
        return out

    def area(poly):
        if len(poly) < 3:
            return 0.0
        x = np.array([v[0] for v in poly])
        y = np.array([v[1] for v in poly])
        return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    out = np.zeros(len(a))
    for n in range(len(a)):
        ca, cb = corners(a[n].astype(np.float64)), corners(
            b[n].astype(np.float64))
        poly = list(ca)
        for k in range(4):
            poly = clip(poly, cb[k], cb[(k + 1) % 4])
        inter = area(poly)
        union = area(list(ca)) + area(list(cb)) - inter
        out[n] = inter / max(union, 1e-12)
    return out


def check_boxes(got, want, scene):
    """The tolerance of the JAX package's trained-weights parity test:
    same count and labels, score 1e-3, centre and size 1e-2 m, yaw 1e-2."""
    import numpy as np

    if len(got) != len(want):
        fail(f"golden scene {scene}: {len(got)} boxes, JAX has {len(want)}")
    for k, (g, w) in enumerate(zip(got, want)):
        dyaw = abs((g.yaw - w.yaw + math.pi) % (2 * math.pi) - math.pi)
        if (g.label != w.label or abs(g.score - w.score) > 1e-3
                or not np.allclose(g.center, w.center, rtol=0, atol=1e-2)
                or not np.allclose(g.wlh, w.wlh, rtol=0, atol=1e-2)
                or dyaw > 1e-2):
            fail(f"golden scene {scene} box {k}: {g} vs JAX {w}")


def stage_split(det, points, counts, clouds):
    """Host-clock split of one batch-8 call (synchronised after each stage),
    median of 5, and the end-to-end rate from numpy clouds to host boxes."""
    import numpy as np
    import torch

    from tpu_pillars_torch.detector import pack_detections

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    split = {"pad_ms": [], "upload_ms": [], "frontend_ms": [],
             "rpn_head_ms": [], "postprocess_ms": [], "download_ms": [],
             "total_ms": []}
    for _ in range(6):
        t_all = time.perf_counter()
        padded, t_pad = timed(lambda: [det.pad_points(c) for c in clouds])
        (pts, cnt), t_up = timed(lambda: (
            torch.from_numpy(np.stack([p for p, _ in padded])).to(det.device),
            torch.from_numpy(np.asarray([n for _, n in padded])).to(
                det.device)))
        canvas, t_fe = timed(lambda: det.canvas(pts, cnt))
        wire, t_rpn = timed(lambda: det.wire(canvas))
        dets, t_post = timed(lambda: det.postprocess(*wire))
        _, t_down = timed(lambda: pack_detections(dets).cpu())
        total = (time.perf_counter() - t_all) * 1e3
        for key, v in zip(split, (t_pad, t_up, t_fe, t_rpn, t_post, t_down,
                                  total)):
            split[key].append(v)
    med = {k: float(np.median(v[1:])) for k, v in split.items()}
    print(f"stage split, batch {len(clouds)} (host clock, ms): "
          + json.dumps(med))
    print(f"end to end: {len(clouds) / med['total_ms'] * 1e3:.2f} sweeps/s "
          f"at batch {len(clouds)}")


if __name__ == "__main__":
    main()
