#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda`` or ``CUDA_HOME``), and
imports nothing of JAX. Phases; any failure exits non-zero before the last
line:

  1. Print the card (``nvidia-smi`` name and power limit) and build the 11
     CUDA kernels of ``tpu_pillars_torch/csrc`` from source (K3's source
     holds three instances: f32 rows to an f32 canvas, f32 rows to a bf16
     canvas, bf16 rows to a bf16 canvas).
  2. On a batch of 8 lidar-like sweeps of ~100k points at the full
     ``PillarsConfig()``, run each kernel and its plain PyTorch version on
     the card on the same inputs: K1 emit and K3 scatter must be bit-equal
     (K3 also to ``index_copy_`` and K9, and K3's backward; K3's two bf16
     instances bit-equal to their plain versions and to ``index_copy_``
     into a zeroed bf16 canvas, the f32 -> bf16 one also to the f32 canvas
     cast to bf16), K2 fused PFN within atol 1e-5 / rtol 1e-5, K4 NMS
     overlap equal except pairs whose IoU lies within 1e-4 of the
     threshold. K11 stream front end within atol 1e-5 / rtol 1e-5 of its
     plain version and atol 1e-4 / rtol 1e-5 of K3's fused canvas, the
     occupancy equal cell for cell. K7 tiled IoU on the batch's 8 x 1,024
     top-k candidates within atol 1e-5 of its plain version, and within
     1e-3 of the float64 polygon clip on the candidate pairs that pass the
     gate and lie within 8 m of their tile's mean (elsewhere the candidates
     are held only to the plain version; the tiling's own error against the
     dense IoU is printed); within 1e-3 of the dense IoU on boxes within 8 m
     of the origin.
     K5 (the target assigner) on the training batch's GT, the
     golden GT and a crowded 16-per-class GT set: best IoU within 2e-5, the
     best GT equal wherever the IoU is positive and not tied within 2e-5.
     On the classic front end's inputs of the same batch: K6 PFN within
     atol 1e-5 / rtol 1e-5; K10 radix sort (18 and 32 key bits) bit-equal
     to its plain network and to the stable ``torch.sort``; K8 binning rank
     and histogram equal; K9 block gather bit-equal to its plain version,
     to K3's canvas and to ``index_copy_``, its tile ranges equal to theirs.
     Times each (CUDA events, median), with its bound and, where one
     PyTorch call computes the same function, that call's time.
  3. The serving path: ``Detector.from_checkpoint`` on the committed
     trained checkpoint; ``predict`` on the 8 golden scenes of
     ``tests/data/torch_golden_synth4k.npz`` (written by
     ``scripts/make_torch_golden.py`` from the JAX package) must reproduce
     the JAX detections; ``predict_packed_batch`` at batch 8 is timed by
     stage. K1-K4 must have launched during these calls.
     3d. The stream front end and the tiled IoU as drop-ins: the stream
     canvas of the batch against the fused one, the stream canvas then
     ``wire`` and ``postprocess`` on the 8 golden scenes against the JAX
     detections, K7 on the candidates; K11 and K7 must have launched. K11's
     time is printed beside the fused front end's.
     3b. The classic front end (``fused_frontend=False``): the same golden
     check and stage split; K1, K6, K3 and K4 must have launched, K2 not.
     3c. The drop-ins on the batch: the radix sort equals the stable
     sort, the binned pillarizer equals the classic ``PillarBatch``, and K6
     on it then K9 equals the classic canvas bit for bit; K10, K8 and K9
     must have launched.
     3e. bf16 serving, ``Detector(dtype=torch.bfloat16)`` on the trained
     checkpoint and the same batch: K1, K2, K3's f32 -> bf16 instance and
     K4 must have launched (K3's f32 instance not); its wire within the
     reference's bf16 tolerance of the f32 wire (class-logit median |d| <
     0.02, box |d| 99th percentile < 0.1); the stage split in f32 and bf16
     back to back; one classic batch with the plain PillarFeatureNet in
     bf16 (K3's bf16 -> bf16 instance) held to the same tolerance; phase 5
     prints the bf16 held-out and TTA mAP beside f32's (finite, no other
     gate).
     3f. The anchor-major API: ``train.step.make_eval_forward`` (K1,
     ``decorate``, the PillarFeatureNet on its running statistics, K3, RPN,
     ``SSDHead``) and ``ops.postprocess.postprocess`` on the golden scenes
     against the JAX detections; on the batch, ``postprocess_t`` equal to
     ``postprocess`` bit for bit and ``nms_impl="fixpoint"`` equal to
     "pallas" (K4); K1, K3 and K4 launched, K2 and K6 not.
     3g. The serving surface. (a) The batch through the f32, f16 and
     int16 wires (``Detector(wire_dtype=)``): K1-K4 launched on each, the
     wire's own dtype uploaded, each 2-byte wire's detections bit-equal to
     the f32 wire's on its dequantized points; printed against the f32
     wire, not gated (they hold at the tiny config of the CPU tests, not at
     this width: PERF.md §6): tests/test_wire_f16.py's logit measures
     and tests/test_detector_e2e.py's int16 box tolerance; bytes uploaded
     and a host-clock split per wire. (b) ``predict_stream`` on the 8 golden scenes, threaded and
     serial, bit-equal to ``predict``, sweeps/s beside a ``predict`` loop.
     (c) ``Detector.from_torch`` of the checkpoint in the CPU reference's
     torch layout bit-equal to ``from_checkpoint`` on the golden scenes;
     the port's ``CPUReferenceDetector`` on 2 golden scenes within the
     golden tolerance of the JAX detections and of the card's boxes; its
     sweeps/s on the host and the card's batch-8 sweeps/s over it. (d)
     ``python -m tpu_pillars_torch.serve --full-size --batch-size 8`` as a
     subprocess (killed on every exit path): 8 concurrent golden scenes,
     each response equal to the call it rode and to the JAX detections,
     one batched at least, ``/healthz`` naming the card; latencies and
     requests/s. (e) A ``SweepAccumulator`` over a 3-sweep Lyft-format
     fixture equal to ``load_sweeps`` on its keyframes, the clouds served
     at ``num_sweeps=3`` from a seeded model's checkpoint (K1-K4
     launched, the same boxes twice).
     3h. The native sweep loader and multi-sweep training, then export,
     profiling and visualisation. (a) A 10-sweep Lyft-format fixture (8
     samples of 5 sweeps, at the density of scripts/rehearsal_dataset.py):
     the native loader (``data/native_io.py``, built with ``g++``) equal to
     its numpy path bit for bit with the same ``IO_TRUNCATION`` counts, ms
     a sample for each. (b) ``multisweep_config()`` (10 sweeps, 262,144
     points, 20,000 pillars) trains 4 steps of ``fit`` at batch 8 on
     ``dataset_batches(use_native=True, num_workers=4)``: finite losses, K1,
     K3 and K5 launched, the loader's ms a batch beside the step's. (c)
     ``export.export_inference`` of ``PillarsConfig()`` from the trained
     checkpoint at batch 8, ``load_inference``, the 8 golden scenes through
     the artifact bit-equal to the live ``Detector`` and the JAX detections
     (185 boxes), K1-K4 launched by the artifact's own run; export
     seconds, bytes, ms a batch for the artifact and the live ``Detector``.
     (d) ``utils.profiling.StageTimer`` over the serving batch (pad,
     upload, canvas, wire, postprocess) and ``trace`` over one batch: the
     trace file names K1-K4's ``__global__`` functions; the card's busy
     share of the batch is printed; the host time of the K1, K2 and K4
     wrappers, thin calls of their ``tpu_pillars`` ops, beside their CUDA
     implementations called directly. (e) Golden scene 0 rendered through
     ``scripts/torch_visualize.py``'s functions, saved as a PNG and read
     back.
     3i. The single-sweep entry points at ``PillarsConfig()`` on the
     trained checkpoint: the single-sweep ``build_forward_fn``, fused
     (K1, K2, K3, K4) and classic (K1, K6, K3, K4), on each of the 8
     golden scenes within the golden tolerances of the JAX detections,
     bit-equal to the batched form on a batch of one, its canvas
     bit-equal to the batch-8 row and its classes and valid rows equal to
     it (the wire's bit-equality with the batch-8 row is counted and
     printed: the RPN's convolutions may round by batch size; each of
     the RPN's convolutions, batch of one against batch 8 on the same
     input, and the whole wire with cuDNN off, are printed as the
     witness);
     ``pillarize_auto`` (K1) bit-equal to the plain ``pillarize`` on the
     same CUDA tensors; ``rotated_nms_pallas`` (K4) keeping the fixpoint
     NMS's set on each scene's candidates (but for threshold-boundary
     pairs); ``top_k_two_stage`` equal to ``top_k_stable`` (values and
     indices) on the batch's 8 x 720,000 thresholded scores and logits,
     timed at rows 32, 64 and 128 beside it; the batch-of-one latency of
     ``Detector.predict`` (median, host clock, synchronised, after a
     warm-up) with its pad / upload / front end / RPN + head /
     postprocess split, beside batch 8's per sweep, f32 and bf16.
     3j. The user scripts: ``scripts/torch_rehearsal_dataset.py`` writes a
     4-sample root that ``LyftDataset`` reads;
     ``scripts/torch_gt_sampling_ablation.py`` runs its three arms
     (baseline, GT sampling, CBGS) at ``ABLATION_STEPS`` steps an arm on
     the card (finite losses; K1, K2, K3, K4 and K5 launched) and prints
     the AP table; ``scripts/torch_export_artifact.py`` exports a 2-step
     full-size ``train.loop`` run (EMA, eval) and the export serves the 8
     golden scenes bit-equal to its source checkpoint (K1-K4 launched);
     when the script picks the EMA file (a copy), the raw branch,
     ``export_inference_checkpoint`` of the full checkpoint, is served
     against that checkpoint too.
  5. Evaluation (run before training): the held-out mAP of the 8 golden
     scenes on the card (``evaluate_scenes``) within 1e-3 of the port's
     scorer on the golden JAX detections; ``predict_tta`` (4 views, WBF)
     against the golden JAX TTA detections, whose mAP the second scorer
     (``lyft_map_alt``) must reproduce within 1e-9; ``evaluate_dataset`` on a
     Lyft-format fixture at the full config (8 samples, batch 8), its boxes
     equal to ``Detector.predict``'s within 1e-5.
  4. The training path: on the golden batch of
     ``tests/data/torch_train_golden_synth4k.npz`` (written by
     ``scripts/make_torch_train_golden.py`` from the JAX package) the port's
     targets must equal the JAX ones outside 0.1% of the anchors, and three
     steps from the trained checkpoint given the JAX targets must match the
     JAX losses (rtol 2e-3 per step) and running statistics (rtol 1e-2,
     atol 1e-4); then ``train.loop.fit`` at the full config, batch 8, f32,
     with remat "all" and off, reports the median step time, sweeps/s, peak
     memory and a synchronised split. K1, K3 and K5 must have launched
     during the training steps.
     4b. Resume, EMA and the elastic hooks, at the same width: ``fit`` 4
     steps unbroken, and 2 steps stopped before the third (it must log
     ``preempted``); the full checkpoint restored into a fresh state must
     equal the saved one bit for bit, and the last 2 steps on the rest of
     the seeded stream must match the unbroken run's losses (rtol 2e-3:
     cuDNN's backward need not be deterministic) with K1, K3 and K5
     launched; ``fit`` with an ``EmaTracker`` and the synthetic eval hook
     must log finite ``mAP`` and ``mAP_ema`` through JSONL and TensorBoard
     (read back) with K1-K5 launched; ``Detector.from_checkpoint`` serves
     the full file and its ``.ema`` export on the card. Times the
     checkpoint (size, save, restore), the EMA update, the ``NaNGuard``
     snapshot and the eval hook.
     4c. bf16 training: three bf16 steps from the trained checkpoint on
     the golden batch given the JAX targets within rtol 2e-2 of the f32
     losses, the master state f32, the run's checkpoint served by an f32
     ``Detector``; ``fit`` at batch 8 in bf16 with remat "all" and off
     (step ms, sweeps/s, peak memory, split; K1, K3's bf16 -> bf16
     instance and K5 launched, K3's f32 instance not).
     4d. The documented Lyft run: a fixture of 20 samples at the density
     of ``scripts/rehearsal_dataset.py``; ``dataset_batches`` timed with GT
     sampling, object noise and CBGS on 4 workers; ``train.loop.main
     --data ... --full-size --bf16`` for 6 steps at batch 8 must log finite
     losses and a held-out mAP; the loader's ms a batch is printed beside
     the bf16 step's.
     4e. Classic training (``make_train_step(fused_frontend=False)``): on
     the golden batch the dense class-blocked assigner's targets within
     0.1% of the anchors of the JAX targets, three classic steps given the
     JAX targets within rtol 2e-3 of the JAX losses (num_pos equal) and
     every running statistic, the PillarFeatureNet's included, within rtol
     1e-2 / atol 1e-4; ``fit`` at batch 8 with the dense, the banded
     (``assigner="banded"``) and the K5 assigner (f32, remat "all"), remat
     "off" and bf16 (step ms, sweeps/s, peak memory, split); K1 and K3 (its bf16 -> bf16 instance in bf16, its f32
     one not) must launch, K2 not, K5 with K5 only.
     4f. The dense (A, G) ``assign_targets`` (each sample, in chunks of
     ``DENSE_AG_CHUNK`` anchors) and the banded class-blocked assigner
     (``train.step.BAND_CELLS`` = 48) on 4e's batch (96 valid GT), each
     against the class-blocked dense assigner and K5: labels
     equal but on at most 0.1% of the anchors (ties and thresholds,
     counted and printed), reg targets within 1e-4 elsewhere; ms and
     transient GiB of each.

  6. Data parallel on one card (``parallel/``): two ranks on ``cuda:0``
     over gloo (``parallel.launch``; NCCL refuses two ranks on one
     device), each its own process. Three fused f32 data-parallel steps of
     global batch 8 (4 a rank, sync-BN, averaged gradients) from the seeded
     model, and one classic step, held against the one-process step on the
     same batches (loss rtol 2e-3, num_pos equal); the spatial front end
     over the ranks' row bands on a 20,000-point lidar sweep, its canvas
     bit-identical to the one-device ``Detector``'s and its packed boxes
     equal, and on a 50,000-point sweep (over one device's pillar budget)
     bit-identical to one device with twice the budget; the data-parallel
     packed detector on the 8 sweeps within the golden tolerances of the
     ``Detector``'s batch. K1, K3 and K5 launch in each rank's training,
     K1-K4 in each rank's spatial and DP detection. Prints each rank's
     step ms, split (with the gradient all-reduce) and launches.

The line before the last is a JSON object ``{"kernels": [...]}``, each
kernel with its launches on the path that runs it (serving: K1-K4, classic
serving: K6, drop-ins: K8-K10, K11 and K7, training: K5; K3's f32 -> bf16
instance: bf16 serving, its bf16 -> bf16 instance: bf16 training, each its
own entry), under ``dp_launches`` each rank's launches in phase 6 and
under ``phase_launches`` those of phases 3i, 3j and 4f;
the last line is ``{"ok": true, "device": {...}}``.
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
HELDOUT_SEED = 7100      # bench.py's held-out scenes, the golden file's
NMS_BOUNDARY_TOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K4 operations per candidate pair, counted from csrc/nms_overlap.cu (each
# arithmetic op, comparison and select counts one): the circumradius gate,
# and the recentring + two half-edge integrals + IoU of a pair that passes it
K4_OPS_GATE = 8
K4_OPS_HOT = 1500
# K5 (csrc/assign.cu) runs the same gate and the same pair arithmetic
K5_OPS_GATE = 8
K5_OPS_HOT = 1500
# K7 operations per pair, counted from csrc/iou_tiled.cu as K4's: the gate
# (2 subtracts, 3 products, 2 adds, a half, a compare), and for a pair that
# passes it two half-edge integrals (4 half-planes of 6 operations, then 4
# edges of 2 + 4 x 21 + 13 operations) and the area clamps and IoU (~10)
K7_OPS_GATE = 9
K7_OPS_HOT = 2 * (4 * 6 + 4 * (2 + 4 * 21 + 13)) + 10
IOU_BLOCK = 128          # rotated_iou_bev_tiled's default tile
K5_IOU_TOL = 2e-5
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_train_golden_synth4k.npz")
TRAIN_STEPS = 6          # per remat mode; the first is a warm-up
ABLATION_STEPS = 100     # an arm of scripts/torch_gt_sampling_ablation.py
# anchors a chunk of the dense (A, G) assigner in phase 4f: at the JAX
# default of 8,192 its 88 gated chunks a sample are launch- and sync-bound
DENSE_AG_CHUNK = 131072


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


def device_ms(fn, iters: int = 5) -> float:
    """Kernel time of one call of ``fn`` on the card: the profiler's
    summed device time over ``iters`` calls after a warm-up, divided by
    ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / iters / 1e3


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "tpu_pillars_torch")):
        fail(f"no tpu_pillars_torch package beside {__file__}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, ROOT)

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops import (
        bev, emit, fused_pfn, nms_overlap, postprocess,
    )
    from tpu_pillars_torch.ops.voxelize import sort_points_by_pillar
    from tpu_pillars_torch.train.loop import synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig

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

    # K4's inputs are the class-blocked candidates of the main path, K7's
    # the same top-k candidates before the class shift: record both from
    # one batch call
    seen, cands = [], []
    launch_overlap = nms_overlap.overlap_matrix
    nms_entry = postprocess.rotated_nms_overlap
    shift = 4.0 * ((cfg.x_max - cfg.x_min) + (cfg.y_max - cfg.y_min))

    def recording(boxes, thr):
        seen.append((boxes.clone(), thr))
        return launch_overlap(boxes, thr)

    def recording_nms(shifted, valid, thr, class_ids=None, class_gap=0.0):
        boxes = shifted.clone()
        boxes[..., 0] = shifted[..., 0] - class_ids.to(boxes.dtype) * shift
        cands.append(boxes)
        return nms_entry(shifted, valid, thr, class_ids=class_ids,
                         class_gap=class_gap)

    nms_overlap.overlap_matrix = recording
    postprocess.rotated_nms_overlap = recording_nms
    try:
        det.predict_packed_batch(points, counts)
    finally:
        nms_overlap.overlap_matrix = launch_overlap
        postprocess.rotated_nms_overlap = nms_entry
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

    w_pfn, b_pfn = det.model.pfn.folded()
    w_eff, w_dec = fused_pfn.fold_decoration(w_pfn, b_pfn, cfg)
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
        # the kept rows, five meta rows, the features, ids and counts
        bound=bound(kept_pts * F * 4 + 5 * BATCH * P * 4 + feats.numel() * 4
                    + 2 * BATCH * P * 4,
                    kept_pts * C * 2 * F + BATCH * P * C * 14))

    mask = cnt2 > 0.0
    args3 = (feats, pid, mask, cfg)
    canvas = bev.scatter_to_bev(*args3)
    canvas_p = bev.scatter_to_bev_plain(*args3)
    if not torch.equal(canvas, canvas_p):
        fail("K3 BEV scatter differs from its plain version")
    library_scatter = index_copy_scatter(feats, pid, mask, HW)
    if not torch.equal(library_scatter().reshape(canvas.shape), canvas):
        fail("K3 yardstick index_copy_ differs from the kernel")
    if not torch.equal(bev.scatter_to_bev_emit(*args3), canvas):
        fail("K3 differs from K9 on the batch")
    rows["bev_scatter"] = dict(
        err=0.0, ms=cuda_ms(lambda: bev.scatter_to_bev(*args3), 20),
        plain_ms=cuda_ms(lambda: bev.scatter_to_bev_plain(*args3), 5),
        library_ms=cuda_ms(library_scatter, 20),
        bound=bound(n_pillars * C * 4 + BATCH * P * 5 + canvas.numel() * 4,
                    0.0))
    row = rows["bev_scatter"]
    print(f"K3: bit-equal to its plain version, to index_copy_ and to K9; "
          f"{row['ms']:.4f} ms; index_copy_ into torch.zeros "
          f"{row['library_ms']:.4f} ms; kernel / call "
          f"{row['ms'] / row['library_ms']:.3f}")
    # K3's backward (training): the row gather against the plain autograd
    # gradient of the plain scatter, bit for bit
    cot = torch.randn(canvas.shape, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED))
    f1 = feats.detach().clone().requires_grad_(True)
    f2 = feats.detach().clone().requires_grad_(True)
    bev.scatter_to_bev_diff(f1, pid, mask, cfg).backward(cot)
    bev.scatter_to_bev_plain(f2, pid, mask, cfg).backward(cot)
    if not torch.equal(f1.grad, f2.grad):
        fail("K3 backward differs from the plain autograd gradient")
    print("K3 backward: bit-equal to the plain autograd gradient")
    del cot, f1, f2
    # K3's bf16 instances at the same shapes: f32 rows (bf16 serving) and
    # bf16 rows (bf16 training) into a bf16 canvas
    for name, rows_in in (("bev_scatter_f32_bf16", feats),
                          ("bev_scatter_bf16", feats.to(torch.bfloat16))):
        rows[name] = bf16_scatter_row(cfg, name, rows_in, pid, mask, canvas)

    # K5 on the main path's GT (the first batch-8 training batch), the
    # golden training GT and a crowded 16-per-class set
    tcfg8 = TrainConfig(batch_size=BATCH)
    train_arrays = next(synthetic_batches(cfg, tcfg8, seed=SEED))
    golden_t = np.load(TRAIN_GOLDEN)
    gt_sets = {
        "train_batch": train_arrays[2:],
        "golden": (golden_t["gt_boxes"], golden_t["gt_classes"],
                   golden_t["gt_valid"]),
        "crowded": crowded_gt(cfg, BATCH),
    }
    for name, gt in gt_sets.items():
        err = check_assign(cfg, dev, gt, name)
        if name == "train_batch":
            rows["assign"] = assign_row(cfg, dev, gt, err)

    if len(seen) != 1:
        fail(f"the batch call ran the overlap matrix {len(seen)} times")
    boxes, thr = seen[0]
    over = nms_overlap.overlap_matrix(boxes, thr)
    over_p = nms_overlap.overlap_matrix_plain(boxes, thr)
    flips = (over != over_p).nonzero()
    if len(flips):
        b, j, i = flips.unbind(1)
        iou = iou64_pairs(boxes[b, j].cpu().numpy(),
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
    # K11 on the same sorted, centred batch, against its plain version and
    # the fused path's canvas (K1, K2, K3 above)
    rows["stream_pfn"] = stream_row(cfg, gid, pts, w_eff, w_dec, canvas,
                                    kept_pts)
    del canvas, table, meta, feats
    torch.cuda.empty_cache()
    rows["iou_tiled"] = iou_tiled_row(cands[0])
    classic_rows(cfg, points, counts, w_pfn, b_pfn, rows)

    # ---- phase 3: the serving path
    golden = np.load(GOLDEN)
    _build.reset_launches()
    golden_check(det, golden, "fused")
    out = det.predict_packed_batch(points, counts)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the serving path: {launches}")
    for name in ("emit", "fused_pfn", "bev_scatter", "nms_overlap"):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch on the serving path")
    out = out.cpu().numpy()
    if out.shape != (BATCH, cfg.max_detections, 10) or \
            not np.isfinite(out).all():
        fail(f"batch output {out.shape} is not finite (B, D, 10)")
    if out[..., 9].sum() == 0:
        fail("the batch call detected nothing")

    stage_split(det, points, counts, clouds)

    # ---- phase 3d: the stream front end and the tiled IoU as drop-ins
    launches.update(stream_iou_drop_ins(cfg, det, points, counts, golden,
                                        cands[0]))
    del det, out, cands
    torch.cuda.empty_cache()

    # ---- phase 3b: the classic serving path
    det_c = Detector.from_checkpoint(cfg, CKPT, fused_frontend=False)
    if det_c.fused_frontend:
        fail("Detector(fused_frontend=False) took the fused front end")
    _build.reset_launches()
    golden_check(det_c, golden, "classic")
    out = det_c.predict_packed_batch(points, counts)
    torch.cuda.synchronize()
    classic = dict(_build.LAUNCHES)
    print(f"launches on the classic serving path: {classic}")
    for name in ("emit", "pfn", "bev_scatter", "nms_overlap"):
        if classic[name] == 0:
            fail(f"kernel {name} did not launch on the classic path")
    if classic["fused_pfn"]:
        fail("K2 launched on the classic path")
    out = out.cpu().numpy()
    if not np.isfinite(out).all() or out[..., 9].sum() == 0:
        fail("the classic batch call gave no finite detections")
    launches["pfn"] = classic["pfn"]
    stage_split(det_c, points, counts, clouds, "classic front end")

    # ---- phase 3c: the drop-ins at full width, on the serving batch
    launches.update(drop_ins(cfg, det_c, points, counts, w_pfn, b_pfn))
    del det_c
    torch.cuda.empty_cache()

    # ---- phase 3e: bf16 serving (K3's f32 -> bf16 instance)
    launches["bev_scatter_f32_bf16"] = bf16_serving(cfg, points, counts,
                                                    clouds)

    # ---- phase 3f: the anchor-major API (eval forward + postprocess)
    anchor_major_serving(cfg, points, counts, golden)
    del points, counts
    torch.cuda.empty_cache()

    # ---- phase 3g: the serving surface (wires, predict_stream, from_torch
    # and the CPU reference, the HTTP server, the multi-sweep stream)
    surface = serving_surface(cfg, card, clouds, golden)

    # ---- phase 3h: the native sweep loader and multi-sweep training, then
    # export, profiling and visualisation
    phase_3h(cfg, card, clouds, golden)

    # ---- phase 3i: the single-sweep entry points
    phase_launches = {"3i": single_sweep_phase(cfg, card, golden, clouds)}

    # ---- phase 3j: the user scripts (rehearsal dataset, ablation, export)
    scripts = scripts_phase(cfg, card, golden)
    phase_launches["3j"] = {k: scripts["ablation"][k] + scripts["export"][k]
                            for k in scripts["ablation"]}

    # ---- phase 5 (run before training): evaluation on the card
    evaluation(cfg, golden)

    # ---- phase 4: the training path
    train_golden(cfg, dev)
    train_launches = {}
    for remat in ("all", "off"):
        counts_r, _ = train_fit(cfg, dev, remat)
        train_launches = counts_r if remat == "all" else train_launches
    # the main path of this slice for K5 is training; K1-K4 keep the
    # serving path's counts
    launches["assign"] = train_launches["assign"]

    # ---- phase 4b: resume, EMA and the elastic hooks at full width
    resume_phase(cfg, card)

    # ---- phase 4c: bf16 training (K3's bf16 -> bf16 instance)
    bf16_golden(cfg, dev)
    bf16_launches, step_ms = {}, {}
    for remat in ("all", "off"):
        counts_r, step_ms[remat] = train_fit(cfg, dev, remat,
                                             dtype=torch.bfloat16)
        bf16_launches = counts_r if remat == "all" else bf16_launches
    launches["bev_scatter_bf16"] = bf16_launches["bev_scatter_bf16"]
    train_launches["bev_scatter_bf16"] = bf16_launches["bev_scatter_bf16"]

    # ---- phase 4d: the documented Lyft run, in bf16
    lyft_run(cfg, card, step_ms["all"])

    # ---- phase 4e: classic training, the dense assigner and K5
    classic = classic_training(cfg, dev)
    print(f"launches in classic training (f32, remat all, K5): "
          f"{ {k: classic[k] for k in ('emit', 'bev_scatter', 'assign')} }")
    print(f"launches on the serving surface (3g): {json.dumps(surface)}")

    # ---- phase 4f: the dense (A, G) and banded assigners
    phase_launches["4f"] = assigners_4f(cfg, dev)

    # ---- phase 6: data parallel on one card (two ranks over gloo)
    dp_launches = phase_6(cfg, clouds, dev)

    replaces = {"emit": "tpu_pillars/ops/emit_pallas.py:113",
                "fused_pfn": "tpu_pillars/ops/fused_pfn.py:102",
                "bev_scatter": "tpu_pillars/ops/bev_pallas.py:330",
                "nms_overlap": "tpu_pillars/ops/nms_pallas.py:82",
                "assign": "tpu_pillars/ops/assign_pallas.py:143",
                "pfn": "tpu_pillars/ops/pfn_pallas.py:35",
                "radix_sort": "tpu_pillars/ops/sort_pallas.py:80",
                "binning": "tpu_pillars/ops/binning_pallas.py:69",
                "bev_gather": "tpu_pillars/ops/bev_pallas.py:62",
                "stream_pfn": "tpu_pillars/ops/stream_pfn.py:128",
                "iou_tiled": "tpu_pillars/ops/iou_pallas.py:88",
                "bev_scatter_f32_bf16": "tpu_pillars/ops/bev_pallas.py:330",
                "bev_scatter_bf16": "tpu_pillars/ops/bev_pallas.py:330"}
    # K3's instances live in its one source
    sources = {"bev_scatter_f32_bf16": "bev_scatter",
               "bev_scatter_bf16": "bev_scatter"}
    kernels = []
    for name, r in rows.items():
        b_ms, b_by = r["bound"]
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {b_ms:.4f} ms ({b_by}), "
              f"{launches[name]} launches on the main path, "
              f"{train_launches.get(name, 0)} in the remat-all training run, "
              f"{[c[name] for c in dp_launches]} by the ranks of phase 6, "
              f"{ {p: c.get(name, 0) for p, c in phase_launches.items()} } "
              f"in phases 3i, 3j and 4f")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_pillars_torch/csrc/"
                      f"{sources.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"],
            "dp_launches": [c[name] for c in dp_launches],
            "phase_launches": {p: c.get(name, 0)
                               for p, c in phase_launches.items()}})
    print(f"wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def stream_row(cfg, gid, pts, w_eff, w_dec, fused_canvas, kept_pts):
    """K11 against its plain version (atol 1e-5 / rtol 1e-5, K2's gate) and
    the fused path's canvas (atol 1e-4 / rtol 1e-5), occupancy equal cell
    for cell in both; its times and bound."""
    import torch

    from tpu_pillars_torch.ops import stream_pfn

    args = (gid, pts, w_eff, w_dec, cfg)
    got = stream_pfn.stream_canvas_from_sorted(*args)
    plain = stream_pfn.stream_canvas_from_sorted_plain(*args)
    torch.cuda.synchronize()
    occ = got.ne(0).any(-1)
    for name, want, atol in (("its plain version", plain, 1e-5),
                             ("the fused canvas", fused_canvas, 1e-4)):
        if not torch.equal(occ, want.ne(0).any(-1)):
            fail(f"K11 occupancy differs from {name}")
        if not torch.allclose(got, want, atol=atol, rtol=1e-5):
            fail(f"K11 differs from {name}: max |d| "
                 f"{(got - want).abs().max().item():.3e}")
    err = (got - plain).abs().max().item()
    print(f"K11: {int(occ.sum())} occupied cells, max |d| {err:.3e} vs its "
          f"plain version, {(got - fused_canvas).abs().max().item():.3e} "
          f"vs the fused canvas")
    B, M = gid.shape
    F, C = w_eff.shape
    P = cfg.max_pillars
    return dict(
        err=err,
        ms=cuda_ms(lambda: stream_pfn.stream_canvas_from_sorted(*args), 20),
        plain_ms=cuda_ms(
            lambda: stream_pfn.stream_canvas_from_sorted_plain(*args), 3),
        library_ms=None,
        bound=bound(B * M * 4 + kept_pts * F * 4 + got.numel() * 4,
                    kept_pts * C * 2 * F + B * P * C * 14))


def iou_tiled_row(cands):
    """K7 on the main path's (B, K, 7) top-k candidates, as B (K x K)
    matrices: within atol 1e-5 of its plain tiled version; within 1e-3 of
    the float64 polygon clip on the pairs that pass the gate and whose boxes
    both lie within 8 m of their tile's mean, where the recentred
    coordinates are as small as in the JAX package's own test of its kernel
    (farther out the tiling carries its own f32 error, printed against the
    dense IoU and refereed, and the candidates are held only to the plain
    version); within 1e-3 of the dense IoU on boxes within 8 m of the
    origin. Its times and bound."""
    import numpy as np
    import torch

    from tpu_pillars_torch.ops import iou, iou_tiled

    B, K, _ = cands.shape
    got = iou_tiled.rotated_iou_bev_tiled(cands, cands)
    plain = iou_tiled.rotated_iou_bev_tiled_plain(cands, cands)
    dense = torch.stack([iou.rotated_iou_bev(c, c) for c in cands])
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    if err > 1e-5:
        fail(f"K7 differs from its plain version: max |d| {err:.3e}")
    d_got = (got - dense).abs()
    far = (d_got > 1e-3).nonzero()
    print(f"K7 on the candidates: max |d| {err:.3e} vs its plain version; "
          f"vs the dense IoU max |d| {d_got.max().item():.3e}, {len(far)} "
          f"of {B * K * K} pairs beyond 1e-3")
    if len(far):
        b, i, j = far[:256].unbind(1)
        ref = iou64_pairs(cands[b, i].cpu().numpy(), cands[b, j].cpu().numpy())
        off_dense = np.abs(dense[b, i, j].cpu().numpy() - ref).max()
        off_k7 = np.abs(got[b, i, j].cpu().numpy() - ref).max()
        print(f"K7: on those pairs the float64 clip is {off_dense:.3e} from "
              f"the dense IoU and {off_k7:.3e} from K7")

    dx = cands[:, :, None, 0] - cands[:, None, :, 0]
    dy = cands[:, :, None, 1] - cands[:, None, :, 1]
    r = torch.sqrt(cands[..., 3] ** 2 + cands[..., 4] ** 2)
    rr = 0.5 * (r[:, :, None] + r[:, None, :])
    gate = dx * dx + dy * dy <= rr * rr
    hot = int(gate.sum())
    # each tile's mean as the kernel takes it: half the row tile's mean plus
    # half the column tile's, over whole tiles padded with boxes of ones
    tile = torch.arange(K, device=cands.device) // IOU_BLOCK
    d2_i = torch.zeros(B, K, K, device=cands.device)
    d2_j = torch.zeros(B, K, K, device=cands.device)
    for c in (0, 1):
        v = torch.cat([cands[..., c], cands.new_ones(B, -K % IOU_BLOCK)], 1)
        m = v.view(B, -1, IOU_BLOCK).mean(-1)[:, tile]
        mean = 0.5 * (m[:, :, None] + m[:, None, :])
        d2_i += (cands[:, :, None, c] - mean) ** 2
        d2_j += (cands[:, None, :, c] - mean) ** 2
    pick = (gate & (torch.maximum(d2_i, d2_j) <= 8.0 ** 2)
            & ~torch.eye(K, dtype=torch.bool, device=cands.device)).nonzero()
    if len(pick) == 0:
        fail("K7: no gated candidate pair lies within 8 m of its tile's mean")
    n_near = len(pick)
    pick = pick[torch.linspace(0, n_near - 1, min(n_near, 2048),
                               device=pick.device).long()]
    b, i, j = pick.unbind(1)
    ref = iou64_pairs(cands[b, i].cpu().numpy(), cands[b, j].cpu().numpy())
    err_ref = float(np.abs(got[b, i, j].cpu().numpy() - ref).max())
    if err_ref > 1e-3:
        fail(f"K7 near the tile mean: max |d| {err_ref:.3e} from the float64 "
             f"clip (limit 1e-3)")
    print(f"K7 on {len(pick)} of the {n_near} gated candidate pairs near "
          f"their tile's mean: max |d| {err_ref:.3e} from the float64 clip "
          f"({int((ref > 0).sum())} of them overlap)")
    rng = np.random.default_rng(SEED + 2)
    near = np.zeros((B, K, 7), np.float32)
    near[..., 0:2] = rng.uniform(-8.0, 8.0, (B, K, 2))
    near[..., 2:6] = rng.uniform([-1.0, 0.5, 0.5, 0.5], [1.0, 3.0, 6.0, 3.0],
                                 (B, K, 4))
    near[..., 6] = rng.uniform(-np.pi, np.pi, (B, K))
    near = torch.from_numpy(near).to(cands.device)
    got_n = iou_tiled.rotated_iou_bev_tiled(near, near)
    dense_n = torch.stack([iou.rotated_iou_bev(c, c) for c in near])
    err_n = (got_n - dense_n).abs().max().item()
    if err_n > 1e-3:
        fail(f"K7 on boxes within 8 m: max |d| {err_n:.3e} from the dense "
             f"IoU (limit 1e-3)")
    print(f"K7 on {B} x {K} boxes within 8 m of the origin: max |d| "
          f"{err_n:.3e} from the dense IoU")
    pairs = B * K * K
    print(f"K7: {hot} of {pairs} pairs pass the gate")
    return dict(
        err=err,
        ms=cuda_ms(lambda: iou_tiled.rotated_iou_bev_tiled(cands, cands), 20),
        plain_ms=cuda_ms(
            lambda: iou_tiled.rotated_iou_bev_tiled_plain(cands, cands), 3),
        library_ms=None,
        bound=bound(2 * cands.numel() * 4 + pairs * 4,
                    pairs * K7_OPS_GATE + hot * K7_OPS_HOT))


def crowded_gt(cfg, batch):
    """16 GT of every class per sample, packed around a few spots so that
    many anchors see several overlapping GT (ties and near-ties)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    C, G = cfg.num_classes, 16
    gt = np.zeros((batch, C * G, 7), np.float32)
    cls = np.repeat(np.arange(C, dtype=np.int32), G)[None].repeat(batch, 0)
    for b in range(batch):
        for c, spec in enumerate(cfg.classes):
            ctr = rng.uniform(-60.0, 60.0, 2)
            for g in range(G):
                gt[b, c * G + g] = [
                    ctr[0] + rng.uniform(-2, 2), ctr[1] + rng.uniform(-2, 2),
                    spec.z_center, spec.width * rng.uniform(0.8, 1.25),
                    spec.length * rng.uniform(0.8, 1.25), spec.height,
                    rng.uniform(-np.pi, np.pi)]
    return gt, cls, np.ones(cls.shape, bool)


def _grouped(cfg, dev, gt):
    import torch

    from tpu_pillars_torch.ops.target_assigner import group_gt_by_class

    boxes, cls, valid = (torch.as_tensor(x).to(dev) for x in gt)
    return group_gt_by_class(boxes.float(), cls.long(), valid.bool(),
                             cfg.num_classes, 16)


def check_assign(cfg, dev, gt, name):
    """K5 against its plain version on one GT set, under the K5 contract;
    returns the largest IoU difference."""
    import torch

    from tpu_pillars_torch.ops import assign

    gt_c, gv_c = _grouped(cfg, dev, gt)
    best, best_gt, gval, ganc = assign.windowed_best_iou(gt_c, gv_c, cfg)
    wbest, wbest_gt, wgval, _ = assign.windowed_best_iou_plain(gt_c, gv_c,
                                                               cfg)
    torch.cuda.synchronize()
    err = float((best - wbest).abs().max())
    if err > K5_IOU_TOL or float((gval - wgval).abs().max()) > K5_IOU_TOL:
        fail(f"K5 on {name}: best IoU differs from the plain version by "
             f"{err:.2e}")
    n_clear = n_diff = 0
    for b in range(gt_c.shape[0]):
        iou = assign.class_iou_plain(gt_c[b], gv_c[b], cfg)    # (C, Gc, Ac)
        top2 = iou.topk(2, dim=1).values
        clear = (wbest[b] > 0) & (top2[:, 0] - top2[:, 1] > K5_IOU_TOL)
        n_clear += int(clear.sum())
        n_diff += int((best_gt[b] != wbest_gt[b])[clear].sum())
        picked = torch.gather(iou, 2, ganc[b][..., None])[..., 0]
        claim = gv_c[b] & (wgval[b] > 0)
        if ((picked - wgval[b]).abs()[claim] > K5_IOU_TOL).any():
            fail(f"K5 on {name}: a GT's best anchor is not a best anchor")
        del iou, top2
    if n_diff:
        fail(f"K5 on {name}: best GT differs on {n_diff} of {n_clear} "
             f"anchors with a clear best")
    print(f"K5 {name}: max |d IoU| {err:.2e}, best GT equal on {n_clear} "
          f"anchors with a clear best, {int(gv_c.sum())} valid GT")
    return err


def assign_row(cfg, dev, gt, err):
    """K5's times and bound on the main path's GT set."""
    import torch

    from tpu_pillars_torch.ops import assign

    gt_c, gv_c = _grouped(cfg, dev, gt)
    planes = assign._device_planes(cfg, dev)
    pay = assign.gt_payload(gt_c, gv_c)
    B, C, Gc, _ = gt_c.shape
    Ac = planes.shape[2]
    hot = 0
    for b in range(B):          # pairs that pass the per-anchor gate
        dx = pay[b, :, :, 8, None] - planes[:, None, 8]
        dy = pay[b, :, :, 9, None] - planes[:, None, 9]
        rr = pay[b, :, :, 11, None] + planes[:, None, 11]
        hot += int(((dx * dx + dy * dy <= rr * rr)
                    & gv_c[b, :, :, None]).sum())
    pairs = int(gv_c.sum()) * Ac
    live = assign.tile_gate_plain(gt_c, cfg).logical_not_() & gv_c[..., None]
    print(f"K5: {hot} of {pairs} valid (GT, anchor) pairs pass the gate; "
          f"{int(live.sum())} of {int(gv_c.sum()) * live.shape[-1]} valid "
          f"(GT, anchor tile) pairs pass the tile gate")
    # bytes: the GT boxes and validity and the planes read once; best (4 B)
    # and best_gt (8 B) per (b, c, anchor), gt_best_iou and
    # gt_best_anchor (4 + 8 B) per GT slot written once
    return dict(
        err=err, ms=cuda_ms(lambda: assign.windowed_best_iou(gt_c, gv_c, cfg),
                            20),
        plain_ms=cuda_ms(lambda: assign.windowed_best_iou_plain(gt_c, gv_c,
                                                                cfg), 2),
        library_ms=None,
        bound=bound(gt_c.numel() * 4 + gv_c.numel() + planes.numel() * 4
                    + B * C * Ac * (4 + 8) + B * C * Gc * (4 + 8),
                    pairs * K5_OPS_GATE + hot * K5_OPS_HOT))


def golden_targets(g, cfg, dev):
    """The JAX targets stored in the training golden file -> batched
    ``Targets`` on ``dev``."""
    import numpy as np
    import torch

    from tpu_pillars_torch.ops.anchors import make_anchors
    from tpu_pillars_torch.ops.target_assigner import Targets

    B, A, C = g["gt_boxes"].shape[0], cfg.num_anchors, cfg.num_classes
    pos = np.unpackbits(g["pos_bits"])[:B * A].reshape(B, A).astype(bool)
    weight = np.unpackbits(g["weight_bits"])[:B * A].reshape(B, A)
    reg = np.zeros((B, A, 7), np.float32)
    reg[pos] = g["reg_pos"]
    dirt = np.zeros((B, A), np.int32)
    dirt[pos] = g["dir_pos"]
    _, anchor_cls = make_anchors(cfg)
    onehot = (np.asarray(anchor_cls)[None, :] == np.arange(C)[:, None])
    t = Targets(
        cls_onehot=onehot[None].astype(np.float32) * pos[:, None],
        reg_targets=reg.transpose(0, 2, 1),
        dir_targets=dirt, cls_weights=weight.astype(np.float32),
        reg_weights=pos.astype(np.float32),
        num_pos=pos.sum(1).astype(np.float32))
    return Targets(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in t))


def golden_batch(g, cfg, dev):
    """The golden training file's clouds, padded, and its GT, on ``dev``."""
    import numpy as np

    from tpu_pillars_torch.train.step import batch_to_device

    offs = g["offsets"]
    B = len(offs) - 1
    pts = np.full((B, cfg.max_points, cfg.num_input_features), 1e6,
                  np.float32)
    npts = np.zeros(B, np.int32)
    for s in range(B):
        cloud = g["points"][offs[s]:offs[s + 1]]
        n = min(len(cloud), cfg.max_points)
        pts[s, :n] = cloud[:n]
        npts[s] = n
    return batch_to_device((pts, npts, g["gt_boxes"], g["gt_classes"],
                            g["gt_valid"]), dev)


def train_golden(cfg, dev, classic=False):
    """The training step from the trained checkpoint on the golden batch
    against the JAX package (whose golden steps ran its classic front end
    and dense assigner): the port's own targets (K5's, or with ``classic``
    the dense assigner's) against the JAX ones (positives equal outside
    0.1% of the anchors), then three steps (fused, or with ``classic`` the
    classic front end) given the JAX targets against the JAX losses (rtol
    2e-3, num_pos equal) and running statistics (rtol 1e-2, atol 1e-4)."""
    import numpy as np
    import torch

    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import make_assigner, make_train_step
    from tpu_pillars_torch.weights import (
        flax_from_params, load_flax_msgpack, params_from_flax,
    )

    label = "classic, dense assigner" if classic else "fused, K5"
    g = np.load(TRAIN_GOLDEN)
    batch = golden_batch(g, cfg, dev)
    B = batch.points.shape[0]
    jax_targets = golden_targets(g, cfg, dev)
    assign = make_assigner(cfg, "dense" if classic else "windowed")
    torch.cuda.synchronize()
    t = time.perf_counter()
    own = assign(batch.gt_boxes, batch.gt_classes, batch.gt_valid)
    torch.cuda.synchronize()
    assign_ms = (time.perf_counter() - t) * 1e3
    pos = own.reg_weights > 0
    want_pos = jax_targets.reg_weights > 0
    flips = int((pos != want_pos).sum())
    if flips > 1e-3 * pos.numel():
        fail(f"golden positives ({label}): {flips} of {pos.numel()} anchors "
             f"differ from the JAX targets")
    print(f"golden targets ({label}): {int(pos.sum())} positives (JAX "
          f"{int(want_pos.sum())}), {flips} anchors differ; assigned in "
          f"{assign_ms:.2f} ms (batch {B}, first call)")

    tree = load_flax_msgpack(CKPT)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    tcfg = TrainConfig(learning_rate=float(g["learning_rate"]),
                       total_steps=int(g["total_steps"]), batch_size=B)
    state = create_train_state(cfg, tcfg, state_dict=params_from_flax(
        variables, cfg))
    front = dict(fused_frontend=False) if classic else {}
    step = make_train_step(cfg, assigner=lambda *gt: jax_targets, **front)
    worst_rel = np.zeros(4)
    for i in range(len(g["losses"])):
        state, losses = step(state, batch)
        got = [float(x) for x in losses]
        want = g["losses"][i]
        print(f"golden train step {i + 1} ({label}): loss {got[0]:.6f} (JAX "
              f"{want[0]:.6f}), cls {got[1]:.6f} ({want[1]:.6f}), loc "
              f"{got[2]:.6f} ({want[2]:.6f}), dir {got[3]:.6f} "
              f"({want[3]:.6f}), num_pos {got[4]:.0f} ({want[4]:.0f})")
        if not np.isfinite(got).all() or got[4] != want[4] or \
                abs(got[0] - want[0]) > 2e-3 * abs(want[0]):
            fail(f"golden train step {i + 1} ({label}): loss {got[0]} vs "
                 f"JAX {want[0]} (rtol 2e-3)")
        worst_rel = np.maximum(worst_rel, np.abs(
            np.subtract(got[:4], want[:4])) / np.abs(want[:4]))
    stats = flax_from_params(state.model.state_dict(), cfg)["batch_stats"]
    worst = 0.0
    for key in (k for k in g.files if k.startswith("stats/")):
        node = stats
        for part in key.split("/")[1:]:
            node = node[part]
        want = g[key]
        if not np.allclose(node, want, rtol=1e-2, atol=1e-4):
            fail(f"golden running statistic {key} ({label}) differs: max "
                 f"|d| {np.abs(node - want).max():.3e}")
        worst = max(worst, float(np.abs(node - want).max()))
    print(f"golden training ({label}): 3 steps match the JAX losses, worst "
          f"relative |d| total / cls / loc / dir "
          f"{' / '.join(f'{x:.2e}' for x in worst_rel)}; running stats "
          f"(the PFN's bn included) max |d| {worst:.2e}")
    # the port's own step (its own targets), for the record
    state = create_train_state(cfg, tcfg, state_dict=params_from_flax(
        variables, cfg))
    _, losses = make_train_step(cfg, assigner=assign, **front)(state, batch)
    print(f"golden step 1 ({label}) with the port's own targets: loss "
          f"{float(losses.total):.6f} (JAX {g['losses'][0][0]:.6f})")
    del state
    torch.cuda.empty_cache()


def train_fit(cfg, dev, remat, dtype=None, classic=False,
              assigner="windowed"):
    """``train.loop.fit`` at batch 8 from a seeded random model, in f32 or
    ``dtype``, on the fused front end or (``classic``) the classic one,
    with the ``assigner`` named: median step time, sweeps/s, peak memory,
    and a synchronised split of extra steps. Returns the launches of the
    timed steps and the median step ms."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.train.loop import fit, synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import batch_to_device, make_train_step

    dtype = dtype or torch.float32
    label = f"remat {remat}, {str(dtype)[6:]}"
    if classic:
        label = f"classic, {assigner} assigner, {label}"
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=TRAIN_STEPS,
                       batch_size=BATCH, compute_dtype=str(dtype)[6:])
    state = create_train_state(cfg, tcfg, seed=SEED)
    step = make_train_step(cfg, remat=remat, compute_dtype=dtype,
                           assigner=assigner,
                           fused_frontend=not classic)
    times, last = [], []

    def timed(st, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, losses = step(st, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        last.append(float(losses.total))
        return st, losses

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    state = fit(state, synthetic_batches(cfg, tcfg, seed=SEED), TRAIN_STEPS,
                step_fn=timed, config=cfg)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    scatter = ("bev_scatter" if dtype == torch.float32
               else "bev_scatter_bf16")
    for name in ("emit", scatter) + (("assign",) if assigner == "windowed"
                                      else ()):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch during training ({label})")
    if dtype != torch.float32 and launches["bev_scatter"]:
        fail(f"K3's f32 instance launched in {label} training")
    if classic and launches["fused_pfn"]:
        fail(f"K2 launched in {label} training")
    if assigner in ("dense", "banded") and launches["assign"]:
        fail(f"K5 launched in {label} training")
    if not np.isfinite(last).all():
        fail(f"training ({label}) gave a non-finite loss: {last}")
    if not all(t.dtype == torch.float32
               for t in list(state.model.state_dict().values())
               + state.optimizer.mu + state.optimizer.nu):
        fail(f"training ({label}) left a master tensor that is not f32")
    splits = []
    batches = synthetic_batches(cfg, tcfg, seed=SEED + 1)
    for _ in range(3):
        split = {}
        step(state, batch_to_device(next(batches), dev), split=split)
        splits.append(split)
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    med = float(np.median(times[1:]))
    print(f"training, {label}, batch {BATCH}: median step "
          f"{med:.2f} ms over {len(times) - 1} steps after a warm-up, "
          f"{BATCH / med * 1e3:.2f} sweeps/s, peak memory "
          f"{peak / 2**30:.2f} GiB, losses {[round(x, 4) for x in last]}")
    print(f"training split, {label} (host clock, synchronised, ms): "
          + json.dumps(split))
    print(f"launches in the training run ({label}): {launches}")
    del state
    torch.cuda.empty_cache()
    return launches, med


class AnchorMajorDetector:
    """``predict`` through the anchor-major API: the classic
    ``Detector``'s padding and model, ``train.step.make_eval_forward``
    (K1, ``decorate``, the PillarFeatureNet, K3, RPN, ``SSDHead``), then
    ``ops.postprocess.postprocess`` with ``nms_impl``."""

    def __init__(self, det, nms_impl="auto"):
        import numpy as np
        import torch

        from tpu_pillars_torch.ops.anchors import make_anchors
        from tpu_pillars_torch.train.step import make_eval_forward

        self.det, self.config, self.nms_impl = det, det.config, nms_impl
        self.forward = make_eval_forward(det.config)
        anchors, anchor_cls = make_anchors(det.config)
        self.anchors = torch.from_numpy(np.array(anchors)).to(det.device)
        self.anchor_cls = torch.from_numpy(
            np.array(anchor_cls, np.int64)).to(det.device)

    def outputs(self, points, counts):
        return self.forward(self.det.model, points, counts)

    def detections(self, out, nms_impl=None, layout="anchor"):
        from tpu_pillars_torch.ops import postprocess

        impl = nms_impl or self.nms_impl
        if layout == "feature":
            return postprocess.postprocess_t(
                *(t.transpose(1, 2) for t in out), self.anchors,
                self.anchor_cls, self.config, impl)
        return postprocess.postprocess(*out, self.anchors, self.anchor_cls,
                                       self.config, impl)

    def predict(self, cloud):
        import numpy as np
        import torch

        from tpu_pillars_torch.detector import (
            pack_detections, packed_to_boxes,
        )

        padded, n = self.det.pad_points(cloud)
        pts = torch.from_numpy(padded[None]).to(self.det.device)
        cnt = torch.from_numpy(np.asarray([n], np.int64)).to(self.det.device)
        det = self.detections(self.outputs(pts, cnt))
        return packed_to_boxes(pack_detections(det)[0].cpu().numpy(),
                               self.config)


WIRE_NAMES = ("f32", "f16", "int16")


def serving_surface(cfg, card, clouds, golden):
    """Phase 3g, the serving surface at the full config on the trained
    checkpoint: (a) the f32, f16 and int16 wires, (b) ``predict_stream``,
    (c) ``Detector.from_torch`` and the CPU reference, (d) the HTTP server
    as a subprocess, (e) the multi-sweep stream. The server starts first
    and warms while (a)-(c) run. Returns the launches of the f32 wire's
    batch call and of the other paths, by path."""
    import torch

    from tpu_pillars_torch.detector import Detector

    t_phase = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_pillars_torch.serve", "--ckpt", CKPT,
         "--full-size", "--batch-size", str(BATCH), "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        launches = wire_phase(cfg, clouds)
        det = Detector.from_checkpoint(cfg, CKPT)
        launches["stream"] = stream_phase(det, golden)
        launches["reference"] = reference_phase(cfg, det, golden)
        launches["server"] = server_phase(cfg, det, golden, proc)
        launches["multisweep"] = multisweep_phase(cfg)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=60)
    del det
    torch.cuda.empty_cache()
    print(f"phase 3g ({card}): {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_3h(cfg, card, clouds, golden):
    """Phase 3h: the native sweep loader and multi-sweep training, then
    export, profiling and visualisation. Returns the launches of the
    artifact's own golden run."""
    import tempfile

    import torch

    from tpu_pillars_torch.detector import Detector

    t_phase = time.perf_counter()
    det = Detector.from_checkpoint(cfg, CKPT)
    with tempfile.TemporaryDirectory() as tmp:
        multisweep_training(card, tmp)
        launches = export_phase(cfg, card, det, golden, tmp)
        profiling_phase(det, clouds, tmp)
        dispatch_cost(cfg)
        visualisation_phase(cfg, det, golden, tmp)
    del det
    torch.cuda.empty_cache()
    print(f"phase 3h ({card}): {time.perf_counter() - t_phase:.1f} s")
    return launches


def multisweep_training(card, tmp):
    """3h (a) and (b): a 10-sweep Lyft-format fixture (8 samples of 5
    sweeps each, whose chains run into the previous sample's sweeps) at the
    density of scripts/rehearsal_dataset.py. The native loader (``g++``
    build) must equal the numpy path bit for bit with the same
    ``IO_TRUNCATION`` counts; ms a sample for each. Then
    ``multisweep_config()`` (10 sweeps, 262,144 points, 20,000 pillars)
    trains 4 steps of ``fit`` at batch 8 from a seeded model on
    ``dataset_batches(use_native=True, num_workers=4)`` with the global
    augmentation: finite losses, K1, K3 and K5 launched; the loader's ms
    a batch beside the step's."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import multisweep_config
    from tpu_pillars_torch.data import native_io
    from tpu_pillars_torch.data.augment import AugmentConfig
    from tpu_pillars_torch.data.fixture import build_fixture
    from tpu_pillars_torch.data.lyft import LyftDataset
    from tpu_pillars_torch.train.data import dataset_batches
    from tpu_pillars_torch.train.loop import fit
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import make_train_step
    from tpu_pillars_torch.utils.truncation import IO_TRUNCATION

    ms = multisweep_config()
    t0 = time.perf_counter()
    if not native_io.native_available():
        fail(f"the native loader did not build: {native_io.native_error()}")
    build_s = time.perf_counter() - t0
    ds = LyftDataset(build_fixture(
        os.path.join(tmp, "sweeps"), ms, num_scenes=2, samples_per_scene=4,
        sweeps_per_sample=5, seed=SEED, num_objects=25,
        points_per_object=300, clutter=25_000))
    tokens = ds.sample_tokens()
    per_path, times = {}, {True: [], False: []}
    for rep in range(2):                     # the first pass warms the files
        for use_native in (True, False):
            IO_TRUNCATION.reset()
            out = []
            for tok in tokens:
                t = time.perf_counter()
                out.append(ds.load_sweeps_padded(tok, ms,
                                                 use_native=use_native))
                times[use_native].append((time.perf_counter() - t) * 1e3)
            per_path[use_native] = (out, (
                IO_TRUNCATION.clouds, IO_TRUNCATION.truncated_clouds,
                IO_TRUNCATION.dropped_points))
    (nat, nat_io), (npy, npy_io) = per_path[True], per_path[False]
    for k, ((a, na), (b, nb)) in enumerate(zip(nat, npy)):
        if na != nb or not np.array_equal(a, b):
            fail(f"the native loader differs from the numpy path on "
                 f"sample {k}")
    if nat_io != npy_io:
        fail(f"IO_TRUNCATION differs: native {nat_io}, numpy {npy_io}")
    n = len(tokens)
    nat_ms = float(np.median(times[True][n:]))
    npy_ms = float(np.median(times[False][n:]))
    print(f"native loader ({card}): g++ build {build_s:.2f} s; "
          f"{len(ds._sweep_chain(tokens[-1], ms.num_sweeps)[0])} sweeps a "
          f"sample, {np.mean([int(c) for _, c in nat]):.0f} points kept of "
          f"the {ms.max_points} budget; bit-equal to the numpy path on "
          f"{n} samples, IO_TRUNCATION (clouds, truncated, dropped) "
          f"{nat_io} on both; {nat_ms:.2f} ms a sample native, "
          f"{npy_ms:.2f} ms numpy (median of {n}, warm files)")

    tcfg = TrainConfig(learning_rate=1e-3, total_steps=4, batch_size=BATCH)
    state = create_train_state(ms, tcfg, seed=SEED)
    step = make_train_step(ms)
    step_ms, loader_ms, losses = [], [], []

    def timed_loader():
        it = dataset_batches(ds, ms, BATCH, tcfg.max_gt_boxes,
                             augment=AugmentConfig(), seed=SEED,
                             use_native=True, num_workers=4)
        try:
            while True:
                t = time.perf_counter()
                b = next(it)
                loader_ms.append((time.perf_counter() - t) * 1e3)
                yield b
        finally:
            it.close()

    def timed(st, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, out = step(st, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append([float(x) for x in (out.total, out.cls, out.loc,
                                          out.dir)])
        return st, out

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    state = fit(state, timed_loader(), 4, step_fn=timed, config=ms)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if len(losses) != 4 or not np.isfinite(losses).all():
        fail(f"multi-sweep training gave non-finite losses: {losses}")
    for name in ("emit", "bev_scatter", "assign"):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch in multi-sweep training")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med_step = float(np.median(step_ms[1:]))
    med_load = float(np.median(loader_ms[1:]))
    print(f"multi-sweep training ({card}): multisweep_config() at batch "
          f"{BATCH}, 4 steps of fit on dataset_batches(use_native=True, 4 "
          f"workers): losses {[round(x[0], 4) for x in losses]}; step "
          f"{med_step:.2f} ms, loader {med_load:.2f} ms a batch (medians "
          f"after the first: {loader_ms[0]:.1f} / {step_ms[0]:.1f} ms); "
          f"peak {peak:.2f} GiB; launches {launches}")
    del state
    torch.cuda.empty_cache()


def export_phase(cfg, card, det, golden, tmp):
    """3h (c): ``PillarsConfig()`` exported from the golden checkpoint on
    the card at batch 8, loaded back with ``load_inference``; the 8 golden
    scenes through the artifact must equal the live ``Detector`` bit for
    bit and the JAX detections (185 boxes), with K1-K4 launched by the
    artifact's own run. Export seconds, artifact bytes, ms a batch of 8 for
    the artifact and the live ``Detector``."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.detector import packed_to_boxes
    from tpu_pillars_torch.export import export_inference, load_inference

    path = os.path.join(tmp, "artifact")
    t0 = time.perf_counter()
    export_inference(cfg, det.model.state_dict(), path, batch_sizes=(BATCH,))
    export_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    t0 = time.perf_counter()
    art = load_inference(path)
    load_s = time.perf_counter() - t0
    scenes = golden_clouds(golden)
    padded = [art.pad_points(c) for c in scenes]
    pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(det.device)
    cnt = torch.from_numpy(np.asarray([n for _, n in padded])).to(det.device)
    _build.reset_launches()
    got = art.predict_packed_batch(pts, cnt)
    torch.cuda.synchronize()
    launches = _serving_launches("the exported artifact's run")
    want = det.predict_packed_batch(pts, cnt)
    if not torch.equal(got, want):
        fail("the exported artifact differs from the live Detector")
    got = got.cpu().numpy()
    n_boxes = 0
    for s in range(len(scenes)):
        boxes = packed_to_boxes(got[s], cfg)
        check_boxes(boxes, packed_to_boxes(golden["packed"][s], cfg), s)
        n_boxes += len(boxes)
    art_ms = cuda_ms(lambda: art.predict_packed_batch(pts, cnt), 5)
    live_ms = cuda_ms(lambda: det.predict_packed_batch(pts, cnt), 5)
    files = ", ".join(sorted(os.listdir(path)))
    print(f"export ({card}): PillarsConfig() at batch {BATCH} in "
          f"{export_s:.2f} s, {size} bytes ({files}), loaded in "
          f"{load_s:.2f} s; the {len(scenes)} golden scenes: "
          f"bit-equal to the live Detector, {n_boxes} boxes match the JAX "
          f"detections; launches by the artifact {launches}; "
          f"{art_ms:.2f} ms a batch of {BATCH} (artifact), {live_ms:.2f} ms "
          f"(live)")
    return launches


def profiling_phase(det, clouds, tmp):
    """3h (d): ``StageTimer`` over the serving batch of 8 (pad, upload,
    canvas, wire, postprocess; 5 batches after a warm-up, mean ms), then
    ``trace`` over one batch: the trace file must name the ``__global__``
    functions of K1-K4; the card's busy share of the traced batch (the
    union of its kernel, copy and memset intervals over the batch's host
    span, a ``record_function``) is printed."""
    import numpy as np
    from torch.profiler import record_function

    from tpu_pillars_torch.utils.profiling import (
        StageTimer, trace, trace_files,
    )

    def batch(timer):
        with timer.stage("pad"):
            padded = [det.pad_points(c) for c in clouds]
            pts = np.stack([p for p, _ in padded])
            cnt = np.asarray([n for _, n in padded])
        with timer.stage("upload"):
            pts_t = timer.observe(det.upload(pts))
            cnt_t = timer.observe(det.upload(cnt).long())
        with timer.stage("canvas"):
            canvas = timer.observe(det.canvas(pts_t, cnt_t))
        with timer.stage("wire"):
            wire = timer.observe(det.wire(canvas))
        with timer.stage("postprocess"):
            out = timer.observe(det.postprocess(*wire))
        return out

    batch(StageTimer())
    timer = StageTimer()
    for _ in range(5):
        batch(timer)
    means = {k: v["mean_ms"] for k, v in timer.summary().items()}
    print(f"StageTimer, serving batch of {len(clouds)} (mean of 5, ms): "
          f"{json.dumps(means)}")

    log_dir = os.path.join(tmp, "trace")
    with trace(log_dir):
        with record_function("serving_batch"):
            batch(StageTimer())
    files = trace_files(log_dir)
    if len(files) != 1:
        fail(f"trace wrote {len(files)} files under {log_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = " ".join({e["name"] for e in kernels})
    for k, fn in (("K1", "emit_rows_kernel"), ("K2", "fpfn_kernel"),
                  ("K3", "bev_scatter_kernel"), ("K4", "nms_overlap_kernel")):
        if fn not in names:
            fail(f"the trace names no {fn} ({k})")
    call = [e for e in events if e.get("name") == "serving_batch"
            and e.get("cat") == "user_annotation"]
    if not call:
        fail("the trace holds no serving_batch span")
    c0, c1 = call[0]["ts"], call[0]["ts"] + call[0]["dur"]
    busy = sorted((max(e["ts"], c0), min(e["ts"] + e["dur"], c1))
                  for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    union, end = 0.0, c0
    for s, e in busy:
        if e > end:
            union += e - max(s, end)
            end = e
    print(f"trace: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0])} bytes, {len(kernels)} kernel "
          f"events, K1-K4 named; the card busy {union / 1e3:.3f} ms of the "
          f"batch's {(c1 - c0) / 1e3:.3f} ms host span (busy share "
          f"{union / (c1 - c0):.4f}, idle {1 - union / (c1 - c0):.4f}; the "
          f"profiler on)")


def dispatch_cost(cfg, calls: int = 200, reps: int = 5):
    """3h (d): the host time of a wrapper that is a thin call of its
    ``tpu_pillars`` op against its CUDA implementation called directly,
    for K1 (five arguments, two outputs), K2 (ten, three) and K4 (two,
    one) at the serving batch's shapes: ``calls`` calls made back to back
    (the launch queue holds them, so the host's own time is what is
    timed), the card synchronised between reps, the two alternating;
    median µs a call."""
    import numpy as np
    import torch

    from tpu_pillars_torch.ops import emit, fused_pfn, nms_overlap

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hw = cfg.grid_h * cfg.grid_w
    gid = torch.sort(torch.randint(0, hw + 1, (BATCH, cfg.max_points),
                                   device="cuda", generator=gen)).values
    k1 = (gid.to(torch.int32), torch.rand((BATCH, cfg.max_points, 4),
                                          device="cuda", generator=gen),
          cfg.max_points_per_pillar, cfg.max_pillars, hw)
    boxes = torch.rand((BATCH, 500, 7), device="cuda", generator=gen) \
        * torch.tensor([100.0, 100.0, 2.0, 2.0, 5.0, 2.0, 3.0],
                       device="cuda") + 0.5
    k4 = (boxes, 0.2)
    w_eff = torch.rand((4, cfg.pfn_channels), device="cuda", generator=gen)
    w_dec = torch.rand((8, cfg.pfn_channels), device="cuda", generator=gen)
    table_meta = emit.emit_table(*k1)
    pairs = {"K1": (emit.emit_table, emit.emit_table_cuda, k1),
             "K2": (lambda *a: fused_pfn.pfn_from_table(*a, cfg),
                    lambda *a: fused_pfn.pfn_from_table_cuda(
                        *a, *fused_pfn.geometry(cfg)),
                    (*table_meta, w_eff, w_dec)),
             "K4": (nms_overlap.overlap_matrix,
                    nms_overlap.overlap_matrix_cuda, k4)}
    out = {}
    for k, (wrapper, direct, args) in pairs.items():
        times = {wrapper: [], direct: []}
        for fn in (wrapper, direct):
            fn(*args)
        torch.cuda.synchronize()
        for _ in range(reps):
            for fn in (wrapper, direct):
                t = time.perf_counter()
                for _ in range(calls):
                    fn(*args)
                times[fn].append((time.perf_counter() - t) / calls * 1e6)
                torch.cuda.synchronize()
        out[k] = (float(np.median(times[wrapper])),
                  float(np.median(times[direct])))
    print("op dispatch, host us a call through the op / the CUDA "
          "implementation direct (median of " f"{reps} x {calls}): "
          + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in out.items()))


def visualisation_phase(cfg, det, golden, tmp):
    """3h (e): golden scene 0 rendered through scripts/torch_visualize.py's
    functions (its points, the card's boxes class-coloured, the JAX
    detections in green), saved as a PNG and read back."""
    import numpy as np

    from tpu_pillars_torch.detector import packed_to_boxes
    from tpu_pillars_torch.utils.viz import save_png

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_visualize

    points = golden_clouds(golden)[0]
    boxes, cls, _ = torch_visualize.predict_boxes(det, points)
    img = torch_visualize.render(points, cfg,
                                 packed_to_boxes(golden["packed"][0], cfg),
                                 boxes, cls, size=1000)
    path = os.path.join(tmp, "golden0.png")
    save_png(path, img)
    back = torch_visualize.read_png(path)
    if back.shape != (1000, 1000, 3) or not np.array_equal(back, img):
        fail(f"the PNG read back as {back.shape}, not the rendered image")
    print(f"visualisation: golden scene 0, {len(points)} points, "
          f"{len(boxes)} boxes, {os.path.getsize(path)} bytes of PNG read "
          f"back as {back.shape}")


def _serving_launches(where):
    """The serving path's K1-K4 launch counts since the last reset; fails
    when one did not launch."""
    from tpu_pillars_torch import _build

    launches = {k: _build.LAUNCHES[k]
                for k in ("emit", "fused_pfn", "bev_scatter", "nms_overlap")}
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} did not launch on {where}")
    return launches


def wire_phase(cfg, clouds):
    """3g (a): the batch of 8 lidar-like sweeps through the f32, f16 and
    int16 wires. K1-K4 must launch for each. Each 2-byte wire must change
    nothing but the quantization: its packed detections equal, bit for
    bit, the f32 wire's on the dequantized points (f16 cast to f32; int16
    times the scales, the JAX formula, on the host). Prints against the
    f32 wire the f16 class logits' median |d| and share above 0.1
    (tests/test_wire_f16.py's measures) and the int16 boxes' deviations
    (tests/test_detector_e2e.py::test_int16_wire_near_exact's), the bytes
    uploaded a batch and a host-clock split (pad, upload, device,
    download, total; median of 5 after a warm-up)."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.detector import (
        Detector, int16_wire_scales, packed_to_boxes,
    )

    dtypes = dict(zip(WIRE_NAMES, (torch.float32, torch.float16,
                                   torch.int16)))
    launches, boxes, logits, hosts, packs = {}, {}, {}, {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    for name, dtype in dtypes.items():
        det = Detector.from_checkpoint(cfg, CKPT, wire_dtype=dtype)
        split = {k: [] for k in ("pad_ms", "upload_ms", "device_ms",
                                 "download_ms", "total_ms")}
        for rep in range(6):
            if rep == 5:
                _build.reset_launches()
            t_all = time.perf_counter()
            padded, t_pad = timed(lambda: [det.pad_points(c)
                                           for c in clouds])
            host = np.stack([p for p, _ in padded])
            n_b = np.asarray([n for _, n in padded], np.int32)
            (pts, cnt), t_up = timed(lambda: (det.upload(host),
                                              det.upload(n_b)))
            packed, t_dev = timed(lambda: det.predict_packed_batch(pts, cnt))
            out, t_down = timed(lambda: packed.cpu().numpy())
            total = (time.perf_counter() - t_all) * 1e3
            for key, v in zip(split, (t_pad, t_up, t_dev, t_down, total)):
                split[key].append(v)
        launches[name] = _serving_launches(f"the {name} wire")
        if pts.dtype != dtype:
            fail(f"the {name} wire uploaded {pts.dtype}")
        med = {k: round(float(np.median(v[1:])), 4) for k, v in split.items()}
        print(f"wire {name}: {host.nbytes + n_b.nbytes} bytes uploaded a "
              f"batch of {len(clouds)}; split (host clock, ms) "
              f"{json.dumps(med)}; {len(clouds) / med['total_ms'] * 1e3:.2f} "
              f"sweeps/s; launches {launches[name]}")
        boxes[name] = [packed_to_boxes(o, cfg) for o in out]
        hosts[name], packs[name] = (host, n_b), out
        if name != "int16":
            with torch.no_grad():
                logits[name] = det.wire(det.canvas(det.dequant(pts), cnt))[0]
        if name == "f32":
            det32 = det
        del det, pts, packed

    # the 2-byte wires against the f32 wire on their own dequantized points
    scales = int16_wire_scales(cfg)
    for name, deq in (("f16", lambda h: h.astype(np.float32)),
                      ("int16", lambda h: h.astype(np.float32) * scales)):
        host, n_b = hosts[name]
        want = det32.predict_packed_batch(deq(host), n_b).cpu().numpy()
        if not np.array_equal(packs[name], want):
            fail(f"the {name} wire's detections differ from the f32 wire's "
                 f"on its dequantized points")
    print("f16 and int16 wires: detections bit-equal to the f32 wire's on "
          "their dequantized points")
    del det32, hosts
    torch.cuda.empty_cache()

    dc = (logits["f32"] - logits["f16"]).abs().flatten()
    print(f"f16 wire against f32: class logits median |d| "
          f"{float(dc.median()):.3e}, share above 0.1 "
          f"{float((dc > 0.1).float().mean()):.3e} (tests/test_wire_f16.py "
          f"at its tiny config: < 1e-3, < 5e-2)")
    worst, n_same, off = np.zeros(4), 0, 0
    for g_all, r_all in zip(boxes["int16"], boxes["f32"]):
        off += abs(len(g_all) - len(r_all))
        for g, r in zip(g_all, r_all):
            dyaw = abs((g.yaw - r.yaw + math.pi) % (2 * math.pi) - math.pi)
            dev = (abs(g.score - r.score),
                   float(np.abs(np.asarray(g.center) - r.center).max()),
                   float(np.abs(np.asarray(g.wlh) - r.wlh).max()), dyaw)
            n_same += (g.label == r.label and dev[0] <= 2e-3
                       and max(dev[1:]) <= 2e-2)
            worst = np.maximum(worst, dev)
    n32 = sum(len(b) for b in boxes["f32"])
    print(f"int16 wire against f32: {n_same} of {n32} boxes within tests/"
          f"test_detector_e2e.py's int16 tolerance (score 2e-3, centre, "
          f"size, yaw 2e-2), box counts off by {off}; worst |d score| "
          f"{worst[0]:.3e}, |d centre| {worst[1]:.3e} m, |d size| "
          f"{worst[2]:.3e} m, |d yaw| {worst[3]:.3e} rad")
    del logits
    return launches


def golden_clouds(golden):
    offs = golden["offsets"]
    return [golden["points"][offs[s]:offs[s + 1]]
            for s in range(len(offs) - 1)]


def same_boxes(a, b):
    """Two lists of Box3D equal bit for bit."""
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x.to_array(), y.to_array()) and x.label == y.label
        and x.score == y.score for x, y in zip(a, b))


def stream_phase(det, golden):
    """3g (b): ``predict_stream`` on the 8 golden scenes, threaded and
    serial, must give ``predict``'s boxes bit for bit, in order; sweeps/s
    of each beside a serial ``predict`` loop (best of 3 passes)."""
    import torch

    from tpu_pillars_torch import _build

    scenes = golden_clouds(golden)
    want = [det.predict(c) for c in scenes]
    runs = {"predict loop": lambda: [det.predict(c) for c in scenes],
            "predict_stream threaded": lambda: list(
                det.predict_stream(iter(scenes))),
            "predict_stream serial": lambda: list(
                det.predict_stream(iter(scenes), threaded=False))}
    rates = {}
    _build.reset_launches()
    for name, fn in runs.items():
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn()
            best = min(best, time.perf_counter() - t)
            if not all(same_boxes(g, w) for g, w in zip(got, want)) or \
                    len(got) != len(want):
                fail(f"{name} differs from predict on the golden scenes")
        rates[name] = len(scenes) / best
    launches = _serving_launches("predict_stream")
    print(f"predict_stream on the {len(scenes)} golden scenes (boxes equal "
          f"predict's, bit for bit): " + ", ".join(
              f"{k} {v:.2f} sweeps/s" for k, v in rates.items()))
    return launches


REF_SCENES = 2           # golden scenes the CPU reference runs (host time)
SERVER_BURSTS = 3        # bursts of the 8 golden scenes sent to the server


def reference_phase(cfg, det, golden):
    """3g (c): ``Detector.from_torch`` of the trained checkpoint in the
    reference's torch layout (``reference_cpu.convert.flax_to_torch``) must
    serve the 8 golden scenes bit-equal to ``from_checkpoint``; the port's
    ``CPUReferenceDetector`` on 2 golden scenes must match the golden JAX
    detections and the card's boxes (:func:`check_boxes`). Prints the
    reference's sweeps/s on the host (its torch thread count pinned), the
    card's batch-8 sweeps/s on the 8 golden scenes (numpy clouds to host
    boxes) and their ratio."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.detector import Detector, packed_to_boxes
    from tpu_pillars_torch.reference_cpu import CPUReferenceDetector
    from tpu_pillars_torch.reference_cpu.convert import flax_to_torch
    from tpu_pillars_torch.weights import load_flax_msgpack

    tree = load_flax_msgpack(CKPT)
    sd = flax_to_torch({"params": tree["params"],
                        "batch_stats": tree["batch_stats"]}, cfg)
    scenes = golden_clouds(golden)
    _build.reset_launches()
    migrated = Detector.from_torch(cfg, sd)
    for s, c in enumerate(scenes):
        if not torch.equal(migrated.predict_packed(c), det.predict_packed(c)):
            fail(f"Detector.from_torch differs from from_checkpoint on "
                 f"golden scene {s}")
    launches = _serving_launches("Detector.from_torch")
    del migrated
    print(f"Detector.from_torch (reference torch layout): the {len(scenes)} "
          f"golden scenes equal from_checkpoint's bit for bit")

    threads = torch.get_num_threads()
    n_threads = min(8, os.cpu_count() or 1)
    torch.set_num_threads(n_threads)
    try:
        ref = CPUReferenceDetector(cfg, sd)
        ref.predict(scenes[0][:100])                    # warm-up
        times = []
        for s in range(REF_SCENES):
            t = time.perf_counter()
            got = ref.predict(scenes[s])
            times.append(time.perf_counter() - t)
            want = packed_to_boxes(golden["packed"][s], cfg)
            check_boxes(got, want, f"{s} (CPU reference)")
            check_boxes(got, det.predict(scenes[s]),
                        f"{s} (CPU reference against the card)")
    finally:
        torch.set_num_threads(threads)
    ref_sps = REF_SCENES / sum(times)

    def card_batch():
        pads = [det.pad_points(c) for c in scenes]
        out = det.predict_packed_batch(np.stack([p for p, _ in pads]),
                                       np.asarray([n for _, n in pads],
                                                  np.int32))
        return out.cpu().numpy()

    card_batch()
    runs = []
    for _ in range(5):
        t = time.perf_counter()
        card_batch()
        runs.append(time.perf_counter() - t)
    card_sps = len(scenes) / float(np.median(runs))
    print(f"CPU reference ({n_threads} torch threads, {os.cpu_count()} "
          f"cores): {ref_sps:.3f} sweeps/s ({1 / ref_sps:.3f} s a sweep, "
          f"{REF_SCENES} golden scenes, boxes match the JAX golden "
          f"detections and the card's); the card at batch {BATCH} on the "
          f"golden scenes: {card_sps:.2f} sweeps/s; ratio "
          f"{card_sps / ref_sps:.1f}x")
    return launches


def served(boxes):
    """Boxes as the server writes them: float() of each f32 value."""
    return [{"center": [float(v) for v in b.center],
             "wlh": [float(v) for v in b.wlh], "yaw": float(b.yaw),
             "label": b.label, "score": float(b.score)} for b in boxes]


def server_phase(cfg, det, golden, proc):
    """3g (d): the server started by :func:`serving_surface`
    (``python -m tpu_pillars_torch.serve --full-size --batch-size 8``) gets
    the 8 golden scenes from 8 threads as binary ``/predict`` requests, in
    ``SERVER_BURSTS`` bursts.
    Each response must equal, exactly, the boxes of the call it rode
    (``predict`` alone, or ``serve.predict_batch`` at batch 8) and the
    golden JAX detections within :func:`check_boxes`; one response at
    least must be batched; ``/healthz`` must name the card. Prints the
    start-up, the latencies (p50, max) and the requests/s."""
    import select
    import threading
    import urllib.request

    import numpy as np
    import torch

    from tpu_pillars_torch.detector import packed_to_boxes
    from tpu_pillars_torch.geometry.boxes import Box3D
    from tpu_pillars_torch.serve import predict_batch

    ready, _, _ = select.select([proc.stdout], [], [], 300)
    line = proc.stdout.readline() if ready else ""
    if "serving on http://" not in line:
        proc.kill()
        fail(f"the server did not start: {line!r} "
             f"{proc.communicate(timeout=60)[1][-3000:]}")
    url = line.split()[2]
    print(f"server: {line.strip()}")
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    if health.get("device") != torch.cuda.get_device_name(0):
        fail(f"/healthz does not name the card: {health}")

    scenes = golden_clouds(golden)
    lat, batched, wall = [], [], 0.0
    for _ in range(SERVER_BURSTS):
        results, times = [None] * len(scenes), [0.0] * len(scenes)
        start = threading.Barrier(len(scenes))

        def fire(i):
            pts = np.ascontiguousarray(scenes[i], np.float32)
            req = urllib.request.Request(
                url + "/predict", data=pts.tobytes(), method="POST",
                headers={"Content-Type": "application/octet-stream",
                         "X-Point-Count": str(len(pts))})
            start.wait(timeout=60)
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = json.loads(r.read())
            times[i] = (time.perf_counter() - t) * 1e3

        t0 = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(scenes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall += time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or None in results:
            fail("a request to the server got no answer")
        for s, r in enumerate(results):
            exact = (det.predict(scenes[s]) if r["batched"] == 1 else
                     predict_batch(det, [scenes[s]], BATCH)[0])
            if r["boxes"] != served(exact):
                fail(f"server, golden scene {s}: the boxes differ from the "
                     f"{'single' if r['batched'] == 1 else 'batch'} call's")
            got = [Box3D(np.asarray(b["center"]), np.asarray(b["wlh"]),
                         b["yaw"], label=b["label"], score=b["score"])
                   for b in r["boxes"]]
            check_boxes(got, packed_to_boxes(golden["packed"][s], cfg),
                        f"{s} (server)")
        lat += times
        batched.append([r["batched"] for r in results])
    if max(max(b) for b in batched) < 2:
        fail(f"the server batched no request: {batched}")
    n = SERVER_BURSTS * len(scenes)
    print(f"server: {SERVER_BURSTS} bursts of {len(scenes)} concurrent "
          f"requests, batched {batched}, boxes equal the calls they rode and "
          f"the golden JAX detections; latency p50 "
          f"{float(np.median(lat)):.1f} ms, max {max(lat):.1f} ms; "
          f"{n / wall:.2f} requests/s")
    return {"batched": batched}


def multisweep_phase(cfg):
    """3g (e): a 3-sweep Lyft-format fixture at the density of
    scripts/rehearsal_dataset.py; a ``SweepAccumulator`` fed its sweeps in
    time order must equal ``load_sweeps`` bit for bit on every keyframe;
    the accumulated clouds served at ``num_sweeps=3`` by a seeded random
    model's checkpoint (the port's ``train.checkpoint``) launch K1-K4 and
    give the same boxes twice."""
    import dataclasses
    import tempfile

    import numpy as np

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.data.fixture import build_fixture
    from tpu_pillars_torch.data.lyft import LyftDataset
    from tpu_pillars_torch.data.stream import SweepAccumulator
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.train.checkpoint import save_checkpoint
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    ms = dataclasses.replace(cfg, num_sweeps=3)
    with tempfile.TemporaryDirectory() as tmp:
        ds = LyftDataset(build_fixture(
            os.path.join(tmp, "lyft"), ms, num_scenes=1, samples_per_scene=3,
            sweeps_per_sample=3, seed=SEED, num_objects=25,
            points_per_object=300, clutter=25_000))
        acc = SweepAccumulator(3)
        clouds = []
        for sd in sorted(ds.tables["sample_data"].values(),
                         key=lambda r: r["timestamp"]):
            cloud = acc.push(ds.load_point_cloud(sd), ds.lidar_to_global(sd),
                             sd["timestamp"])
            if sd.get("is_key_frame"):
                if not np.array_equal(
                        cloud, ds.load_sweeps(sd["sample_token"], 3)):
                    fail("SweepAccumulator differs from load_sweeps on a "
                         "keyframe")
                clouds.append(cloud[:, [0, 1, 2, 3, 5]])  # drop the ring
        if len(clouds) != 3:
            fail(f"the fixture gave {len(clouds)} keyframes, not 3")
        path = os.path.join(tmp, "ms.msgpack")
        save_checkpoint(path, create_train_state(
            ms, TrainConfig(batch_size=1), seed=SEED), config=ms)
        det = Detector.from_checkpoint(ms, path)
    _build.reset_launches()
    first = [det.predict(c) for c in clouds]
    launches = _serving_launches("the multi-sweep stream")
    if not all(same_boxes(a, det.predict(c)) for a, c in zip(first, clouds)):
        fail("the multi-sweep stream's boxes differ between two predicts")
    print(f"multi-sweep stream: SweepAccumulator equals load_sweeps on 3 "
          f"keyframes ({', '.join(str(len(c)) for c in clouds)} points), "
          f"served at num_sweeps=3: {[len(b) for b in first]} boxes, the "
          f"same twice; launches {launches}")
    return launches


def anchor_major_serving(cfg, points, counts, golden):
    """Phase 3f: the anchor-major API on the trained checkpoint. The golden
    scenes through ``make_eval_forward`` + ``postprocess`` must match the
    JAX detections (``golden_check``); on the serving batch,
    ``postprocess_t`` must equal ``postprocess`` bit for bit and
    ``nms_impl="fixpoint"`` keep the same detections as "pallas" (K4);
    K1, K3 and K4 must launch, K2 and K6 not. Returns the launches of the
    batch call."""
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.detector import Detector

    det = Detector.from_checkpoint(cfg, CKPT, fused_frontend=False,
                                   use_pallas_pfn=False)
    am = AnchorMajorDetector(det)
    golden_check(am, golden, "anchor-major, classic")
    _build.reset_launches()
    out = am.outputs(points, counts)
    dets = am.detections(out)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the anchor-major path (batch {BATCH}): {launches}")
    for name in ("emit", "bev_scatter", "nms_overlap"):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch on the anchor-major path")
    for name in ("fused_pfn", "pfn"):
        if launches[name]:
            fail(f"kernel {name} launched on the anchor-major path")
    if int(dets.valid.sum()) == 0:
        fail("the anchor-major batch call detected nothing")
    for label, other in (
            ("postprocess_t", am.detections(out, layout="feature")),
            ("nms_impl='fixpoint'", am.detections(out, "fixpoint"))):
        for field, a, b in zip(dets._fields, dets, other):
            if not torch.equal(a, b):
                fail(f"anchor-major {label} differs from postprocess with "
                     f"K4 in {field}")
    print(f"anchor-major batch: {int(dets.valid.sum())} detections; "
          f"postprocess_t and nms_impl='fixpoint' equal postprocess (K4) "
          f"bit for bit")
    fwd_ms = cuda_ms(lambda: am.outputs(points, counts), 5)
    post_ms = {impl: cuda_ms(lambda: am.detections(out, impl), 5)
               for impl in ("pallas", "fixpoint")}
    print(f"anchor-major timings (CUDA events, batch {BATCH}): eval forward "
          f"{fwd_ms:.3f} ms, postprocess with K4 {post_ms['pallas']:.3f} ms, "
          f"with the fixpoint {post_ms['fixpoint']:.3f} ms")

    del det, am, out, dets
    torch.cuda.empty_cache()
    return launches


def classic_training(cfg, dev):
    """Phase 4e: classic training at the full config, batch 8 — the golden
    steps on the classic front end with the dense assigner's targets held
    to the JAX ones, then ``fit`` timed with the dense, the banded
    (``train.step.BAND_CELLS``) and the K5 assigner (f32, remat "all"),
    remat "off" and bf16 (K5). Returns the launches of the f32 remat-"all"
    K5 run."""
    import torch

    from tpu_pillars_torch.train.loop import synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig
    from tpu_pillars_torch.train.step import batch_to_device, make_assigner

    train_golden(cfg, dev, classic=True)
    # the two assigners alone on the timed runs' first batch: time, the
    # transient memory above what is allocated, and how far apart
    batch = batch_to_device(next(synthetic_batches(
        cfg, TrainConfig(batch_size=BATCH), seed=SEED)), dev)
    gt = (batch.gt_boxes, batch.gt_classes, batch.gt_valid)
    targets = {}
    for name in ("dense", "windowed"):
        assign = make_assigner(cfg, name)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        targets[name] = assign(*gt)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = cuda_ms(lambda: assign(*gt), 3, reps=3)
        print(f"assigner {name} (batch {BATCH}, {int(batch.gt_valid.sum())} "
              f"valid GT): {ms:.3f} ms (CUDA events, median of 3 x 3), "
              f"{peak:.2f} GiB transient")
    pos = [t.reg_weights > 0 for t in targets.values()]
    flips = int((pos[0] != pos[1]).sum())
    if flips > 1e-3 * pos[0].numel():
        fail(f"dense and K5 positives differ on {flips} anchors")
    print(f"assigners: {int(pos[0].sum())} dense and {int(pos[1].sum())} K5 "
          f"positives, {flips} of {pos[0].numel()} anchors differ")
    del batch, gt, targets, pos
    torch.cuda.empty_cache()
    runs = {}
    for key, remat, dtype, assigner in (
            ("dense", "all", None, "dense"),
            ("banded", "all", None, "banded"),
            ("k5", "all", None, "windowed"),
            ("off", "off", None, "windowed"),
            ("bf16", "all", torch.bfloat16, "windowed")):
        runs[key], _ = train_fit(cfg, dev, remat, dtype=dtype, classic=True,
                                 assigner=assigner)
    return runs["k5"]


def bf16_scatter_row(cfg, name, rows_in, pid, mask, canvas32):
    """K3's instance ``name`` (rows_in's dtype -> a bf16 canvas) at the
    serving shapes: bit-equal to its plain version and to ``index_copy_``
    of the rows cast to bf16 into a zeroed bf16 canvas; from f32 rows also
    to the f32 canvas cast to bf16. Returns its row of the kernels line."""
    import torch

    from tpu_pillars_torch.ops import bev

    bf16, i16 = torch.bfloat16, torch.int16
    args = (rows_in, pid, mask, cfg, bf16)
    got = bev.scatter_to_bev(*args)
    want = bev.scatter_to_bev_plain(*args)
    if got.dtype != bf16 or not torch.equal(got.view(i16), want.view(i16)):
        fail(f"K3 {name} differs from its plain version")
    if rows_in.dtype == torch.float32 and not torch.equal(
            got.view(i16), canvas32.to(bf16).view(i16)):
        fail(f"K3 {name} differs from the f32 canvas cast to bf16")
    hw = cfg.grid_h * cfg.grid_w
    library = index_copy_scatter(rows_in.to(bf16), pid, mask, hw)
    if not torch.equal(library().reshape(got.shape).view(i16),
                       got.view(i16)):
        fail(f"K3 {name}: index_copy_ differs from the kernel")
    B, P, C = rows_in.shape
    n_pillars = int(mask.sum())
    row = dict(
        err=0.0, ms=cuda_ms(lambda: bev.scatter_to_bev(*args), 20),
        plain_ms=cuda_ms(lambda: bev.scatter_to_bev_plain(*args), 5),
        library_ms=cuda_ms(library, 20),
        # the kept rows read once, ids and mask, the bf16 canvas written
        bound=bound(n_pillars * C * rows_in.element_size() + B * P * 5
                    + got.numel() * 2, 0.0))
    also = (" and to the f32 canvas cast to bf16"
            if rows_in.dtype == torch.float32 else "")
    print(f"K3 {name}: bit-equal to its plain version and to index_copy_"
          f"{also}; {row['ms']:.4f} ms (bound {row['bound'][0]:.4f}); index_copy_ "
          f"into a zeroed bf16 canvas {row['library_ms']:.4f} ms")
    return row


def wire_gap(got, want):
    """The reference's bf16 measure of two wires (tests/test_bf16.py):
    median |d| of the class logits, 99th percentile of the box |d|."""
    import numpy as np

    dc = (got[0] - want[0]).abs().flatten().cpu().numpy()
    db = (got[1] - want[1]).abs().flatten().cpu().numpy()
    return float(np.median(dc)), float(np.quantile(db, 0.99))


def bf16_serving(cfg, points, counts, clouds):
    """Phase 3e: ``Detector(dtype=torch.bfloat16)`` on the trained
    checkpoint, fused front end, the serving batch: K1, K2, K3's f32 ->
    bf16 instance and K4 launch (the f32 instance does not); finite
    detections; its wire against the f32 detector's within the reference's
    bf16 tolerance (class-logit median |d| < 0.02, box |d| 99th percentile
    < 0.1); the stage split in f32 and in bf16, back to back; one classic
    batch with the plain PillarFeatureNet in bf16 (K3's bf16 -> bf16
    instance), held to the same tolerance against its f32 twin. Returns
    the f32 -> bf16 instance's launches on the serving batch."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.detector import Detector

    bf16 = torch.bfloat16
    det32 = Detector.from_checkpoint(cfg, CKPT)
    det16 = Detector.from_checkpoint(cfg, CKPT, dtype=bf16)
    _build.reset_launches()
    out = det16.predict_packed_batch(points, counts)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the bf16 serving path: {launches}")
    for name in ("emit", "fused_pfn", "bev_scatter_f32_bf16", "nms_overlap"):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch on the bf16 serving path")
    if launches["bev_scatter"]:
        fail("K3's f32 instance launched on the bf16 serving path")
    out = out.cpu().numpy()
    if out.shape != (BATCH, cfg.max_detections, 10) or \
            not np.isfinite(out).all() or out[..., 9].sum() == 0:
        fail(f"the bf16 batch call gave no finite detections {out.shape}")
    with torch.no_grad():
        if det16.canvas(points, counts).dtype != bf16:
            fail("the bf16 detector's canvas is not bf16")
        gap = wire_gap(det16._stage1(points, counts),
                       det32._stage1(points, counts))
    print(f"bf16 wire against the f32 wire (fused, batch {BATCH}): class "
          f"logit median |d| {gap[0]:.3e} (limit 0.02), box |d| 99th "
          f"percentile {gap[1]:.3e} (limit 0.1); "
          f"{int(out[..., 9].sum())} detections")
    if not (gap[0] < 0.02 and gap[1] < 0.1):
        fail(f"the bf16 wire is off the f32 wire by {gap}")
    stage_split(det32, points, counts, clouds, "fused front end, f32")
    stage_split(det16, points, counts, clouds,
                "fused front end, bf16 canvas, RPN and head")
    # the RPN and head alone: CUDA events over back-to-back calls (the
    # host's launches included) and the profiler's kernel time (the card
    # alone)
    with torch.no_grad():
        for label, det in (("f32", det32), ("bf16", det16)):
            canvas = det.canvas(points, counts)
            ev = cuda_ms(lambda: det.wire(canvas), 5)
            dev_ms = device_ms(lambda: det.wire(canvas))
            print(f"RPN + head ({label}), batch {BATCH}: {ev:.3f} ms "
                  f"(CUDA events, median of 5 runs of 5 calls), "
                  f"{dev_ms:.3f} ms of kernels (profiler)")
    del det32, det16, canvas
    torch.cuda.empty_cache()

    plain32 = Detector.from_checkpoint(cfg, CKPT, use_pallas_pfn=False)
    plain16 = Detector.from_checkpoint(cfg, CKPT, use_pallas_pfn=False,
                                       dtype=bf16)
    _build.reset_launches()
    out = plain16.predict_packed_batch(points, counts)
    torch.cuda.synchronize()
    classic = dict(_build.LAUNCHES)
    for name in ("emit", "bev_scatter_bf16", "nms_overlap"):
        if classic[name] == 0:
            fail(f"kernel {name} did not launch on the classic bf16 path")
    if classic["pfn"] or classic["fused_pfn"] or classic["bev_scatter"]:
        fail(f"the plain-PFN bf16 path launched {classic}")
    out = out.cpu().numpy()
    if not np.isfinite(out).all() or out[..., 9].sum() == 0:
        fail("the classic bf16 batch call gave no finite detections")
    with torch.no_grad():
        gap = wire_gap(plain16._stage1(points, counts),
                       plain32._stage1(points, counts))
    print(f"classic bf16 batch (plain PillarFeatureNet in bf16): launches "
          f"{classic}; wire against its f32 twin: class median |d| "
          f"{gap[0]:.3e}, box |d| 99th percentile {gap[1]:.3e}")
    if not (gap[0] < 0.02 and gap[1] < 0.1):
        fail(f"the classic bf16 wire is off the f32 wire by {gap}")
    stage_split(plain16, points, counts, clouds,
                "classic front end, plain PFN, all bf16")
    del plain32, plain16
    torch.cuda.empty_cache()
    return launches["bev_scatter_f32_bf16"]


def bf16_golden(cfg, dev):
    """Phase 4c's gate: three bf16 steps from the trained checkpoint on the
    golden batch, given the JAX targets, track the f32 steps (the golden
    JAX losses, which the f32 port reproduces at rtol 2e-3) at rtol 2e-2,
    the bound of tests/test_fused_train.py; the master state stays f32;
    the bf16 run's full checkpoint is served by an f32 ``Detector``."""
    import tempfile

    import numpy as np
    import torch

    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.train.checkpoint import save_checkpoint
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import make_train_step
    from tpu_pillars_torch.weights import load_flax_msgpack, params_from_flax

    g = np.load(TRAIN_GOLDEN)
    batch = golden_batch(g, cfg, dev)
    B = batch.points.shape[0]
    targets = golden_targets(g, cfg, dev)
    tree = load_flax_msgpack(CKPT)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    tcfg = TrainConfig(learning_rate=float(g["learning_rate"]),
                       total_steps=int(g["total_steps"]), batch_size=B,
                       compute_dtype="bfloat16")
    state = create_train_state(cfg, tcfg, state_dict=params_from_flax(
        variables, cfg))
    step = make_train_step(cfg, assigner=lambda *gt: targets,
                           compute_dtype=torch.bfloat16)
    worst = 0.0
    for i in range(len(g["losses"])):
        state, losses = step(state, batch)
        got = [float(x) for x in losses]
        want = g["losses"][i]
        rel = abs(got[0] - want[0]) / abs(want[0])
        worst = max(worst, rel)
        print(f"bf16 golden train step {i + 1}: loss {got[0]:.6f} (f32 "
              f"{want[0]:.6f}, relative {rel:.3e}), num_pos {got[4]:.0f} "
              f"({want[4]:.0f})")
        if not np.isfinite(got).all() or rel > 2e-2:
            fail(f"bf16 golden train step {i + 1}: loss {got[0]} vs f32 "
                 f"{want[0]} (rtol 2e-2)")
    masters = (list(state.model.state_dict().values())
               + state.optimizer.mu + state.optimizer.nu)
    if not all(t.dtype == torch.float32 for t in masters):
        fail("bf16 training left a master tensor that is not f32")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bf16.msgpack")
        save_checkpoint(path, state, config=cfg)
        det = Detector.from_checkpoint(cfg, path)
        out = det.predict_packed_batch(batch.points,
                                       batch.num_points).cpu().numpy()
        if det.dtype != torch.float32 or not np.isfinite(out).all():
            fail("an f32 Detector did not serve the bf16 run's checkpoint")
    print(f"bf16 golden training: 3 steps within {worst:.3e} of the f32 "
          f"losses (rtol 2e-2); {len(masters)} master tensors f32; the "
          f"checkpoint served in f32 ({int(out[..., 9].sum())} detections)")
    del state, det
    torch.cuda.empty_cache()


def lyft_run(cfg, card, bf16_step_ms):
    """Phase 4d, the JAX package's documented training run (docs/DATA.md)
    at full width in bf16 on a Lyft-format fixture of 20 samples at the
    density of scripts/rehearsal_dataset.py (25 objects x 300 points,
    25,000 clutter points): ``train.loop.main --data ... --full-size --bf16
    --gt-sample 8 --object-noise --cbgs 1.0 --workers 4 --val-samples 8
    --eval-every 6 --steps 6 --batch 8``, whose ``train.jsonl`` must hold
    finite losses and an mAP, with K1, K3's bf16 -> bf16 instance and K5
    launched; before it, the batches that command line streams
    (``train.loop.dataset_stream``: GT sampling 8 a class, object noise,
    CBGS, 4 workers) timed in ms per batch of 8."""
    import tempfile

    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.data.fixture import build_fixture
    from tpu_pillars_torch.train import loop
    from tpu_pillars_torch.train.state import TrainConfig

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        json_dir = build_fixture(os.path.join(tmp, "lyft"), cfg,
                                 num_scenes=4, samples_per_scene=5,
                                 sweeps_per_sample=1, seed=SEED,
                                 num_objects=25, points_per_object=300,
                                 clutter=25_000)
        argv = ["--data", json_dir, "--full-size", "--bf16", "--gt-sample",
                "8", "--object-noise", "--cbgs", "1.0", "--workers", "4",
                "--val-samples", "8", "--eval-every", "6", "--steps", "6",
                "--batch", str(BATCH), "--out", os.path.join(tmp, "run")]
        t0 = time.perf_counter()
        stream, _ = loop.dataset_stream(loop.parse_args(argv), cfg,
                                        TrainConfig(batch_size=BATCH))
        setup_ms = (time.perf_counter() - t0) * 1e3
        times, npts, ngt = [], [], []
        for _ in range(6):
            t0 = time.perf_counter()
            b = next(stream)
            times.append((time.perf_counter() - t0) * 1e3)
            npts.append(int(b[1].sum()))
            ngt.append(int(b[4].sum()))
        stream.close()
        loader_ms = float(np.median(times[1:]))
        print(f"loader (dataset_batches, GT sampling 8 a class, object "
              f"noise, CBGS, 4 workers): {loader_ms:.1f} ms a batch of "
              f"{BATCH} (median of 5 after the first, {times[0]:.1f} ms); "
              f"{np.mean(npts) / BATCH:.0f} points and "
              f"{np.mean(ngt) / BATCH:.1f} GT a sample; set-up (dataset "
              f"index, GT database, CBGS) {setup_ms:.0f} ms")

        _build.reset_launches()
        loop.main(argv)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        events = [json.loads(x)
                  for x in open(os.path.join(tmp, "run", "train.jsonl"))]
    steps = [e for e in events if e["event"] == "train_step"]
    evals = [e for e in events if e["event"] == "eval"]
    if not steps or not all(np.isfinite([e[k] for k in ("loss", "cls", "loc",
                                                        "dir")]).all()
                            for e in steps):
        fail(f"the Lyft run logged no finite losses: {steps}")
    if len(evals) != 1 or not np.isfinite(evals[0]["mAP"]):
        fail(f"the Lyft run logged no finite mAP: {evals}")
    for name in ("emit", "bev_scatter_bf16", "assign"):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch in the Lyft run")
    print(f"Lyft run ({card}): main --data --full-size --bf16 --gt-sample 8 "
          f"--object-noise --cbgs 1.0 --workers 4, 6 steps at batch "
          f"{BATCH}: loss {steps[-1]['loss']:.4f}, "
          f"{steps[-1]['steps_per_s']} steps/s (first step and loader "
          f"included), held-out mAP {evals[0]['mAP']:.6f} on 8 samples; "
          f"launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    verdict = ("the loader is slower, the card waits"
               if loader_ms > bf16_step_ms else "the loader keeps up")
    print(f"host against card: the loader takes {loader_ms:.1f} ms a batch "
          f"of {BATCH}, the bf16 step (remat all) {bf16_step_ms:.2f} ms: "
          f"{verdict} (ratio {loader_ms / bf16_step_ms:.2f})")


class EventList:
    """A ``fit`` logger that keeps its events."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append({"event": event, **fields})

    def losses(self):
        return [[e[k] for k in ("loss", "cls", "loc", "dir")]
                for e in self.events if e["event"] == "train_step"]


def resume_phase(cfg, card):
    """Phase 4b at batch 8, f32, remat "all", seed ``SEED``: ``fit`` 4
    steps unbroken; 2 steps stopped before the third (``preempted``), the
    full checkpoint restored into a fresh state (bit for bit), and the last
    2 steps on the rest of the stream (losses within rtol 2e-3 of the
    unbroken run's; K1, K3 and K5 launch); ``Detector.from_checkpoint`` on
    the full file and its ``.ema`` export; ``fit`` with an ``EmaTracker``
    and the synthetic eval hook (finite ``mAP`` and ``mAP_ema``) logging
    through a ``TeeLogger`` whose TensorBoard events read back. Times the
    checkpoint, the EMA update, the ``NaNGuard`` snapshot and the eval
    hook."""
    import itertools
    import tempfile

    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.data.synthetic import make_scene
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.evaluation.pipeline import evaluate_scenes
    from tpu_pillars_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )
    from tpu_pillars_torch.train.elastic import NaNGuard
    from tpu_pillars_torch.train.ema import EmaTracker
    from tpu_pillars_torch.train.loop import (
        fit, make_synthetic_eval_fn, synthetic_batches,
    )
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import make_train_step
    from tpu_pillars_torch.utils.logging import JsonlLogger
    from tpu_pillars_torch.utils.tensorboard import (
        TeeLogger, TensorBoardWriter, read_events,
    )

    t_phase = time.perf_counter()
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=4, batch_size=BATCH)
    step = make_train_step(cfg, remat="all")

    def stream():
        return synthetic_batches(cfg, tcfg, seed=SEED)

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    def tensors(st):
        opt = st.optimizer
        return (list(st.model.state_dict().items())
                + [(f"mu{i}", m) for i, m in enumerate(opt.mu)]
                + [(f"nu{i}", m) for i, m in enumerate(opt.nu)])

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt.msgpack")
        whole = EventList()
        fit(create_train_state(cfg, tcfg, seed=SEED), stream(), 4,
            step_fn=step, config=cfg, logger=whole, log_every=1)
        first = EventList()
        polls = itertools.count()
        killed = fit(create_train_state(cfg, tcfg, seed=SEED), stream(), 4,
                     step_fn=step, config=cfg, logger=first, log_every=1,
                     ckpt_path=ckpt, stop=lambda: next(polls) >= 2)
        if first.events[-1] != {"event": "preempted", "step": 2}:
            fail(f"the stopped run logged {first.events[-1]}, not "
                 f"'preempted' at step 2")
        restored = restore_checkpoint(
            ckpt, create_train_state(cfg, tcfg, seed=SEED + 1), config=cfg)
        # (a) the restored state is the saved one, on the card
        if (restored.step, restored.optimizer.count) != (2, 2):
            fail(f"restored step / count {restored.step} / "
                 f"{restored.optimizer.count}, not 2 / 2")
        for (name, a), (_, b) in zip(tensors(restored), tensors(killed)):
            if a.device.type != "cuda" or not torch.equal(a, b):
                fail(f"restored {name} differs from the saved state")
        mb = os.path.getsize(ckpt) / 1e6
        save_ms = host_ms(lambda: save_checkpoint(
            os.path.join(tmp, "timed.msgpack"), killed, config=cfg))
        template = create_train_state(cfg, tcfg, seed=SEED + 2)
        restore_ms = host_ms(lambda: restore_checkpoint(
            ckpt, template, config=cfg))
        guard = NaNGuard(None, config=cfg)
        guard_ms = host_ms(lambda: guard.observe(killed, 1.0))
        del killed, template, guard
        torch.cuda.empty_cache()

        # (b), (c): the last 2 steps from the restored state
        second = EventList()
        _build.reset_launches()
        restored = fit(restored, itertools.islice(stream(), 2, None), 2,
                       step_fn=step, config=cfg, logger=second, log_every=1)
        torch.cuda.synchronize()
        resumed = dict(_build.LAUNCHES)
        for name in ("emit", "bev_scatter", "assign"):
            if resumed[name] == 0:
                fail(f"kernel {name} did not launch in the resumed steps")
        got = np.asarray(first.losses() + second.losses())
        want = np.asarray(whole.losses())
        d = float(np.abs(got - want).max())
        print(f"resume: losses of the 4 steps, unbroken {want[:, 0]}, "
              f"stopped at 2 and resumed {got[:, 0]}; max |d| {d:.3e} "
              f"(total, cls, loc, dir), bit-equal {bool((got == want).all())}"
              f"; launches in the resumed steps {resumed}")
        if not np.isfinite(got).all() or not np.allclose(got, want,
                                                         rtol=2e-3, atol=0):
            fail(f"resumed losses {got.tolist()} vs unbroken "
                 f"{want.tolist()} (rtol 2e-3)")

        # (e), (f): EMA and the eval hook, logged through JSONL and
        # TensorBoard
        params = list(restored.model.parameters())
        timer = EmaTracker(params, decay=0.999)
        ema_ms = cuda_ms(lambda: timer.update(params), iters=10)
        del timer
        eval_fn = make_synthetic_eval_fn(cfg, num_scenes=8)
        eval_times = []

        def timed_eval(st):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = eval_fn(st)
            eval_times.append((time.perf_counter() - t) * 1e3)
            return out

        ema = EmaTracker(restored.model.parameters(), decay=0.999)
        tb_dir = os.path.join(tmp, "tb")
        jsonl = os.path.join(tmp, "train.jsonl")
        _build.reset_launches()
        with TeeLogger(JsonlLogger(jsonl), TensorBoardWriter(tb_dir)) as lg:
            restored = fit(restored, itertools.islice(stream(), 4, None), 4,
                           step_fn=step, config=cfg, logger=lg, log_every=1,
                           ckpt_path=ckpt, eval_fn=timed_eval, eval_every=2,
                           ema=ema)
            tb_path = lg.sinks[1].path
        torch.cuda.synchronize()
        with_eval = dict(_build.LAUNCHES)
        for name in ("emit", "fused_pfn", "bev_scatter", "nms_overlap",
                     "assign"):
            if with_eval[name] == 0:
                fail(f"kernel {name} did not launch in the EMA and eval run")
        evals = [json.loads(x) for x in open(jsonl)]
        evals = [e for e in evals if e["event"] == "eval"]
        if [e["step"] for e in evals] != [6, 8] or not all(
                np.isfinite([e["mAP"], e["mAP_ema"]]).all() for e in evals):
            fail(f"eval events {evals}: want finite mAP and mAP_ema at "
                 f"steps 6 and 8")
        tb = list(read_events(tb_path))
        tags = [t for e in tb for t in e["scalars"]]
        if tags.count("train_step/loss") != 4 or \
                tags.count("eval/mAP_ema") != 2:
            fail(f"TensorBoard events read back: {tags}")
        print(f"eval hook: {[round(e['mAP'], 6) for e in evals]} mAP, "
              f"{[round(e['mAP_ema'], 6) for e in evals]} mAP_ema at steps "
              f"6 and 8; {len(tb)} TensorBoard events read back; launches "
              f"in the run {with_eval}")

        # (d) both files served on the card
        ema_mb = os.path.getsize(ckpt + ".ema") / 1e6
        cloud = synthetic_batches(cfg, tcfg, seed=SEED + 3)
        points, num_points = next(cloud)[:2]
        for path in (ckpt, ckpt + ".ema"):
            det = Detector.from_checkpoint(cfg, path)
            out = det.predict_packed_batch(points, num_points).cpu().numpy()
            if det.device.type != "cuda" or not np.isfinite(out).all():
                fail(f"Detector.from_checkpoint({os.path.basename(path)}) "
                     f"gave no finite detections on the card")
            if path.endswith(".ema") and not all(
                    torch.equal(a, b)
                    for a, b in zip(det.model.parameters(), ema.params)):
                fail("the .ema file does not hold the EMA parameters")
        # the eval hook's time, split: the 8 single-sweep predicts (card)
        # and the rest (scoring on the host), on make_synthetic_eval_fn's
        # scenes with the EMA weights
        rng = np.random.default_rng(100_000)
        scenes = [make_scene(rng, cfg) for _ in range(8)]
        boxes = []
        predict_ms = host_ms(lambda: boxes.append(
            sum(len(det.predict(sc.points)) for sc in scenes)), reps=1)
        hook_ms = host_ms(lambda: evaluate_scenes(det, scenes), reps=1)
        del det
    print(f"resume phase ({card}): full checkpoint {mb:.3f} MB (its .ema "
          f"export {ema_mb:.3f} MB), save "
          f"{save_ms:.2f} ms, restore {restore_ms:.2f} ms (host clock, "
          f"synchronised, median of 3); EMA update {ema_ms:.4f} ms a step "
          f"(CUDA events); NaNGuard snapshot {guard_ms:.2f} ms (median of "
          f"3); eval hook, 8 scenes, raw / EMA: "
          f"{' / '.join(f'{t:.1f}' for t in eval_times)} ms (steps 6 and "
          f"8, the first call builds the Detector); the EMA file's "
          f"evaluate_scenes {hook_ms:.1f} ms, of which 8 predicts "
          f"{predict_ms:.1f} ms ({boxes[0]} boxes); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    del restored, ema
    torch.cuda.empty_cache()


def index_copy_scatter(feats, pid, mask, hw):
    """The yardstick of K3 and K9: one ``index_copy_`` of the valid pillar
    rows into a zeroed flat canvas of the rows' dtype (returns the call, to
    be timed)."""
    import torch

    B, _, C = feats.shape
    flat_idx = (pid.long() + torch.arange(B, device=feats.device)[:, None]
                * hw)[mask]
    src = feats[mask]
    return lambda: torch.zeros((B * hw, C), dtype=feats.dtype,
                               device=feats.device).index_copy_(
        0, flat_idx, src)


def classic_rows(cfg, points, counts, w_pfn, b_pfn, rows):
    """K6, K10, K8 and K9 against their plain versions on the classic front
    end's inputs of the serving batch; adds their rows."""
    import torch

    from tpu_pillars_torch.ops import bev, binning, emit, pfn, sort, voxelize

    B, M, F = points.shape
    C = cfg.pfn_channels
    H, W = cfg.grid_h, cfg.grid_w
    HW = H * W

    # K6 on the classic PillarBatch
    pb = emit.pillarize_batch_emit(points, counts, cfg)
    _, P, N, D = pb.features.shape
    args6 = (pb.features.reshape(B * P, N, D), pb.mask.reshape(B * P, N),
             w_pfn, b_pfn)
    feats = pfn.pfn_fused(*args6)
    feats_p = pfn.pfn_fused_plain(*args6)
    err6 = (feats - feats_p).abs().max().item()
    if not torch.allclose(feats, feats_p, atol=1e-5, rtol=1e-5):
        fail(f"K6 PFN differs from its plain version: max |d| {err6:.3e}")
    slots = int(pb.mask.sum())
    print(f"K6: {slots} valid slots of {B * P * N}, max |d| {err6:.3e}")
    rows["pfn"] = dict(
        err=err6, ms=cuda_ms(lambda: pfn.pfn_fused(*args6), 20),
        plain_ms=cuda_ms(lambda: pfn.pfn_fused_plain(*args6), 3),
        library_ms=None,
        bound=bound(args6[1].numel() + slots * D * 4
                    + (D + 1) * C * 4 + feats.numel() * 4,
                    2.0 * slots * D * C))
    del feats_p

    # K10 on the serving batch's pillar ids and points, with the key width
    # the main path gives it (ids in [0, H*W]: 18 bits) and with 32 bits
    pid = voxelize.pillar_ids(points, counts, cfg)
    bits = HW.bit_length()
    plain = sort.bitonic_sort_plain(pid, points)

    def library_sort():
        key, order = torch.sort(pid, dim=1, stable=True)
        return key, order, torch.gather(points, 1,
                                        order[..., None].expand(-1, -1, F))

    lib = library_sort()
    for key_bits in (bits, 32):
        got = sort.bitonic_sort(pid, points, key_bits=key_bits)
        for name, want in (("its plain network", plain),
                           ("the stable torch.sort", lib)):
            if not all(torch.equal(a, b.to(a.dtype))
                       for a, b in zip(got, want)):
                fail(f"K10 radix sort ({key_bits} bits) differs from {name}")
    print(f"K10: keys, order and payload bit-equal to the plain network and "
          f"to the stable torch.sort, with {bits} and 32 key bits")
    ms32 = cuda_ms(lambda: sort.bitonic_sort(pid, points), 20)
    rows["radix_sort"] = dict(
        err=0.0,
        ms=cuda_ms(lambda: sort.bitonic_sort(pid, points, key_bits=bits),
                   20),
        plain_ms=cuda_ms(lambda: sort.bitonic_sort_plain(pid, points), 3),
        library_ms=cuda_ms(library_sort, 20),
        bound=bound(B * M * (4 + 4 * F) * 2 + B * M * 4,
                    B * M * math.log2(M)))
    row = rows["radix_sort"]
    print(f"K10: {row['ms']:.4f} ms ({bits} bits), {ms32:.4f} ms (32 bits); "
          f"stable torch.sort + gather {row['library_ms']:.4f} ms; kernel / "
          f"call {row['ms'] / row['library_ms']:.3f}")
    del plain, lib

    # K8 on the serving batch's cells
    w_pad = binning.padded_width(cfg)
    r, c = binning.cell_rows_cols(points, counts, cfg)
    rank, hist = binning.rank_and_hist(r, c, H, w_pad)
    rank_p, hist_p = binning.rank_and_hist_plain(r, c, H, w_pad)
    if not (torch.equal(hist, hist_p) and torch.equal(rank, rank_p)):
        fail("K8 rank or histogram differs from its plain version")
    print(f"K8: rank and histogram equal to the plain version; "
          f"{int((rank_p >= 64).sum())} points at rank >= 64, "
          f"{int((hist_p > 0).sum())} occupied cells")
    rows["binning"] = dict(
        err=0.0, ms=cuda_ms(lambda: binning.rank_and_hist(r, c, H, w_pad),
                            20),
        plain_ms=cuda_ms(lambda: binning.rank_and_hist_plain(r, c, H, w_pad),
                         3),
        library_ms=None,
        bound=bound(B * M * 12 + hist.numel() * 4, 0.0))

    # K9 on K6's features of the classic batch
    feats = feats.reshape(B, P, C)
    pid9 = (pb.coords[..., 0] * W + pb.coords[..., 1]).to(torch.int32)
    mask9 = pb.pillar_mask
    canvas = bev.scatter_to_bev_emit(feats, pid9, mask9, cfg)
    if not torch.equal(canvas, bev.scatter_to_bev_emit_plain(feats, pid9,
                                                             mask9, cfg)):
        fail("K9 block gather differs from its plain version")
    if not torch.equal(bev.block_row_ranges(pid9, mask9, HW),
                       bev.block_row_ranges_plain(pid9, mask9, HW)):
        fail("K9's tile ranges differ from their plain version")
    if not torch.equal(canvas, bev.scatter_to_bev(feats, pid9, mask9, cfg)):
        fail("K9 block gather differs from K3's canvas")
    library_scatter = index_copy_scatter(feats, pid9, mask9, HW)
    if not torch.equal(library_scatter().reshape(canvas.shape), canvas):
        fail("K9 yardstick index_copy_ differs from the kernel")
    n_pillars = int(mask9.sum())
    print(f"K9: canvas bit-equal to its plain version and to K3's "
          f"({n_pillars} pillars)")
    rows["bev_gather"] = dict(
        err=0.0,
        ms=cuda_ms(lambda: bev.scatter_to_bev_emit(feats, pid9, mask9, cfg),
                   20),
        plain_ms=cuda_ms(lambda: bev.scatter_to_bev_emit_plain(
            feats, pid9, mask9, cfg), 5),
        library_ms=cuda_ms(library_scatter, 20),
        bound=bound(n_pillars * C * 4 + B * P * 5 + canvas.numel() * 4,
                    0.0))
    row = rows["bev_gather"]
    print(f"K9: {row['ms']:.4f} ms; index_copy_ into torch.zeros "
          f"{row['library_ms']:.4f} ms; kernel / call "
          f"{row['ms'] / row['library_ms']:.3f}")
    del pb, feats, canvas
    torch.cuda.empty_cache()


def drop_ins(cfg, det_c, points, counts, w_pfn, b_pfn):
    """The three drop-ins at full width on the serving batch, against the
    classic path: the radix sort (K10), the binned pillarizer (K8) and
    K6 then the block gather (K9). Returns their launches."""
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.ops import bev, binning, emit, pfn, sort, voxelize

    want_sort = voxelize.sort_points_by_pillar(points, counts, cfg)
    want_batch = emit.pillarize_batch_emit(points, counts, cfg)
    want_canvas = det_c.canvas(points, counts)
    torch.cuda.synchronize()

    _build.reset_launches()
    got_sort = sort.sort_points_by_pillar_bitonic(points, counts, cfg)
    batch = binning.pillarize_batch_binned(points, counts, cfg)
    B, P, N, D = batch.features.shape
    feats = pfn.pfn_fused(batch.features.reshape(B * P, N, D),
                          batch.mask.reshape(B * P, N), w_pfn, b_pfn)
    pid = (batch.coords[..., 0] * cfg.grid_w
           + batch.coords[..., 1]).to(torch.int32)
    canvas = bev.scatter_to_bev_emit(feats.reshape(B, P, -1), pid,
                                     batch.pillar_mask, cfg)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the drop-in path: {launches}")
    if not all(torch.equal(a, b) for a, b in zip(got_sort, want_sort)):
        fail("sort_points_by_pillar_bitonic differs from the stable sort")
    for name in batch._fields:
        if not torch.equal(getattr(batch, name), getattr(want_batch, name)):
            fail(f"pillarize_batch_binned differs from the classic "
                 f"PillarBatch in {name}")
    if not torch.equal(canvas, want_canvas):
        fail("K6 on the binned batch, then K9, differs from the classic "
             "canvas")
    for name in ("radix_sort", "binning", "bev_gather"):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch on the drop-in path")
    print("drop-ins: the radix sort equals the stable sort, the binned "
          "PillarBatch equals the classic one in every field, and K6 then "
          "K9 on it give the classic canvas bit for bit")
    return {k: launches[k] for k in ("radix_sort", "binning", "bev_gather")}


def stream_iou_drop_ins(cfg, det, points, counts, golden, cands):
    """K11 and K7 as drop-ins at full width: the stream front end through
    its user entry on the serving batch (against the fused canvas) and on
    every golden scene (then the detector's ``wire`` and ``postprocess``,
    against the JAX detections), and the tiled IoU on the batch's top-k
    candidates. Prints K11's time beside the fused front end's. Returns
    their launches."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.detector import pack_detections, packed_to_boxes
    from tpu_pillars_torch.ops import iou_tiled, stream_pfn

    w, b = det.model.pfn.folded()
    want = det.canvas(points, counts)
    torch.cuda.synchronize()
    _build.reset_launches()
    canvas = stream_pfn.points_to_canvas_stream(points, counts, w, b, cfg)
    offs = golden["offsets"]
    n_boxes, worst = 0, np.zeros(3)
    for s in range(len(offs) - 1):
        padded, n = det.pad_points(golden["points"][offs[s]:offs[s + 1]])
        c = stream_pfn.points_to_canvas_stream(
            torch.from_numpy(padded[None]).to(det.device),
            torch.tensor([int(n)], device=det.device), w, b, cfg)
        packed = pack_detections(det.postprocess(*det.wire(c)))[0]
        got = packed_to_boxes(packed.cpu().numpy(), cfg)
        worst = np.maximum(worst, check_boxes(
            got, packed_to_boxes(golden["packed"][s], cfg), s))
        n_boxes += len(got)
    iou_tiled.rotated_iou_bev_tiled(cands, cands)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the stream/IoU drop-in path: {launches}")
    for name in ("stream_pfn", "iou_tiled"):
        if launches[name] == 0:
            fail(f"kernel {name} did not launch on the drop-in path")
    if not torch.equal(canvas.ne(0).any(-1), want.ne(0).any(-1)):
        fail("the stream canvas's occupancy differs from the fused canvas")
    if not torch.allclose(canvas, want, atol=1e-4, rtol=1e-5):
        fail(f"the stream canvas differs from the fused canvas: max |d| "
             f"{(canvas - want).abs().max().item():.3e}")
    print(f"golden (stream front end): {len(offs) - 1} scenes, {n_boxes} "
          f"boxes match the JAX detections; worst |d score| {worst[0]:.3e}, "
          f"|d centre| {worst[1]:.3e} m, |d yaw| {worst[2]:.3e} rad")
    fused_ms = cuda_ms(lambda: det.canvas(points, counts), 10)
    stream_ms = cuda_ms(lambda: stream_pfn.points_to_canvas_stream(
        points, counts, w, b, cfg), 10)
    print(f"front end, batch {points.shape[0]}, points to canvas (CUDA "
          f"events, median): fused (sort, centre, K1, K2, K3) "
          f"{fused_ms:.4f} ms, stream (sort, centre, K11) "
          f"{stream_ms:.4f} ms")
    return {k: launches[k] for k in ("stream_pfn", "iou_tiled")}


def evaluation(cfg, golden):
    """The evaluation path on the card, fused front end, trained
    checkpoint: ``evaluate_scenes`` on the 8 held-out scenes (GT from the
    port's ``make_scene``, seed 7100, whose clouds must equal the golden
    file's) against the port's scorer on the golden JAX detections (within
    1e-3); ``predict_tta`` (4 flip views, WBF) against the golden JAX TTA
    detections (:func:`check_boxes`); ``evaluate_dataset`` on a Lyft-format
    fixture at the full config (8 samples, batch 8), whose boxes must equal
    ``Detector.predict``'s per sample within 1e-5. The second scorer,
    ``lyft_map_alt`` (another algorithmic shape of the same definition),
    must give the TTA detections the first scorer's mAP within 1e-9."""
    import tempfile

    import numpy as np
    import torch

    from tpu_pillars_torch.data.fixture import build_fixture
    from tpu_pillars_torch.data.lyft import LyftDataset
    from tpu_pillars_torch.data.synthetic import make_scene
    from tpu_pillars_torch.detector import Detector, packed_to_boxes
    from tpu_pillars_torch.evaluation.map_eval import EvalBox, lyft_map
    from tpu_pillars_torch.evaluation.map_eval_alt import lyft_map_alt
    from tpu_pillars_torch.evaluation.pipeline import (
        evaluate_dataset, evaluate_scenes,
    )
    from tpu_pillars_torch.evaluation.tta import MODES, predict_tta

    det = Detector.from_checkpoint(cfg, CKPT)
    rng = np.random.default_rng(HELDOUT_SEED)
    offs = golden["offsets"]
    scenes = [make_scene(rng, cfg) for _ in range(len(offs) - 1)]
    gt, pred = [], []
    for s, sc in enumerate(scenes):
        if not np.array_equal(sc.points,
                              golden["points"][offs[s]:offs[s + 1]]):
            fail(f"held-out scene {s} differs from the golden cloud")
        tok = f"scene{s}"
        gt += [EvalBox(tok, cfg.class_names[int(c)],
                       np.asarray(b, np.float64), -1.0)
               for b, c in zip(sc.gt_boxes, sc.gt_classes)]
        pred += [EvalBox.from_box3d(b) for b in packed_to_boxes(
            golden["packed"][s], cfg, token=tok)]
    m_card, _ = evaluate_scenes(det, scenes)
    m_jax, _ = lyft_map(gt, pred, cfg.class_names)
    print(f"held-out mAP, {len(scenes)} scenes (seed {HELDOUT_SEED}): on "
          f"the card {m_card:.6f}; the JAX golden "
          f"detections scored by the port {m_jax:.6f}; JAX evaluate_scenes "
          f"(CPU, golden file) {float(golden['map_heldout']):.6f}; TPU "
          f"record 0.5154 (BENCH_r05.json: history, not the port's number)")
    if abs(m_card - m_jax) > 1e-3:
        fail(f"held-out mAP {m_card:.6f} on the card vs {m_jax:.6f} from "
             f"the JAX detections (limit 1e-3)")

    pred_tta, n_boxes, worst = [], 0, np.zeros(3)
    for s, sc in enumerate(scenes):
        got = predict_tta(det, sc.points, modes=MODES, merge="wbf",
                          token=f"scene{s}")
        want = packed_to_boxes(golden["tta_packed"][s], cfg)
        worst = np.maximum(worst, check_boxes(got, want, f"TTA {s}"))
        n_boxes += len(got)
        pred_tta += [EvalBox.from_box3d(b) for b in got]
    m_tta, _ = lyft_map(gt, pred_tta, cfg.class_names)
    m_alt, _ = lyft_map_alt(gt, pred_tta, cfg.class_names)
    if abs(m_tta - m_alt) > 1e-9:
        fail(f"the two scorers differ on the TTA detections: {m_tta:.12f} "
             f"vs {m_alt:.12f}")
    print(f"TTA (4 views, WBF): {n_boxes} boxes match the JAX TTA "
          f"detections; worst |d score| {worst[0]:.3e}, |d centre| "
          f"{worst[1]:.3e} m, |d yaw| {worst[2]:.3e} rad; held-out mAP "
          f"{m_tta:.6f} (the second scorer: {m_alt:.6f})")

    # phase 3e's accuracy: the same scenes served in bf16
    det16 = Detector.from_checkpoint(cfg, CKPT, dtype=torch.bfloat16)
    m16, _ = evaluate_scenes(det16, scenes)
    pred16 = []
    for s, sc in enumerate(scenes):
        pred16 += [EvalBox.from_box3d(b) for b in predict_tta(
            det16, sc.points, modes=MODES, merge="wbf", token=f"scene{s}")]
    m16_tta, _ = lyft_map(gt, pred16, cfg.class_names)
    print(f"bf16 serving: held-out mAP {m16:.6f} (f32 {m_card:.6f}), TTA "
          f"mAP {m16_tta:.6f} (f32 {m_tta:.6f}), {len(pred16)} TTA boxes")
    if not np.isfinite([m16, m16_tta]).all():
        fail(f"bf16 held-out mAP {m16} / TTA {m16_tta} not finite")
    del det16

    with tempfile.TemporaryDirectory() as root:
        ds = LyftDataset(build_fixture(root, cfg, num_scenes=2,
                                       samples_per_scene=4,
                                       sweeps_per_sample=1, seed=SEED))
        m_ds, _, preds = evaluate_dataset(det, ds, batch_size=BATCH)
        tokens = ds.sample_tokens()
        n_boxes = 0
        for tok in tokens:
            sd = ds.lidar_sample_data(tok)
            single = det.predict(
                ds.load_point_cloud(sd)[:, :cfg.num_raw_features],
                token=tok, lidar_to_global=ds.lidar_to_global(sd))
            batched = preds[tok]
            if len(single) != len(batched) or any(
                    a.label != b.label
                    or not np.allclose(a.to_array(), b.to_array(), rtol=0,
                                       atol=1e-5)
                    for a, b in zip(single, batched)):
                fail(f"evaluate_dataset's boxes for {tok} differ from "
                     f"Detector.predict's")
            n_boxes += len(batched)
    print(f"evaluate_dataset: {len(tokens)} fixture samples at batch "
          f"{BATCH}, {n_boxes} boxes equal to Detector.predict's per sample "
          f"(1e-5); mAP {m_ds:.6f}")


DP_RANKS = ("cuda:0", "cuda:0")   # two ranks share the one card: gloo
DP_STEPS = 3
DP_GATE = 2e-3                      # the golden training gate


def dp_rank(batches, clouds, sweeps):
    """Phase 6, in each rank of ``parallel.launch``: (a) data-parallel
    training from the seeded model, ``DP_STEPS`` fused f32 steps of the
    global batches and one classic step; (b) the spatial front end and
    detector over the ranks' row bands on ``sweeps["fits"]`` and the
    spatial front end on ``sweeps["wide"]``; (c) the data-parallel packed
    detector on the 8 ``clouds``; in rank 0 the one-device canvases and
    batch beside them. Returns, from rank 0, every rank's losses, step
    times, splits and launches (gathered), and rank 0's outputs."""
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.parallel import (
        make_dp_packed_detector, make_dp_train_step, make_mesh,
        make_spatial_detector_fn, make_spatial_frontend, split_points_by_slab,
    )
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    cfg = PillarsConfig()
    mesh = make_mesh()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    mine = {}
    for name, kw, steps in (("fused", {}, DP_STEPS),
                            ("classic", dict(fused_frontend=False), 1)):
        state = create_train_state(cfg, TrainConfig(batch_size=BATCH),
                                   seed=SEED, device=mesh.device)
        step = make_dp_train_step(cfg, mesh, **kw)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, ms = [], []
        for b in batches[:steps]:
            (state, loss), t = timed(lambda: step(state, b))
            losses.append([float(x) for x in loss])
            ms.append(t)
        launches = dict(_build.LAUNCHES)
        split = {}
        step(state, batches[0], split=split)
        mine[name] = dict(losses=losses, ms=ms, launches=launches,
                          split=split,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state, step
        torch.cuda.empty_cache()

    det = Detector.from_checkpoint(cfg, CKPT, device=mesh.device)
    bands, counts, info = split_points_by_slab(sweeps["fits"], cfg,
                                               mesh.size)
    wide = split_points_by_slab(sweeps["wide"], cfg, mesh.size)
    frontend = make_spatial_frontend(cfg, mesh)
    detect = make_spatial_detector_fn(cfg, mesh)
    frontend(det.model, bands, counts)          # warm-up
    _build.reset_launches()
    canvas, t_canvas = timed(lambda: frontend(det.model, bands, counts))
    packed, t_detect = timed(lambda: detect(det.model, bands, counts))
    mine["spatial"] = dict(launches=dict(_build.LAUNCHES),
                           ms=[t_canvas, t_detect])
    wide_canvas = frontend(det.model, wide[0], wide[1])

    padded = [det.pad_points(c) for c in clouds]
    points = np.stack([p for p, _ in padded])
    num = np.asarray([n for _, n in padded])
    dp_detect = make_dp_packed_detector(cfg, mesh)
    dp_detect(det.model, points, num)           # warm-up
    _build.reset_launches()
    dp_packed, t_dp = timed(lambda: dp_detect(det.model, points, num))
    mine["eval"] = dict(launches=dict(_build.LAUNCHES), ms=[t_dp])

    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, mine)
    if mesh.rank != 0:
        return None
    def one_canvas(d, cloud):
        pad, n = d.pad_points(cloud)
        return d.canvas(torch.from_numpy(pad[None]).to(mesh.device),
                        torch.tensor([int(n)], device=mesh.device))[0]

    def occupied(c):
        return int(c.ne(0).any(-1).sum())

    # one device with room for every band's budget, and at its own
    roomy = Detector(replace(cfg, max_pillars=mesh.size * cfg.max_pillars),
                     det.model.state_dict(), device=mesh.device)
    one_packed = det.predict_packed(sweeps["fits"])
    one_batch, t_one = timed(lambda: det.predict_packed_batch(points, num))
    return dict(
        ranks=ranks, backend=dist.get_backend(), info=info,
        canvas_equal=bool(torch.equal(canvas,
                                      one_canvas(det, sweeps["fits"]))),
        occupied=occupied(canvas),
        packed_equal=bool(torch.equal(packed, one_packed)),
        boxes=int(packed[:, 9].sum()), wide_info=wide[2],
        wide_equal=bool(torch.equal(wide_canvas,
                                    one_canvas(roomy, sweeps["wide"]))),
        wide_occupied=[occupied(wide_canvas),
                       occupied(one_canvas(det, sweeps["wide"]))],
        dp_packed=dp_packed.cpu().numpy(),
        one_batch=one_batch.cpu().numpy(), one_batch_ms=t_one)


def phase_6(cfg, clouds, dev):
    """6. Data parallel on one card: two ranks on ``cuda:0`` over gloo
    (``parallel.launch``; NCCL refuses two ranks on one device) at the
    full config. Training: ``DP_STEPS`` fused f32 data-parallel steps of
    global batch 8 (4 a rank) from the seeded model, and one classic step,
    held against the one-process step on the same batches in this process
    at the golden training gate (loss rtol 2e-3, num_pos equal). The
    spatial front end on lidar sweep 0: its canvas bit-identical to the
    one-device ``Detector``'s and its packed boxes equal. The data-parallel
    packed detector on the 8 sweeps against the ``Detector``'s batch at the
    golden tolerances. K1, K3 and K5 must launch in every rank's training,
    K1-K4 in every rank's spatial and DP detection. Prints step ms, the gradient all-reduce ms and launches for
    each rank. Returns each rank's launches over the phase."""
    import numpy as np
    import torch

    from tpu_pillars_torch.detector import packed_to_boxes
    from tpu_pillars_torch.parallel import launch
    from tpu_pillars_torch.train.loop import synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import batch_to_device, make_train_step

    stream = synthetic_batches(cfg, TrainConfig(batch_size=BATCH),
                               seed=SEED + 2)
    batches = [next(stream) for _ in range(DP_STEPS)]
    # lidar sweeps of 20,000 points (~10,200 pillars: one device holds
    # them) and 50,000 (~17,900: over one device's 12,000, under two bands')
    rng = np.random.default_rng(SEED + 6)
    sweeps = {k: lidar_batch(rng, cfg, 1, n)[0]
              for k, n in (("fits", 20_000), ("wide", 50_000))}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = launch(dp_rank, DP_RANKS, args=(batches, clouds, sweeps),
                 timeout=600)
    wall = time.perf_counter() - t0
    print(f"phase 6: {len(DP_RANKS)} ranks on {DP_RANKS[0]} over "
          f"{got['backend']}, launch to result {wall:.1f} s")

    for name, steps, kw in (("fused", DP_STEPS, {}),
                            ("classic", 1, dict(fused_frontend=False))):
        state = create_train_state(cfg, TrainConfig(batch_size=BATCH),
                                   seed=SEED, device=dev)
        step = make_train_step(cfg, **kw)
        want = []
        for b in batches[:steps]:
            state, loss = step(state, batch_to_device(b, dev))
            want.append([float(x) for x in loss])
        del state, step
        torch.cuda.empty_cache()
        for r, rank in enumerate(got["ranks"]):
            have = rank[name]["losses"]
            for i, (g, w) in enumerate(zip(have, want)):
                if not (np.isfinite(g).all() and g[4] == w[4]
                        and abs(g[0] - w[0]) <= DP_GATE * abs(w[0])):
                    fail(f"DP {name} step {i} on rank {r}: losses {g} "
                         f"against the one-process step's {w}")
            for k in ("emit", "bev_scatter", "assign"):
                if rank[name]["launches"][k] == 0:
                    fail(f"kernel {k} did not launch in rank {r}'s DP "
                         f"{name} training")
            print(f"DP {name} training, rank {r}: step ms "
                  f"{[round(t, 2) for t in rank[name]['ms']]}, split "
                  f"{json.dumps(rank[name]['split'])}, peak "
                  f"{rank[name]['peak_gib']:.2f} GiB, launches "
                  f"{rank[name]['launches']}")
        print(f"DP {name} training: losses {got['ranks'][0][name]['losses']}"
              f" match the one-process steps' {want} (rtol {DP_GATE}, "
              f"num_pos equal)")

    if got["info"]["dropped_capacity"] or not got["canvas_equal"]:
        fail(f"spatial canvas differs from one device's ({got['info']})")
    if not got["packed_equal"] or got["boxes"] == 0:
        fail(f"spatial boxes ({got['boxes']}) differ from one device's")
    print(f"spatial front end, 20,000-point sweep: canvas bit-identical to "
          f"one device's ({got['occupied']} occupied cells), {got['boxes']} "
          f"boxes equal; split {got['info']}; canvas / detector ms per rank "
          f"{[[round(t, 2) for t in r['spatial']['ms']] for r in got['ranks']]}")
    spread, one = got["wide_occupied"]
    if (got["wide_info"]["dropped_capacity"] or not got["wide_equal"]
            or spread <= one):
        fail(f"spatial front end on the 50,000-point sweep: bands "
             f"{got['wide_info']}, equal to one device with room: "
             f"{got['wide_equal']}, {spread} cells against {one}")
    print(f"spatial front end, 50,000-point sweep: the bands keep {spread} "
          f"occupied cells, one device at its budget {one}; bit-identical to "
          f"one device with max_pillars x {len(DP_RANKS)}")
    n_boxes = 0
    for s in range(BATCH):
        g = packed_to_boxes(got["dp_packed"][s], cfg)
        w = packed_to_boxes(got["one_batch"][s], cfg)
        check_boxes(g, w, f"DP sweep {s}", ref="the Detector's batch")
        n_boxes += len(g)
    print(f"DP packed detector: {n_boxes} boxes on the 8 sweeps within the "
          f"golden tolerances of the Detector's batch; ms per rank "
          f"{[round(r['eval']['ms'][0], 2) for r in got['ranks']]}, one "
          f"device's batch {got['one_batch_ms']:.2f} ms")
    totals = []
    for r, rank in enumerate(got["ranks"]):
        for part in ("spatial", "eval"):
            for k in ("emit", "fused_pfn", "bev_scatter", "nms_overlap"):
                if rank[part]["launches"][k] == 0:
                    fail(f"kernel {k} did not launch in rank {r}'s {part}")
        totals.append({k: sum(rank[p]["launches"][k] for p in
                              ("fused", "classic", "spatial", "eval"))
                       for k in rank["fused"]["launches"]})
        print(f"launches in phase 6, rank {r}: {totals[-1]}")
    return totals


def _script(name):
    """``scripts/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cudnn_mode(**flags):
    """A context in which ``torch.backends.cudnn`` has ``flags``."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def mode():
        c = torch.backends.cudnn
        saved = {k: getattr(c, k) for k in flags}
        for k, v in flags.items():
            setattr(c, k, v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(c, k, v)

    return mode()


def batch_size_witness(det, model_fn, pts, cnt, canvas_b, wire_b):
    """Why a single sweep's wire is not bit-equal to its row of the batch
    of 8 while its canvas is: each convolution of the RPN on the batch's
    own input to it, batch 8 against each row as a batch of one, under
    cuDNN as served (the layers whose rows differ are named); then the
    whole wire with cuDNN off (the native convolutions). Printed, not
    gated."""
    import torch
    import torch.nn.functional as F

    from tpu_pillars_torch.models.backbone import full_fp32

    rpn = det.model.rpn
    x = canvas_b.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    n = x.shape[0]
    differ, n_layers = [], 0

    def compare(name, layer, inp):
        nonlocal n_layers
        n_layers += 1
        many = layer(inp)
        eq, d = 0, 0.0
        for s in range(n):
            one = layer(inp[s:s + 1])[0]
            eq += int(torch.equal(one, many[s]))
            d = max(d, float((one - many[s]).abs().max()))
        if eq < n:
            differ.append(f"{name} ({n - eq} rows, max |d| {d:.1e})")
        return many

    with torch.no_grad(), full_fp32():
        for i, (block, up) in enumerate(zip(rpn.blocks, rpn.ups)):
            for j, (w, bn) in enumerate(zip(block.convs, block.bns)):
                stride = block.stride if j == 0 else 1
                y = compare(f"block {i} conv {j}", lambda t: F.conv2d(
                    t, w, stride=stride, padding=1), x)
                x = torch.relu(bn(y))
            compare(f"up {i}", lambda t: F.conv_transpose2d(
                t, up.weight, stride=up.stride), x)
        with cudnn_mode(enabled=False):
            wire8 = model_fn(pts, cnt)
            eq, d = 0, 0.0
            for s in range(n):
                one = model_fn(pts[s], cnt[s])
                eq += int(all(torch.equal(a, b[s])
                              for a, b in zip(one, wire8)))
                d = max(d, max(float((a - b[s]).abs().max())
                               for a, b in zip(one, wire8)))
            served = max(float((a - b).abs().max())
                         for a, b in zip(wire8, wire_b))
    print(f"3i batch-size witness (cuDNN {torch.backends.cudnn.version()}, "
          f"as served): {len(differ)} of the RPN's {n_layers} "
          f"convolutions give a batch-of-one row that differs from the "
          f"batch-8 row on the same input: " + ("; ".join(differ) or "none"))
    print(f"3i batch-size witness: the whole wire with cuDNN off: single "
          f"sweep bit-equal to the batch-8 row on {eq} of {n} scenes (max "
          f"|d| {d:.3e}); cuDNN off against cuDNN on, batch 8: max |d| "
          f"{served:.3e}")


def single_sweep_phase(cfg, card, golden, clouds):
    """Phase 3i: the single-sweep entry points at ``PillarsConfig()`` on the
    trained artifact. Returns the launches of the single-sweep forwards (the
    8 golden scenes, fused then classic)."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.detector import (
        Detector, build_forward_fn, build_model_fn, detections_to_boxes,
        pack_detections, packed_to_boxes, resolve_device,
    )
    from tpu_pillars_torch.ops import emit, nms, postprocess
    from tpu_pillars_torch.ops.anchors import make_anchors
    from tpu_pillars_torch.ops.nms_overlap import rotated_nms_pallas
    from tpu_pillars_torch.ops.voxelize import pillarize

    t_phase = time.perf_counter()
    dev = resolve_device()
    gclouds = golden_clouds(golden)
    total = {}
    for front, kw, kernels in (
            ("fused", {}, ("emit", "fused_pfn", "bev_scatter",
                           "nms_overlap")),
            ("classic", {"fused_frontend": False},
             ("emit", "pfn", "bev_scatter", "nms_overlap"))):
        det = Detector.from_checkpoint(cfg, CKPT, **kw)
        forward = build_forward_fn(det.model, cfg, **kw)
        model_fn = build_model_fn(det.model, cfg, **kw)
        padded = [det.pad_points(c) for c in gclouds]
        pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(dev)
        cnt = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)
        _build.reset_launches()
        singles = [forward(pts[s], cnt[s]) for s in range(len(gclouds))]
        torch.cuda.synchronize()
        launched = dict(_build.LAUNCHES)
        for name in kernels:
            if launched[name] == 0:
                fail(f"3i: kernel {name} did not launch in the {front} "
                     f"single-sweep forward")
            total[name] = total.get(name, 0) + launched[name]
        if front == "classic" and launched["fused_pfn"]:
            fail("3i: K2 launched on the classic single-sweep forward")
        worst, n_boxes = np.zeros(3), 0
        for s, one in enumerate(singles):
            got = detections_to_boxes(one, cfg)
            want = packed_to_boxes(golden["packed"][s], cfg)
            worst = np.maximum(worst, check_boxes(got, want, s))
            n_boxes += len(got)
        # against the batched form: its batch of one bit for bit, the
        # rows of the batch of 8 (canvas bit for bit; the RPN's convolutions
        # may round by batch size)
        batch = forward(pts, cnt)
        canvas_b = model_fn.canvas(pts, cnt)
        wire_b = model_fn(pts, cnt)
        n_det_equal, n_wire_equal, wire_d, det_d = 0, 0, 0.0, 0.0
        for s, one in enumerate(singles):
            if not torch.equal(model_fn.canvas(pts[s], cnt[s]), canvas_b[s]):
                fail(f"3i ({front}): scene {s}'s single-sweep canvas differs "
                     f"from the batch's row")
            packed = pack_detections(one)
            b1 = pack_detections(forward(pts[s:s + 1], cnt[s:s + 1]))[0]
            if not torch.equal(packed, b1):
                fail(f"3i ({front}): scene {s} differs from the batched "
                     f"form on a batch of one")
            row = pack_detections(batch)[s]
            n_det_equal += int(torch.equal(packed, row))
            det_d = max(det_d, float((packed - row).abs().max()))
            wire = model_fn(pts[s], cnt[s])
            n_wire_equal += int(all(torch.equal(a, b[s])
                                    for a, b in zip(wire, wire_b)))
            wire_d = max(wire_d, max(float((a - b[s]).abs().max())
                                     for a, b in zip(wire, wire_b)))
            if not torch.equal(packed[:, 8:], row[:, 8:]):
                fail(f"3i ({front}): scene {s}'s classes or valid rows "
                     f"differ from the batch's row")
            check_boxes(detections_to_boxes(one, cfg),
                        packed_to_boxes(row.cpu().numpy(), cfg), s,
                        ref="batch row")
        if front == "fused":
            batch_size_witness(det, model_fn, pts, cnt, canvas_b, wire_b)
        print(f"3i single sweep ({front}): {len(singles)} golden scenes, "
              f"{n_boxes} boxes match the JAX detections (worst |d score| "
              f"{worst[0]:.3e}, |d centre| {worst[1]:.3e} m, |d yaw| "
              f"{worst[2]:.3e} rad); canvas bit-equal to the batch-8 rows "
              f"and detections bit-equal to a batch of one on every scene; "
              f"wire bit-equal to the batch-8 row on {n_wire_equal} of "
              f"{len(singles)} scenes (max |d| {wire_d:.3e}), detections on "
              f"{n_det_equal} (max |d| {det_d:.3e}); launches {launched}")
        del det, forward, model_fn, batch, canvas_b, wire_b
        torch.cuda.empty_cache()

    # pillarize_auto (K1 on a batch of one) against the plain pillarize
    det = Detector.from_checkpoint(cfg, CKPT)
    for s, cloud in enumerate(gclouds):
        p, n = det.pad_points(cloud)
        p = torch.from_numpy(p).to(dev)
        n = torch.tensor(n, device=dev)
        got = emit.pillarize_auto(p, n, cfg)
        want = pillarize(p, n, cfg)
        for name, a, b in zip(got._fields, got, want):
            if not torch.equal(a, b):
                fail(f"3i: pillarize_auto's {name} differs from the plain "
                     f"pillarize on golden scene {s}")
    print(f"3i: pillarize_auto (K1) bit-equal to the plain pillarize on "
          f"{len(gclouds)} golden scenes")

    # rotated_nms_pallas (K4) against the fixpoint NMS on each scene's
    # candidates, recorded from the single-sweep forward
    seen = []
    entry = postprocess.rotated_nms_overlap

    def recording(shifted, valid, thr, class_ids=None, class_gap=0.0):
        seen.append((shifted.clone(), valid.clone(), class_ids.clone(), thr,
                     class_gap))
        return entry(shifted, valid, thr, class_ids=class_ids,
                     class_gap=class_gap)

    postprocess.rotated_nms_overlap = recording
    try:
        for cloud in gclouds:
            det.predict(cloud)
    finally:
        postprocess.rotated_nms_overlap = entry
    n_keep = 0
    for s, (shifted, valid, cls, thr, gap) in enumerate(seen):
        boxes, valid, cls = shifted[0], valid[0], cls[0]
        keep = rotated_nms_pallas(boxes, None, valid, thr, class_ids=cls,
                                  class_gap=gap)
        want = nms.rotated_nms(boxes, None, valid, thr)
        bad = (keep != want).nonzero()[:, 0].cpu().numpy()
        if len(bad):
            b = boxes.cpu().numpy()
            near = [np.min(np.abs(iou64_pairs(np.repeat(b[i:i + 1], len(b),
                                                        0), b) - thr))
                    for i in bad]
            if min(near) >= NMS_BOUNDARY_TOL:
                fail(f"3i: rotated_nms_pallas keeps another set than the "
                     f"fixpoint NMS on scene {s}, no pair at the threshold")
        n_keep += int(keep.sum())
    print(f"3i: rotated_nms_pallas (K4) keeps the fixpoint NMS's set on "
          f"{len(seen)} scenes ({n_keep} kept)")

    # top_k_two_stage against top_k_stable on the batch's thresholded
    # own-class scores, 8 x 720,000 -> 1,024
    padded = [det.pad_points(c) for c in clouds]
    pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(dev)
    cnt = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)
    own = det._stage1(pts, cnt)[0]
    _, anchor_cls = make_anchors(cfg)
    anchor_cls = torch.from_numpy(np.array(anchor_cls, np.int64)).to(dev)
    thr = torch.tensor([c.score_threshold for c in cfg.classes],
                       device=dev)[anchor_cls]
    sc = torch.sigmoid(own)
    masked = torch.where(sc >= thr, sc, -1.0)
    k = cfg.pre_nms_top_k
    times = {"stable": cuda_ms(lambda: postprocess.top_k_stable(masked, k),
                               20)}
    for x, label in ((masked, "thresholded scores"), (own, "logits")):
        v1, i1 = postprocess.top_k_stable(x, k)
        for rows in (32, 64, 128):
            v2, i2 = postprocess.top_k_two_stage(x, k, rows)
            if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
                fail(f"3i: top_k_two_stage (rows {rows}) differs from "
                     f"top_k_stable on the {label}")
    for rows in (32, 64, 128):
        times[f"two_stage_rows{rows}"] = cuda_ms(
            lambda: postprocess.top_k_two_stage(masked, k, rows), 20)
    print(f"3i: top_k_two_stage equal to top_k_stable (values and indices) "
          f"on the {tuple(masked.shape)} thresholded scores "
          f"({int((masked == 1.0).sum())} at 1.0) and logits, k {k}; ms "
          f"(CUDA events, median of 5 x 20): "
          + ", ".join(f"{key} {val:.4f}" for key, val in times.items()))
    del det, pts, cnt, own, masked, sc
    torch.cuda.empty_cache()

    # batch-of-one latency beside batch 8, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        det = Detector.from_checkpoint(cfg, CKPT, dtype=dtype)
        name = "f32" if dtype == torch.float32 else "bf16"
        det.predict(clouds[0])
        torch.cuda.synchronize()
        lat = []
        for _ in range(3):
            for cloud in clouds:
                t = time.perf_counter()
                det.predict(cloud)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
        one = stage_split(det, None, None, clouds[:1],
                          f"{name}, one sweep")
        eight = stage_split(det, None, None, clouds, f"{name}, batch 8")
        print(f"3i batch-of-one latency ({name}, {card}): Detector.predict "
              f"median {float(np.median(lat)):.2f} ms a sweep (min "
              f"{min(lat):.2f}, max {max(lat):.2f}, {len(lat)} calls); split "
              f"of one sweep (ms): pad {one['pad_ms']:.2f}, upload "
              f"{one['upload_ms']:.2f}, front end {one['frontend_ms']:.2f}, "
              f"RPN + head {one['rpn_head_ms']:.2f}, postprocess "
              f"{one['postprocess_ms']:.2f}, total {one['total_ms']:.2f}; "
              f"batch 8: {eight['total_ms'] / len(clouds):.2f} ms a sweep "
              f"({eight['total_ms']:.2f} a batch)")
        del det
        torch.cuda.empty_cache()
    print(f"phase 3i ({card}): {time.perf_counter() - t_phase:.1f} s")
    return total


def scripts_phase(cfg, card, golden):
    """Phase 3j: the three user scripts. Returns the launches of the
    ablation run and of the exported artifact's golden run."""
    import tempfile

    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.data.lyft import LyftDataset
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.train import loop
    from tpu_pillars_torch.train.checkpoint import export_inference_checkpoint

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        res = _script("torch_rehearsal_dataset").main(
            ["--root", os.path.join(tmp, "rehearsal"), "--scenes", "2",
             "--samples-per-scene", "2"])
        ds = LyftDataset(res["json_dir"])
        tokens = ds.sample_tokens()
        if len(tokens) != 4:
            fail(f"3j: the rehearsal root holds {len(tokens)} samples, not 4")
        print(f"3j rehearsal dataset: {len(tokens)} samples, "
              f"{res['bytes'] / 1e6:.1f} MB in "
              f"{time.perf_counter() - t:.1f} s; "
              f"{sum(len(ds.get_boxes_lidar(k)) for k in tokens)} GT boxes")

        t = time.perf_counter()
        _build.reset_launches()
        ablation = _script("torch_gt_sampling_ablation").main(
            ["--steps", str(ABLATION_STEPS), "--cbgs"])
        torch.cuda.synchronize()
        launches["ablation"] = dict(_build.LAUNCHES)
        for name in ("emit", "fused_pfn", "bev_scatter", "nms_overlap",
                     "assign"):
            if launches["ablation"][name] == 0:
                fail(f"3j: kernel {name} did not launch in the ablation")
        for arm, r in ablation.items():
            if not np.isfinite(r["final_loss"]):
                fail(f"3j: ablation arm {arm} ended on a non-finite loss")
        print(f"3j ablation ({ABLATION_STEPS} steps an arm, "
              f"{time.perf_counter() - t:.1f} s): "
              + json.dumps({a: {k: round(v, 4) for k, v in r.items()}
                            for a, r in ablation.items()})
              + f"; launches {launches['ablation']}")

        t = time.perf_counter()
        run = os.path.join(tmp, "run")
        loop.main(["--full-size", "--steps", "2", "--batch", "8", "--ema",
                   "0.999", "--eval-every", "2", "--eval-scenes", "2",
                   "--out", run])
        out = os.path.join(tmp, "artifact", "export.msgpack")
        exported = _script("torch_export_artifact").main(
            ["--run", run, "--out", out])
        # the script's pick against its source; when it picked the EMA
        # file (a copy), also the raw branch: the optimizer state stripped
        # by export_inference_checkpoint against the full checkpoint
        pairs = [("EMA" if exported["ema"] else "raw", out,
                  os.path.join(run, "ckpt.msgpack.ema" if exported["ema"]
                               else "ckpt.msgpack"))]
        if exported["ema"]:
            raw_out = os.path.join(tmp, "artifact", "raw.msgpack")
            export_inference_checkpoint(raw_out,
                                        os.path.join(run, "ckpt.msgpack"),
                                        config=cfg)
            pairs.append(("raw", raw_out, os.path.join(run, "ckpt.msgpack")))
        _build.reset_launches()
        n_boxes = {}
        for branch, art_path, source in pairs:
            art = Detector.from_checkpoint(cfg, art_path)
            live = Detector.from_checkpoint(cfg, source)
            n_boxes[branch] = 0
            for s, cloud in enumerate(golden_clouds(golden)):
                got = art.predict(cloud)
                if not same_boxes(got, live.predict(cloud)):
                    fail(f"3j: the {branch} export's boxes on golden scene "
                         f"{s} differ from its source checkpoint's")
                if not all(np.isfinite(b.to_array()).all() for b in got):
                    fail(f"3j: non-finite boxes from the {branch} export on "
                         f"scene {s}")
                n_boxes[branch] += len(got)
            del art, live
        torch.cuda.synchronize()
        launches["export"] = dict(_build.LAUNCHES)
        for name in ("emit", "fused_pfn", "bev_scatter", "nms_overlap"):
            if launches["export"][name] == 0:
                fail(f"3j: kernel {name} did not launch serving the export")
        print(f"3j export: a 2-step full-size run (EMA, eval); the script "
              f"picked the {pairs[0][0]} weights (mAP "
              f"{exported['mAP']:.4f}, EMA {exported['mAP_ema']:.4f}), "
              f"{exported['bytes'] / 1e6:.1f} MB; each branch's artifact ("
              + ", ".join(f"{b} by "
                          f"{'a copy' if b == 'EMA' else 'stripping'}"
                          for b, _, _ in pairs)
              + f") serves the 8 golden scenes bit-equal to its source "
              f"checkpoint (boxes {n_boxes}); "
              f"{time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    print(f"phase 3j ({card}): {time.perf_counter() - t_phase:.1f} s")
    return launches


def compare_targets(got, want):
    """Two batched ``Targets``: the anchors whose labels differ (positive,
    class weight, direction or class), those whose reg targets differ by
    more than 1e-4 while positive in both (tests/test_torch_assign.py's
    ``_compare`` boundary set), and the largest reg |d| elsewhere."""
    import torch

    pos_g, pos_w = got.reg_weights > 0, want.reg_weights > 0
    label = ((pos_g != pos_w) | (got.cls_weights != want.cls_weights)
             | (got.dir_targets != want.dir_targets)
             | (got.cls_onehot != want.cls_onehot).any(dim=1))
    reg = (got.reg_targets - want.reg_targets).abs().amax(dim=1)
    boundary = label | ((reg > 1e-4) & pos_g & pos_w)
    ok = ~boundary
    return int(label.sum()), int(boundary.sum()), float(
        torch.where(ok, reg, 0.0).max())


def assigners_4f(cfg, dev):
    """Phase 4f: the dense (A, G) ``assign_targets`` (each sample,
    ``DENSE_AG_CHUNK`` anchors a chunk) and the banded class-blocked
    assigner (``make_assigner(cfg, "banded")``) on 4e's batch, against
    the class-blocked dense assigner and K5; ms and transient GiB each.
    Returns the launches of the phase (K5's reference call)."""
    import numpy as np
    import torch

    from tpu_pillars_torch import _build
    from tpu_pillars_torch.ops.anchors import make_anchors
    from tpu_pillars_torch.ops.target_assigner import Targets, assign_targets
    from tpu_pillars_torch.train.loop import synthetic_batches
    from tpu_pillars_torch.train.state import TrainConfig
    from tpu_pillars_torch.train.step import batch_to_device, make_assigner

    t_phase = time.perf_counter()
    batch = batch_to_device(next(synthetic_batches(
        cfg, TrainConfig(batch_size=BATCH), seed=SEED)), dev)
    gt = (batch.gt_boxes, batch.gt_classes, batch.gt_valid)
    anchors, anchor_cls = make_anchors(cfg)
    anchors = torch.from_numpy(np.array(anchors)).to(dev)
    anchor_cls = torch.from_numpy(np.array(anchor_cls, np.int64)).to(dev)

    def dense_ag(boxes, cls, valid):
        per = [assign_targets(anchors, anchor_cls, boxes[b], cls[b],
                              valid[b], cfg, iou_chunk=DENSE_AG_CHUNK)
               for b in range(boxes.shape[0])]
        return Targets(*(torch.stack(x) for x in zip(*per)))

    _build.reset_launches()
    assigners = {"class-blocked": make_assigner(cfg, "dense"),
                 "K5": make_assigner(cfg, "windowed"),
                 "dense (A, G)": dense_ag,
                 "banded 48": make_assigner(cfg, "banded")}
    targets = {}
    for name, assign in assigners.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        targets[name] = assign(*gt)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = cuda_ms(lambda: assign(*gt), 1, reps=3)
        print(f"4f assigner {name} (batch {BATCH}, "
              f"{int(batch.gt_valid.sum())} valid GT): {ms:.3f} ms (CUDA "
              f"events, median of 3), {peak:.3f} GiB transient, "
              f"{int(targets[name].num_pos.sum())} positives")
    launched = dict(_build.LAUNCHES)
    n_anchors = BATCH * cfg.num_anchors
    for name in ("dense (A, G)", "banded 48"):
        for ref in ("class-blocked", "K5"):
            n_label, n_bound, reg_d = compare_targets(targets[name],
                                                      targets[ref])
            print(f"4f {name} against {ref}: labels differ on {n_label} of "
                  f"{n_anchors} anchors (ties and thresholds; {n_bound} with "
                  f"the reg boundary), reg |d| elsewhere {reg_d:.2e}")
            if n_bound > 1e-3 * n_anchors or reg_d > 1e-4:
                fail(f"4f: the {name} assigner differs from the {ref} one "
                     f"on {n_bound} anchors (reg |d| {reg_d:.2e})")
    del targets, batch, gt
    torch.cuda.empty_cache()
    print(f"phase 4f: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launched}")
    return launched


def iou64_pairs(a, b):
    """Float64 rotated BEV IoU of box pairs a[n], b[n] by the port's polygon
    clip (``reference_cpu.postprocess``): the referee where two f32 IoUs
    disagree."""
    import numpy as np

    from tpu_pillars_torch.reference_cpu.postprocess import rotated_iou_bev_np

    return np.array([rotated_iou_bev_np(x[None], y[None])[0, 0]
                     for x, y in zip(a, b)])


def check_boxes(got, want, scene, ref="JAX"):
    """The tolerance of the JAX package's trained-weights parity test:
    same count and labels, score 1e-3, centre and size 1e-2 m, yaw 1e-2.
    ``ref`` names what ``want`` comes from. Returns the largest score,
    centre and yaw deviations."""
    import numpy as np

    if len(got) != len(want):
        fail(f"golden scene {scene}: {len(got)} boxes, {ref} has "
             f"{len(want)}")
    worst = np.zeros(3)
    for k, (g, w) in enumerate(zip(got, want)):
        dyaw = abs((g.yaw - w.yaw + math.pi) % (2 * math.pi) - math.pi)
        if (g.label != w.label or abs(g.score - w.score) > 1e-3
                or not np.allclose(g.center, w.center, rtol=0, atol=1e-2)
                or not np.allclose(g.wlh, w.wlh, rtol=0, atol=1e-2)
                or dyaw > 1e-2):
            fail(f"golden scene {scene} box {k}: {g} vs {ref} {w}")
        dev = (abs(g.score - w.score),
               float(np.abs(np.asarray(g.center) - w.center).max()), dyaw)
        worst = np.maximum(worst, dev)
    return worst


def golden_check(det, golden, label):
    """``det.predict`` on every golden scene against the JAX detections
    (:func:`check_boxes`); prints the worst deviations."""
    import numpy as np

    from tpu_pillars_torch.detector import packed_to_boxes

    offs = golden["offsets"]
    n_boxes, worst = 0, np.zeros(3)
    for s in range(len(offs) - 1):
        got = det.predict(golden["points"][offs[s]:offs[s + 1]])
        want = packed_to_boxes(golden["packed"][s], det.config)
        worst = np.maximum(worst, check_boxes(got, want, s))
        n_boxes += len(got)
    print(f"golden ({label} front end): {len(offs) - 1} scenes, {n_boxes} "
          f"boxes match the JAX detections; worst |d score| {worst[0]:.3e}, "
          f"|d centre| {worst[1]:.3e} m, |d yaw| {worst[2]:.3e} rad")


def stage_split(det, points, counts, clouds, label="fused front end"):
    """Host-clock split of one call on ``clouds`` (batch 8, or one sweep;
    synchronised after each stage), median of 5, and the end-to-end rate
    from numpy clouds to host boxes. Returns the medians."""
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
    print(f"stage split ({label}), batch {len(clouds)} (host "
          f"clock, ms): " + json.dumps(med))
    print(f"end to end ({label}): {len(clouds) / med['total_ms'] * 1e3:.2f} "
          f"sweeps/s at batch {len(clouds)}")
    return med


if __name__ == "__main__":
    main()
