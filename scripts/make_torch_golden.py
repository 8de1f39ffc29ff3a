#!/usr/bin/env python
"""Write the JAX package's detections on the trained artifact as a golden
file for the PyTorch/CUDA port.

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py

Runs the JAX ``Detector`` on the CPU at the full ``PillarsConfig()`` with
the committed checkpoint ``artifacts/pointpillars_synth4k.msgpack``, the
classic (un-fused, XLA) front end and the fixpoint NMS. The inputs are the
8 held-out synthetic scenes that ``bench.py`` scores (``make_scene``,
generator seed 7100). Writes ``tests/data/torch_golden_synth4k.npz``:

  points   (sum of scene sizes, 4) f32 — the scenes' clouds, concatenated
  offsets  (9,) int64 — scene s is points[offsets[s]:offsets[s + 1]]
  packed   (8, 256, 10) f32 — ``Detector.predict_packed`` per scene
           [x, y, z, w, l, h, yaw, score, class, valid]
  map_heldout  () f64 — ``evaluation.pipeline.evaluate_scenes`` (Lyft mAP
           over the 8 scenes, lidar frame)
  tta_packed   (8, 256, 10) f32 — ``evaluation.tta.predict_tta`` per scene
           with the 4 flip views and the "wbf" merge, packed like
           ``packed`` and padded with valid = 0 rows

``chip_smoke.py`` holds the port's fused and classic front ends, its
evaluation and its TTA on the card against this file, and
``tests/test_torch_detector.py`` (fused), ``tests/test_torch_classic.py``
(classic) and ``tests/test_torch_eval.py`` (evaluation, TTA) hold them on
the CPU against it. Keys already in an existing file must come out
bit-equal; the script refuses to write otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default=os.path.join(
        ROOT, "artifacts", "pointpillars_synth4k.msgpack"))
    p.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_golden_synth4k.npz"))
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--seed", type=int, default=7100)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from tpu_pillars.config import PillarsConfig
    from tpu_pillars.data.synthetic import make_scene
    from tpu_pillars.detector import Detector
    from tpu_pillars.evaluation.pipeline import evaluate_scenes
    from tpu_pillars.evaluation.tta import MODES, predict_tta

    cfg = PillarsConfig()
    det = Detector.from_checkpoint(cfg, args.ckpt, use_pallas_pfn=False,
                                   fused_frontend=False, nms_impl="fixpoint")
    rng = np.random.default_rng(args.seed)
    scenes = [make_scene(rng, cfg) for _ in range(args.scenes)]
    clouds = [np.asarray(s.points, np.float32) for s in scenes]
    packed = np.stack([np.asarray(det.predict_packed(c)) for c in clouds])
    offsets = np.cumsum([0] + [len(c) for c in clouds]).astype(np.int64)
    map_heldout, _ = evaluate_scenes(det, scenes)
    names = list(cfg.class_names)
    tta = np.zeros_like(packed)
    for s, c in enumerate(clouds):
        boxes = predict_tta(det, c, modes=MODES, merge="wbf")
        for k, b in enumerate(boxes):
            tta[s, k] = np.concatenate(
                [b.to_array(), [b.score, names.index(b.label), 1.0]])
    out = dict(points=np.concatenate(clouds), offsets=offsets,
               packed=packed.astype(np.float32),
               map_heldout=np.float64(map_heldout),
               tta_packed=tta.astype(np.float32))
    if os.path.exists(args.out):
        old = np.load(args.out)
        for key in old.files:
            if not np.array_equal(old[key], out[key]):
                raise SystemExit(f"{args.out}: key {key!r} would change; "
                                 f"remove the file to rewrite it")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    n_det = int(packed[..., 9].sum())
    print(f"wrote {args.out}: {args.scenes} scenes, "
          f"{offsets[-1]} points, {n_det} detections, held-out mAP "
          f"{map_heldout:.6f}, {int(tta[..., 9].sum())} TTA detections")


if __name__ == "__main__":
    main()
