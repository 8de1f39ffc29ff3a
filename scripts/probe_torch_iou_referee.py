#!/usr/bin/env python3
"""Where the tiled IoU (K7) and the dense IoU disagree, which one is right.

    python3 scripts/probe_torch_iou_referee.py

Needs one CUDA card. Serves ``chip_smoke.py``'s batch of 8 lidar-like
sweeps (seed 0) with the trained checkpoint at the full ``PillarsConfig()``,
records the 8 x 1,024 top-k candidates before the class shift (as
``chip_smoke.py`` does), and for every pair where K7 and the dense
``ops.iou.rotated_iou_bev`` on the card differ by more than 1e-3 prints:
the dense IoU on the card and on the CPU, K7 on the card, the plain tiled
version on the CPU, and the float64 polygon clip of
``reference_cpu.postprocess.rotated_iou_bev_np`` (the referee), with the
pair's boxes.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops import iou, iou_tiled, postprocess
    from tpu_pillars_torch.reference_cpu.postprocess import rotated_iou_bev_np

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = PillarsConfig()
    det = Detector.from_checkpoint(cfg, chip_smoke.CKPT)
    clouds = chip_smoke.lidar_batch(np.random.default_rng(chip_smoke.SEED),
                                    cfg, chip_smoke.BATCH,
                                    chip_smoke.POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = np.stack([p for p, _ in padded])
    counts = np.asarray([n for _, n in padded])

    cands = []
    entry = postprocess.rotated_nms_overlap
    shift = 4.0 * ((cfg.x_max - cfg.x_min) + (cfg.y_max - cfg.y_min))

    def recording(shifted, valid, thr, class_ids=None, class_gap=0.0):
        boxes = shifted.clone()
        boxes[..., 0] = shifted[..., 0] - class_ids.to(boxes.dtype) * shift
        cands.append((boxes, valid.clone()))
        return entry(shifted, valid, thr, class_ids=class_ids,
                     class_gap=class_gap)

    postprocess.rotated_nms_overlap = recording
    try:
        det.predict_packed_batch(points, counts)
    finally:
        postprocess.rotated_nms_overlap = entry
    boxes, valid = cands[0]
    tiled = iou_tiled.rotated_iou_bev_tiled(boxes, boxes)
    dense = torch.stack([iou.rotated_iou_bev(c, c) for c in boxes])
    torch.cuda.synchronize()
    far = ((tiled - dense).abs() > 1e-3).nonzero().cpu()
    print(f"card: {torch.cuda.get_device_name(0)}; {len(far)} pairs where "
          f"K7 and the dense IoU differ by more than 1e-3")
    bc = boxes.cpu()
    print("sample i j valid_i valid_j | dense(card) dense(cpu) K7(card) "
          "tiled(cpu) float64 | box i | box j")
    worst = {"dense(card)": 0.0, "dense(cpu)": 0.0, "K7(card)": 0.0,
             "tiled(cpu)": 0.0}
    for b, i, j in far.tolist():
        a, c = bc[b, i], bc[b, j]
        ref = float(rotated_iou_bev_np(a[None].numpy(),
                                       c[None].numpy())[0, 0])
        d_cpu = float(iou.rotated_iou_bev(a[None], c[None])[0, 0])
        t_cpu = float(iou_tiled.rotated_iou_bev_tiled_plain(bc[b], bc[b])[i, j])
        vals = {"dense(card)": float(dense[b, i, j]), "dense(cpu)": d_cpu,
                "K7(card)": float(tiled[b, i, j]), "tiled(cpu)": t_cpu}
        for k, v in vals.items():
            worst[k] = max(worst[k], abs(v - ref))
        print(f"{b} {i} {j} {int(valid[b, i])} {int(valid[b, j])} | "
              + " ".join(f"{v:.6f}" for v in vals.values())
              + f" {ref:.6f} | {np.round(a.numpy(), 3).tolist()} | "
              f"{np.round(c.numpy(), 3).tolist()}")
    print("largest distance from the float64 clip over those pairs: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


if __name__ == "__main__":
    main()
