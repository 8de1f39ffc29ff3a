#!/usr/bin/env python
"""Render a BEV PNG of a scene with the PyTorch/CUDA port: lidar density +
GT boxes (green) + predictions (class-colored), via
``tpu_pillars_torch.utils.viz``.

    # synthetic scene, GT only (no model, <1 s):
    python scripts/torch_visualize.py --out scene.png

    # with predictions from a checkpoint, on the card:
    python scripts/torch_visualize.py --checkpoint ckpt.msgpack --out scene.png

    # first sample of a Lyft-format dataset directory, on the CPU:
    python scripts/torch_visualize.py --data DIR/data --tiny --device cpu \\
        --checkpoint tiny.msgpack --out scene.png

The steps are functions (``load_scene``, ``predict_boxes``, ``render``,
``read_png``) so that other programs render the same way.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def load_scene(cfg, data=None, sample=0, seed=0, clutter=40000):
    """(points (N, F), GT boxes) of sample ``sample`` of the Lyft-format
    directory ``data`` (its sweeps accumulated when ``cfg.num_sweeps`` >
    1), or of a seeded synthetic scene with ``clutter`` background
    points."""
    if data is not None:
        from tpu_pillars_torch.data.lyft import LyftDataset

        ds = LyftDataset(data)
        token = ds.sample_tokens()[sample]
        if cfg.num_sweeps > 1:
            points = ds.load_sweeps(token, cfg.num_sweeps)
        else:
            points = ds.load_point_cloud(ds.lidar_sample_data(token))
        return points, ds.get_boxes_lidar(token)   # List[Box3D], lidar frame
    from tpu_pillars_torch.data.synthetic import make_scene

    scene = make_scene(np.random.default_rng(seed), cfg, num_objects=24,
                       points_per_object=200, clutter=clutter)
    return scene.points, scene.gt_boxes


def predict_boxes(det, points):
    """A Detector's predictions on one cloud: (boxes (K, 7), class ids
    (K,), scores (K,)) of its valid packed rows."""
    packed = det.predict_packed(points).cpu().numpy()
    keep = packed[:, 9] > 0
    return (packed[keep, :7], packed[keep, 8].astype(int),
            packed[keep, 7])


def render(points, cfg, gt_boxes=None, pred_boxes=None, pred_cls=None,
           size=1000):
    """(size, size, 3) uint8 BEV image of the detection range."""
    from tpu_pillars_torch.utils.viz import render_scene

    return render_scene(points, pred_boxes=pred_boxes, gt_boxes=gt_boxes,
                        config=cfg, size=(size, size),
                        pred_class_ids=pred_cls)


def read_png(path):
    """An (H, W, 3) uint8 array from a PNG that ``viz.save_png`` wrote
    (8-bit RGB, one IDAT stream, filter 0 on every row)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, ctype) != (8, 2):
        raise ValueError(f"{path}: not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        raise ValueError(f"{path}: a row uses a PNG filter")
    return rows[:, 1:].reshape(h, w, 3).copy()


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", type=str, default="tpu_pillars_torch_scene.png")
    p.add_argument("--data", type=str, default=None,
                   help="Lyft-format dataset dir (default: synthetic scene)")
    p.add_argument("--sample", type=int, default=0,
                   help="sample index within --data")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint to run predictions from")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_config (matches tiny checkpoints; CPU-fast)")
    p.add_argument("--size", type=int, default=1000, help="image side (px)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="where --checkpoint's Detector runs: 'cuda' "
                        "(default) or 'cpu'")
    args = p.parse_args(argv)

    from tpu_pillars_torch.config import PillarsConfig, tiny_config
    from tpu_pillars_torch.utils.viz import save_png

    cfg = tiny_config() if args.tiny else PillarsConfig()
    points, gt_boxes = load_scene(cfg, args.data, args.sample, args.seed,
                                  clutter=2000 if args.tiny else 40000)
    print(f"scene: {len(points)} points, {len(gt_boxes)} GT boxes")

    pred_boxes = pred_cls = None
    if args.checkpoint is not None:
        from tpu_pillars_torch.detector import Detector

        det = Detector.from_checkpoint(cfg, args.checkpoint,
                                       device=args.device)
        pred_boxes, pred_cls, scores = predict_boxes(det, points)
        print(f"{len(pred_boxes)} detections (score p50 "
              f"{np.median(scores):.3f})" if len(scores)
              else "0 detections")

    img = render(points, cfg, gt_boxes, pred_boxes, pred_cls, args.size)
    save_png(args.out, img)
    print(f"wrote {args.out} ({img.shape[1]}x{img.shape[0]})")
    return args.out


if __name__ == "__main__":
    main()
