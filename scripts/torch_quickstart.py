#!/usr/bin/env python
"""End-to-end quickstart of the PyTorch/CUDA port: build a tiny on-disk
Lyft-format dataset, load it through the native loader, train briefly,
checkpoint, evaluate the global-frame Lyft mAP, write a Kaggle submission
CSV.

    python scripts/torch_quickstart.py --steps 200 --out /tmp/quickstart
    python scripts/torch_quickstart.py --steps 2 --device cpu   # no card

Runs on the card unless ``--device cpu`` (tiny config). This exercises
every tier of ``tpu_pillars_torch``, as ``scripts/quickstart.py`` does the
JAX package's: dataset adapter -> native loader (``data.native_io``) ->
train step (pillarize + assign + forward/backward) -> checkpoint ->
``Detector`` -> global-frame mAP -> submission writer. ``--num-sweeps 3``
trains on 3-sweep accumulations (``LyftDataset.load_sweeps_padded``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--out", type=str, default="tpu_pillars_torch_quickstart")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-sweeps", type=int, default=1,
                   help="sweeps accumulated per sample (> 1: the fixture "
                        "writes that many and training loads them fused)")
    p.add_argument("--gt-sample", type=int, default=0, metavar="TARGET",
                   help="enable GT-database sampling augmentation with this "
                        "per-class instance target (0 = off)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (the kernels' plain "
                        "versions)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the chain; returns {"checkpoint", "mAP", "submission"}."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.data import native_io
    from tpu_pillars_torch.data.fixture import build_fixture
    from tpu_pillars_torch.data.lyft import LyftDataset
    from tpu_pillars_torch.data.submission import write_submission
    from tpu_pillars_torch.detector import Detector, resolve_device
    from tpu_pillars_torch.evaluation.pipeline import evaluate_dataset
    from tpu_pillars_torch.train.checkpoint import save_checkpoint
    from tpu_pillars_torch.train.data import dataset_batches
    from tpu_pillars_torch.train.loop import fit
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.utils.logging import JsonlLogger

    device = resolve_device(args.device)
    cfg = tiny_config()
    if args.num_sweeps > 1:
        cfg = dataclasses.replace(cfg, num_sweeps=args.num_sweeps,
                                  max_points=4096 * args.num_sweeps)
    print(f"device: {device} ({torch.cuda.get_device_name(device)})"
          if device.type == "cuda" else f"device: {device}")

    print("1/6 building fixture dataset ...")
    json_dir = build_fixture(os.path.join(args.out, "dataset"), cfg,
                             num_scenes=2, samples_per_scene=3,
                             sweeps_per_sample=args.num_sweeps,
                             seed=args.seed)
    ds = LyftDataset(json_dir)
    tokens = ds.sample_tokens()
    print(f"    {len(tokens)} samples, "
          f"{sum(len(ds.get_boxes_lidar(t)) for t in tokens)} GT boxes")

    print("2/6 native loader ...")
    use_native = native_io.native_available()
    if not use_native:
        print(f"    unavailable, numpy path: {native_io.native_error()}")
    t0 = time.perf_counter()
    n_pts = 0
    for tok in tokens:
        if cfg.num_sweeps > 1:
            _, n = ds.load_sweeps_padded(tok, cfg, use_native=use_native)
        else:
            path = os.path.join(ds.data_path,
                                ds.lidar_sample_data(tok)["filename"])
            _, n = native_io.load_points_padded(path, cfg,
                                                use_native=use_native)
        n_pts += int(n)
    print(f"    {'native' if use_native else 'numpy'}: {n_pts} in-range "
          f"points over {len(tokens)} samples in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    gt_sampler = None
    if args.gt_sample > 0:
        from tpu_pillars_torch.data.gt_sampler import (
            GTDatabase, GTSampleConfig, GTSampler,
        )

        db = GTDatabase.from_dataset(ds, cfg)
        gt_sampler = GTSampler(
            db, GTSampleConfig(target_per_class=args.gt_sample))
        print(f"    GT-sampling on: db per-class counts {db.counts()}")

    print(f"3/6 training {args.steps} steps (batch {args.batch}) ...")
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       batch_size=args.batch, max_gt_boxes=8)
    state = create_train_state(cfg, tcfg, seed=args.seed, device=device)
    with JsonlLogger(os.path.join(args.out, "train.jsonl"), echo=True) as lg:
        state = fit(state,
                    dataset_batches(ds, cfg, tcfg.batch_size,
                                    tcfg.max_gt_boxes, seed=args.seed,
                                    gt_sampler=gt_sampler,
                                    use_native=use_native, num_workers=2),
                    steps=args.steps, config=cfg, logger=lg,
                    log_every=max(args.steps // 5, 1))

    ckpt = os.path.join(args.out, "ckpt.msgpack")
    save_checkpoint(ckpt, state, config=cfg)
    print(f"4/6 checkpoint -> {ckpt}")

    print("5/6 evaluating Lyft mAP over the fixture ...")
    det = Detector(cfg, state.model.state_dict(), device=device)
    mAP, table, preds = evaluate_dataset(det, ds, num_sweeps=cfg.num_sweeps)
    per_cls = table[0.5]
    print(f"    mAP(0.5:0.95) = {mAP:.3f}   AP@0.5 per class: "
          + ", ".join(f"{n}={a:.2f}" for n, a in zip(cfg.class_names, per_cls)
                      if a == a))

    sub = os.path.join(args.out, "submission.csv")
    write_submission(sub, preds)
    print(f"6/6 submission -> {sub}")
    return {"checkpoint": ckpt, "mAP": float(mAP), "submission": sub,
            "native": use_native, "points": int(np.int64(n_pts))}


if __name__ == "__main__":
    main()
