"""Evaluation and submission command line — port of
``tpu_pillars/evaluation/cli.py``:

    python -m tpu_pillars_torch.evaluation.cli --data DIR --ckpt CKPT \\
        [--submission out.csv] [--out metrics.json] [--full-size] \\
        [--num-sweeps K] [--tta] [--device cpu]

Loads a checkpoint into a ``Detector`` on ``--device`` (default: the card;
the CPU only when asked for), scores Lyft mAP (the competition protocol,
global frame) over the dataset's samples, prints the per-class AP table,
and optionally writes the metrics as JSON and the Kaggle submission CSV.
``--dp N`` above 1 evaluates data-parallel over N ranks, one process each
(``parallel.launch``): on the first N cards (NCCL), or with ``--device
cpu`` on N CPU ranks (gloo); rank 0 prints and writes. ``--dp`` 0 or 1
evaluates on one device, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import warnings

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=str, required=True,
                   help="Lyft-format dataset directory (json table root)")
    p.add_argument("--ckpt", type=str, required=True,
                   help="flax msgpack checkpoint (either package's format)")
    p.add_argument("--submission", type=str, default=None,
                   help="also write the Kaggle submission CSV here")
    p.add_argument("--out", type=str, default=None,
                   help="write the metrics (mAP + AP table) as JSON here")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num-sweeps", type=int, default=0,
                   help="accumulate K sweeps per sample (0 = the config's "
                        "num_sweeps)")
    p.add_argument("--samples", type=int, default=0,
                   help="evaluate only the first N samples (0 = all)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel evaluation over N ranks (one "
                        "process each): each batch is split over them and "
                        "the detections gathered (parallel/eval_dp.py)")
    p.add_argument("--full-size", action="store_true",
                   help="full 400x400 config instead of the tiny config")
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation: ensemble the 4 BEV "
                        "flip views per sample (4x the device passes)")
    p.add_argument("--tta-merge", choices=("nms", "wbf"), default="wbf",
                   help="TTA merge: weighted box fusion (default) or "
                        "class-aware NMS (see evaluation/tta.py)")
    p.add_argument("--lidar-frame", action="store_true",
                   help="score in each keyframe's lidar frame instead of "
                        "the competition's global frame")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--match-rule", choices=("mask_argmax", "argmax_check"),
                   default="mask_argmax",
                   help="greedy-match protocol corner (docs/MAP_PROTOCOL.md "
                        "row 6)")
    p.add_argument("--tie-order", choices=("stable", "numpy", "reversed"),
                   default="stable",
                   help="score-tie visit order (MAP_PROTOCOL.md row 7)")
    args = p.parse_args(argv)
    if args.dp > 1:
        from tpu_pillars_torch.parallel import launch, mesh_devices

        launch(evaluate, mesh_devices(args.dp, args.device), args=(args,))
    else:
        evaluate(args)


def evaluate(args) -> None:
    """The CLI's work on one device, or in each rank of ``--dp``'s group
    (the rank's mesh from ``parallel.make_mesh_n``; rank 0 prints and
    writes)."""
    from tpu_pillars_torch.config import PillarsConfig, tiny_config
    from tpu_pillars_torch.data.lyft import LyftDataset
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.evaluation.pipeline import evaluate_dataset
    from tpu_pillars_torch.evaluation.tta import MODES

    mesh = None
    if args.dp > 1:
        from tpu_pillars_torch.parallel import make_mesh_n

        mesh = make_mesh_n(args.dp, device=args.device)
    config = PillarsConfig() if args.full_size else tiny_config()
    det = Detector.from_checkpoint(
        config, args.ckpt,
        device=args.device if mesh is None else mesh.device)
    ds = LyftDataset(args.data)
    tokens = list(ds.sample_tokens())
    if args.samples > 0:
        tokens = tokens[: args.samples]
    num_sweeps = args.num_sweeps or config.num_sweeps

    mAP, table, predictions = evaluate_dataset(
        det, ds, sample_tokens=tokens, num_sweeps=num_sweeps,
        global_frame=not args.lidar_frame, batch_size=args.batch,
        mesh=mesh, tta_modes=MODES if args.tta else None,
        tta_merge=args.tta_merge, match_rule=args.match_rule,
        tie_order=args.tie_order)
    if mesh is not None and mesh.rank != 0:
        return

    print(f"samples: {len(tokens)}   device: {det.device}"
          + (f"   dp: {mesh.devices.size}" if mesh is not None else ""))
    with warnings.catch_warnings():
        # all-NaN columns (a class absent at every threshold) are expected:
        # they get the "(no GT)" tag below
        warnings.simplefilter("ignore", RuntimeWarning)
        per_class = np.nanmean(np.stack(list(table.values())), axis=0)
    for name, ap50, ap in zip(config.class_names, table[0.5], per_class):
        tag = "   (no GT)" if np.isnan(ap) else ""
        print(f"  {name:>18s}  AP@0.5 {np.nan_to_num(ap50):.4f}  "
              f"AP@0.5:0.95 {np.nan_to_num(ap):.4f}{tag}")
    print(f"Lyft mAP(0.5:0.95) = {mAP:.4f}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mAP": mAP,
                       "ap": {str(t): [None if np.isnan(a) else float(a)
                                       for a in aps]
                              for t, aps in table.items()},
                       "class_names": list(config.class_names),
                       "num_samples": len(tokens)}, f, indent=2)
    if args.submission:
        from tpu_pillars_torch.data.submission import write_submission

        write_submission(args.submission, predictions)
        print(f"submission: {args.submission} ({len(predictions)} samples)")


if __name__ == "__main__":
    main()
