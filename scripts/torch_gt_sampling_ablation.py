#!/usr/bin/env python
"""GT-database sampling ablation on the PyTorch/CUDA port: does pasting a
rare class into training scenes improve that class's AP? The port of
``scripts/gt_sampling_ablation.py``: the same arms, seeds, tiny config,
scene pools and per-class AP table.

Controlled synthetic setup: the training pool is 12 scenes, 10 with cars
only and 2 with cars and pedestrians. The baseline trains on the pool; the
GT-sampling arm pastes stored pedestrians into every scene
(``data.gt_sampler.GTSampler``, collision-checked, target ``--target`` a
scene); ``--cbgs`` adds an arm that resamples the pool class-balanced
(``train.data.class_balanced_tokens``) without pasting. Every arm trains
the same steps from the same seed with ``train.loop.fit`` (K1, K3 and K5
on the card) and is scored on 6 held-out scenes holding both classes,
served by ``Detector`` (K1-K4 on the card), at IoU 0.3 and 0.5.

    python scripts/torch_gt_sampling_ablation.py --steps 2000 --cbgs
    python scripts/torch_gt_sampling_ablation.py --steps 20 --cpu

Runs on the card unless ``--cpu`` is given, and raises when there is no
card and ``--cpu`` was not given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

CAR, PED = 0, 7


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target", type=int, default=3,
                   help="per-scene pedestrian target for the sampler")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--cbgs", action="store_true",
                   help="also run a CBGS arm (scene-level class-balanced "
                        "resampling via train.data.class_balanced_tokens, "
                        "no GT-database injection) for a three-way "
                        "comparison")
    return p.parse_args(argv)


def make_pools(cfg, seed: int):
    """(train scenes, eval scenes): 10 car-only and 2 car + pedestrian
    training scenes from ``seed``, 6 car + pedestrian eval scenes from
    ``seed + 1000``."""
    import numpy as np

    from tpu_pillars_torch.data.synthetic import make_scene

    rng = np.random.default_rng(seed)
    train = [make_scene(rng, cfg, num_objects=3, points_per_object=200,
                        clutter=300, class_subset=[CAR]) for _ in range(10)]
    train += [make_scene(rng, cfg, num_objects=3, points_per_object=200,
                         clutter=300, class_subset=[CAR, PED])
              for _ in range(2)]
    eval_rng = np.random.default_rng(seed + 1000)
    evals = [make_scene(eval_rng, cfg, num_objects=4, points_per_object=200,
                        clutter=300, class_subset=[CAR, PED])
             for _ in range(6)]
    return train, evals


def batches(train_scenes, cfg, batch: int, sampler, seed: int):
    """Endless numpy training batches: ``batch`` distinct pool scenes a
    batch, each pasted by ``sampler`` (at most 8 boxes) when one is
    given."""
    import numpy as np

    from tpu_pillars_torch.data.synthetic import scenes_to_train_batch

    brng = np.random.default_rng(seed)
    while True:
        idx = brng.choice(len(train_scenes), batch, replace=False)
        scenes = [train_scenes[i] for i in idx]
        if sampler is not None:
            aug = []
            for s in scenes:
                pts, gb, gc = sampler(brng, s.points, s.gt_boxes,
                                      s.gt_classes, max_total=8)
                aug.append(type(s)(pts, gb, gc, []))
            scenes = aug
        yield scenes_to_train_batch(scenes, cfg, 8)


def cbgs_pool(train_scenes, cfg, seed: int):
    """Pool indices drawn by ``train.data.class_balanced_tokens`` over the
    in-memory scenes (a duck-typed dataset of them)."""
    from tpu_pillars_torch.train.data import class_balanced_tokens

    class _Box:
        def __init__(self, label):
            self.label = label

    class _ScenePool:
        def sample_tokens(self):
            return [str(i) for i in range(len(train_scenes))]

        def get_boxes_lidar(self, tok):
            s = train_scenes[int(tok)]
            return [_Box(cfg.class_names[int(c)]) for c in s.gt_classes]

    return [int(t) for t in class_balanced_tokens(_ScenePool(), cfg,
                                                  seed=seed, ratio=1.0)]


def cbgs_batches(train_scenes, pool, cfg, batch: int, seed: int):
    """Endless batches drawn from ``pool`` with replacement (CBGS's
    draws)."""
    import numpy as np

    from tpu_pillars_torch.data.synthetic import scenes_to_train_batch

    brng = np.random.default_rng(seed)
    while True:
        idx = brng.choice(len(pool), batch, replace=True)
        yield scenes_to_train_batch([train_scenes[pool[i]] for i in idx],
                                    cfg, 8)


def score(det, scenes, cfg, prefix: str):
    """(mAP at IoU 0.3 and 0.5, car AP, pedestrian AP, predicted boxes) of
    ``det`` on ``scenes``."""
    import numpy as np

    from tpu_pillars_torch.evaluation.map_eval import EvalBox, lyft_map

    gt, preds = [], []
    for i, scene in enumerate(scenes):
        tok = f"{prefix}{i}"
        for b, c in zip(scene.gt_boxes, scene.gt_classes):
            gt.append(EvalBox(tok, cfg.class_names[c],
                              np.asarray(b, np.float64)))
        for box in det.predict(scene.points, token=tok):
            preds.append(EvalBox.from_box3d(box))
    mAP, table = lyft_map(gt, preds, cfg.class_names,
                          iou_thresholds=(0.3, 0.5))
    return (float(mAP), float((table[0.3][CAR] + table[0.5][CAR]) / 2),
            float((table[0.3][PED] + table[0.5][PED]) / 2), len(preds))


def run_arm(label, batch_iter, cfg, args, device, eval_scenes,
            fit_scenes) -> dict:
    """Train one arm with ``fit``, score it on ``eval_scenes``, and on
    ``fit_scenes`` (the pool scenes it draws from, unpasted): a detector
    that fits these but not the held-out ones overfits its pool."""
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.train.loop import fit
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.utils.logging import JsonlLogger

    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       batch_size=args.batch, max_gt_boxes=8)
    state = create_train_state(cfg, tcfg, seed=args.seed, device=device)
    records = []

    class _Keep(JsonlLogger):
        def log(self, event, **fields):
            records.append(dict(event=event, **fields))

    t0 = time.perf_counter()
    state = fit(state, batch_iter, steps=args.steps, config=cfg,
                logger=_Keep(), log_every=max(args.steps // 4, 1))
    train_s = time.perf_counter() - t0
    det = Detector(cfg, state.model.state_dict(), device=device)
    mAP, car_ap, ped_ap, n_preds = score(det, eval_scenes, cfg, "e")
    fit_map, fit_car, _, fit_preds = score(det, fit_scenes, cfg, "t")
    losses = [r["loss"] for r in records if r["event"] == "train_step"]
    print(f"{label}: mAP(0.3,0.5)={mAP:.3f}  car AP={car_ap:.3f}  "
          f"pedestrian AP={ped_ap:.3f}  (final loss {losses[-1]:.4f}, "
          f"{args.steps} steps in {train_s:.1f} s; {n_preds} boxes on "
          f"{len(eval_scenes)} held-out scenes; on its {len(fit_scenes)} "
          f"pool scenes mAP={fit_map:.3f} car AP={fit_car:.3f}, "
          f"{fit_preds} boxes)")
    return {"mAP": mAP, "car_ap": car_ap, "ped_ap": ped_ap,
            "final_loss": losses[-1], "train_s": train_s,
            "preds": n_preds, "fit_mAP": fit_map, "fit_car_ap": fit_car,
            "fit_preds": fit_preds}


def main(argv=None) -> dict:
    """Runs the arms; returns {arm: {"mAP", "car_ap", "ped_ap",
    "final_loss", "train_s", "preds", "fit_mAP", "fit_car_ap",
    "fit_preds"}} with the arms "baseline", "gt_sampling" and, with
    ``--cbgs``, "cbgs"."""
    args = parse_args(argv)

    import torch

    from tpu_pillars_torch.config import tiny_config
    from tpu_pillars_torch.data.gt_sampler import (
        GTDatabase, GTSampleConfig, GTSampler,
    )
    from tpu_pillars_torch.detector import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    cfg = tiny_config()
    train_scenes, eval_scenes = make_pools(cfg, args.seed)
    n_ped = sum(int((s.gt_classes == PED).sum()) for s in train_scenes)
    print(f"train pool: {len(train_scenes)} scenes, "
          f"{sum(len(s.gt_boxes) for s in train_scenes)} boxes, "
          f"{n_ped} pedestrians")
    db = GTDatabase.from_scenes(train_scenes, cfg.num_classes)
    print(f"gt database per-class counts: {db.counts()}")

    res = {"baseline": run_arm(
        "baseline (no sampling)  ",
        batches(train_scenes, cfg, args.batch, None, args.seed + 7),
        cfg, args, device, eval_scenes, train_scenes)}
    sampler = GTSampler(db, GTSampleConfig(
        target_per_class={PED: args.target}))
    res["gt_sampling"] = run_arm(
        f"gt-sampling (target {args.target})",
        batches(train_scenes, cfg, args.batch, sampler, args.seed + 7),
        cfg, args, device, eval_scenes, train_scenes)
    base, gts = res["baseline"], res["gt_sampling"]
    print(f"\npedestrian AP: {base['ped_ap']:.3f} -> {gts['ped_ap']:.3f} "
          f"({'+' if gts['ped_ap'] >= base['ped_ap'] else ''}"
          f"{gts['ped_ap'] - base['ped_ap']:.3f}); car AP: "
          f"{base['car_ap']:.3f} -> {gts['car_ap']:.3f}")

    if args.cbgs:
        pool = cbgs_pool(train_scenes, cfg, args.seed)
        n_ped_pool = sum(1 for i in pool
                         if (train_scenes[i].gt_classes == PED).any())
        drawn = sorted(set(pool))
        print(f"\ncbgs pool: {len(pool)} draws of {len(drawn)} distinct "
              f"scenes, {n_ped_pool} hold pedestrians (raw pool: "
              f"2/{len(train_scenes)})")
        res["cbgs"] = run_arm(
            "cbgs (balanced resample) ",
            cbgs_batches(train_scenes, pool, cfg, args.batch,
                         args.seed + 7),
            cfg, args, device, eval_scenes,
            [train_scenes[i] for i in drawn])
        cb = res["cbgs"]
        print(f"pedestrian AP: baseline {base['ped_ap']:.3f} / cbgs "
              f"{cb['ped_ap']:.3f} / gt-sampling {gts['ped_ap']:.3f}; car "
              f"AP: {base['car_ap']:.3f} / {cb['car_ap']:.3f} / "
              f"{gts['car_ap']:.3f}")
    print("\n                 ped AP   car AP   mAP")
    for arm, r in res.items():
        print(f"  {arm:<14} {r['ped_ap']:.3f}    {r['car_ap']:.3f}    "
              f"{r['mAP']:.3f}")
    return res


if __name__ == "__main__":
    main()
