"""Training driver: seeded synthetic batches in, the training step on the
card, one JSON line every 10 steps and after the last (as the JAX loop
logs), an inference checkpoint at the end.
Port of ``tpu_pillars/train/loop.py`` (synthetic data, no augmentation).

    python -m tpu_pillars_torch.train.loop --full-size --steps 20 --batch 8 \\
        --out DIR

writes ``DIR/train.jsonl`` and ``DIR/ckpt.msgpack``, which both packages'
``Detector.from_checkpoint`` serve. ``--device cpu`` runs the kernels'
plain versions on the CPU (use the default tiny config there).
``--prefetch N`` (default 2) builds N batches ahead in a background thread
and moves them to the device there; 0 builds each batch in the step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig, tiny_config
from tpu_pillars_torch.data.synthetic import make_scene, scenes_to_train_batch
from tpu_pillars_torch.train.checkpoint import export_inference_checkpoint
from tpu_pillars_torch.train.prefetch import device_prefetch
from tpu_pillars_torch.train.state import (
    TrainConfig, TrainState, create_train_state,
)
from tpu_pillars_torch.train.step import batch_to_device, make_train_step


def synthetic_batches(config: PillarsConfig, tcfg: TrainConfig, seed: int = 0,
                      **scene_kw) -> Iterable[tuple]:
    """Endless stream of numpy batches (points, num_points, gt_boxes,
    gt_classes, gt_valid) of seeded synthetic scenes — the JAX package's
    stream for the same seed (no augmentation)."""
    rng = np.random.default_rng(seed)
    while True:
        scenes = [make_scene(rng, config, **scene_kw)
                  for _ in range(tcfg.batch_size)]
        yield scenes_to_train_batch(scenes, config, tcfg.max_gt_boxes)


class JsonlLogger:
    """One JSON object per line to a file and, optionally, stdout."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields) -> None:
        line = json.dumps({"event": event, **fields})
        if self.echo:
            print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def fit(state: TrainState, batches: Iterable, steps: int,
        step_fn: Optional[Callable] = None, config: PillarsConfig = None,
        logger: Optional[JsonlLogger] = None, log_every: int = 10,
        ckpt_path: Optional[str] = None) -> TrainState:
    """Run ``steps`` optimizer steps on numpy ``batches``. step_fn defaults
    to ``make_train_step(config)``. Logs loss, cls, loc, dir, num_pos and
    steps/s every ``log_every`` steps and after the last; writes an
    inference checkpoint to ``ckpt_path`` at the end."""
    if step_fn is None:
        step_fn = make_train_step(config)
    logger = logger or JsonlLogger(echo=False)
    device = next(state.model.parameters()).device
    t0 = time.perf_counter()
    i = -1
    for i, arrays in enumerate(batches):
        if i >= steps:
            break
        state, losses = step_fn(state, batch_to_device(arrays, device))
        if (i + 1) % log_every == 0 or i + 1 == steps:
            logger.log(
                "train_step", step=state.step, loss=float(losses.total),
                cls=float(losses.cls), loc=float(losses.loc),
                dir=float(losses.dir), num_pos=float(losses.num_pos),
                steps_per_s=round((i + 1) / (time.perf_counter() - t0), 3))
    if ckpt_path:
        export_inference_checkpoint(ckpt_path, state, config)
        logger.log("checkpoint", step=state.step, path=ckpt_path)
    return state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--out", type=str, default="tpu_pillars_torch_run")
    p.add_argument("--full-size", action="store_true",
                   help="full 400x400 config instead of the tiny smoke config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", choices=("all", "pfn", "rpn", "off"),
                   default="all",
                   help="activation checkpointing tier (recompute in the "
                        "backward pass instead of saving)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; 'cpu' runs the kernels' "
                        "plain versions")
    p.add_argument("--prefetch", type=int, default=2,
                   help="input-pipeline depth: batches built ahead in a "
                        "background thread and moved to the device there "
                        "(0 = synchronous)")
    args = p.parse_args(argv)

    config = PillarsConfig() if args.full_size else tiny_config()
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       batch_size=args.batch)
    if args.batch % args.accum:
        raise SystemExit(f"--batch {args.batch} must divide by --accum "
                         f"{args.accum}")
    state = create_train_state(config, tcfg, seed=args.seed,
                               device=args.device)
    logger = JsonlLogger(os.path.join(args.out, "train.jsonl"))
    device = next(state.model.parameters()).device
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    logger.log("start", steps=args.steps, batch=args.batch, device=kind,
               full_size=args.full_size, remat=args.remat, accum=args.accum,
               prefetch=args.prefetch,
               params=sum(x.numel() for x in state.model.parameters()))
    step_fn = make_train_step(config, remat=args.remat,
                              accum_steps=args.accum)
    batches = synthetic_batches(config, tcfg, seed=args.seed)
    if args.prefetch > 0:
        batches = device_prefetch(batches, size=args.prefetch, device=device)
    fit(state, batches, args.steps, step_fn=step_fn, config=config,
        logger=logger,
        ckpt_path=os.path.join(args.out, "ckpt.msgpack"))


if __name__ == "__main__":
    main(sys.argv[1:])
