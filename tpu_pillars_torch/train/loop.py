"""The training loop: seeded synthetic batches or a Lyft-format dataset in,
the training step on the card, JSONL metrics, full checkpoints every
``ckpt_every`` steps and at the end, evaluation during training, and the
elastic hooks. Port of ``tpu_pillars/train/loop.py``.

    python -m tpu_pillars_torch.train.loop --full-size --steps 20 --batch 8 \\
        --out DIR [--resume] [--ema 0.999] [--eval-every N] [--tensorboard] \\
        [--bf16] [--no-fused-frontend] [--dp N] \\
        [--data JSON_DIR [--workers 4] [--no-augment] \\
        [--object-noise] [--cbgs 1.0] [--gt-sample 8] [--val-samples 8]]

writes ``DIR/train.jsonl``, ``DIR/ckpt.msgpack`` (a full checkpoint, which
both packages resume and both packages' ``Detector.from_checkpoint``
serve), ``DIR/heartbeat.json`` (step and time, every step), with ``--ema``
``DIR/ckpt.msgpack.ema`` (the EMA weights, inference only), with
``--tensorboard`` event files under ``DIR/tb``, and on a non-finite loss
``DIR/diverged.msgpack`` (the last finite state). SIGTERM makes the run
checkpoint and exit 0; ``--resume`` continues from ``DIR/ckpt.msgpack``
on the same loss curve. ``--device cpu`` runs the kernels' plain versions
on the CPU (use the default tiny config there). ``--prefetch N`` (default
2) builds N batches ahead in a background thread and moves them to the
device there; 0 builds each batch in the step. ``--bf16`` trains in mixed
precision (bf16 canvas, RPN and head; f32 master state, checkpoints and
losses). ``--no-fused-frontend`` trains on the classic front end.
``--data`` trains on a Lyft-format dataset (``train/data.py``)
with the global augmentation (``--no-augment`` turns it off), and
optionally per-object noise, GT-database sampling and class-balanced
resampling; with ``--eval-every`` its last ``--val-samples`` samples are
held out and scored with ``evaluate_dataset``. ``--dp N`` trains
data-parallel over N ranks, one process each (``parallel.launch``): every
rank takes its slice of the same global batch, BatchNorm statistics are
synchronised and gradients averaged, and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig, tiny_config
from tpu_pillars_torch.data.synthetic import make_scene, scenes_to_train_batch
from tpu_pillars_torch.train.checkpoint import (
    export_inference_checkpoint, restore_checkpoint, save_checkpoint,
)
from tpu_pillars_torch.train.elastic import (
    GracefulShutdown, Heartbeat, NaNGuard,
)
from tpu_pillars_torch.train.ema import maybe_tracker
from tpu_pillars_torch.train.prefetch import device_prefetch
from tpu_pillars_torch.train.state import (
    TrainConfig, TrainState, create_train_state,
)
from tpu_pillars_torch.train.step import batch_to_device, make_train_step
from tpu_pillars_torch.utils.logging import JsonlLogger
from tpu_pillars_torch.utils.profiling import span

_END = object()     # the end of fit's batches


def synthetic_batches(config: PillarsConfig, tcfg: TrainConfig, seed: int = 0,
                      augment: bool = False,
                      **scene_kw) -> Iterable[tuple]:
    """Endless stream of numpy batches (points, num_points, gt_boxes,
    gt_classes, gt_valid) of seeded synthetic scenes — the JAX package's
    stream for the same seed; ``augment`` applies the global transforms
    (``data.augment.augment_scene``) to each scene from the same RNG."""
    from tpu_pillars_torch.data.augment import augment_scene

    rng = np.random.default_rng(seed)
    while True:
        scenes = []
        for _ in range(tcfg.batch_size):
            scene = make_scene(rng, config, **scene_kw)
            if augment:
                pts, boxes = augment_scene(rng, scene.points, scene.gt_boxes)
                scene = scene.__class__(pts, boxes, scene.gt_classes,
                                        scene.boxes)
            scenes.append(scene)
        yield scenes_to_train_batch(scenes, config, tcfg.max_gt_boxes)


def fit(state: TrainState, batches: Iterable, steps: int,
        step_fn: Optional[Callable] = None, config: PillarsConfig = None,
        logger: Optional[JsonlLogger] = None, log_every: int = 10,
        ckpt_path: Optional[str] = None, ckpt_every: int = 500,
        eval_fn: Optional[Callable] = None,
        eval_every: int = 1000,
        stop: Optional[Callable[[], bool]] = None,
        heartbeat=None, guard=None, ema=None) -> TrainState:
    """Run ``steps`` optimizer steps on numpy ``batches``. step_fn defaults
    to ``make_train_step(config)``. Logs loss, cls, loc, dir, num_pos and
    steps/s every ``log_every`` steps and after the last. The rate is over
    the steps since the previous log line, or since the end of the first
    step (read back for it), which leaves its warm-up out; a line of the
    first step alone times that step. While ``utils.profiling`` records,
    the spans ``fit.data`` (the wait for the next batch), ``fit.step`` (a
    unit: the rest of an iteration), ``fit.upload`` (``batch_to_device``)
    and ``fit.readback`` (the losses read on a logging step and on the
    first) time it.

    ckpt_path: a full checkpoint (``train.checkpoint.save_checkpoint``)
    every ``ckpt_every`` steps (logged as 'checkpoint') and at the end.

    eval_fn, if given, is called as eval_fn(state) every ``eval_every``
    steps and at the end; its returned dict is logged as an 'eval' event
    (e.g. :func:`make_synthetic_eval_fn`).

    Elastic hooks (``train/elastic.py``): ``stop`` is polled before each
    step — when it goes true (a ``GracefulShutdown`` caught SIGTERM) the
    loop logs a 'preempted' event, checkpoints, and returns for a
    ``--resume`` restart. ``heartbeat`` gets .beat(step) every step (a
    host counter: no device sync). ``guard`` (``NaNGuard``) gets
    .observe(state, loss) at the logging cadence, where the loss is on the
    host anyway.

    ema (``train/ema.py`` ``EmaTracker``): updated after every step; eval
    runs on BOTH the raw and the EMA weights (the EMA metrics get an
    '_ema' suffix), and every checkpoint write also exports ``ckpt_path +
    '.ema'``, an inference checkpoint of the EMA weights (served by
    ``Detector.from_checkpoint``; resume refuses it)."""
    if step_fn is None:
        step_fn = make_train_step(config)
    logger = logger or JsonlLogger(echo=False)
    device = next(state.model.parameters()).device
    step0 = state.step

    def run_eval():
        if eval_fn is None:
            return
        metrics = dict(eval_fn(state) or {})
        if ema is not None:
            for k, v in (eval_fn(ema.swap_into(state)) or {}).items():
                metrics[f"{k}_ema"] = v
        logger.log("eval", step=state.step,
                   **{k: float(v) for k, v in metrics.items()})

    def save_all(path):
        save_checkpoint(path, state, config=config)
        if ema is not None:
            export_inference_checkpoint(path + ".ema", ema.swap_into(state),
                                        config=config)

    batches = iter(batches)
    t_log, i_log = time.perf_counter(), 0
    i = -1
    while True:
        with span("fit.data"):
            arrays = next(batches, _END)
        if arrays is _END:
            break
        i += 1
        if i >= steps:
            break
        if stop is not None and stop():
            logger.log("preempted", step=step0 + i)
            break
        with span("fit.step", device=device, unit=True):
            with span("fit.upload", device=device):
                batch = batch_to_device(arrays, device)
            state, losses = step_fn(state, batch)
            if ema is not None:
                ema.update(state.model.parameters())
            if heartbeat is not None:
                heartbeat.beat(step0 + i + 1)
            logging = (i + 1) % log_every == 0 or i + 1 == steps
            if logging or i == 0:
                # the first step is read back too: its end starts the
                # rate's clock, so that its warm-up is left out
                with span("fit.readback"):
                    read = {k: float(getattr(losses, k)) for k in
                            ("total", "cls", "loc", "dir", "num_pos")}
                now = time.perf_counter()
                if logging:
                    logger.log(
                        "train_step", step=state.step, loss=read["total"],
                        cls=read["cls"], loc=read["loc"], dir=read["dir"],
                        num_pos=read["num_pos"], steps_per_s=round(
                            (i + 1 - i_log) / (now - t_log), 3))
                    if guard is not None:
                        guard.observe(state, read["total"])
                t_log, i_log = now, i + 1
            if ckpt_path and (i + 1) % ckpt_every == 0:
                save_all(ckpt_path)
                logger.log("checkpoint", step=state.step, path=ckpt_path)
            if (eval_fn is not None and (i + 1) % eval_every == 0
                    and i + 1 < steps):
                run_eval()
    if ckpt_path:
        save_all(ckpt_path)
    if i >= 0:
        run_eval()
    return state


def _serving(config: PillarsConfig):
    """state -> a ``Detector`` (f32) serving the state's weights: built
    once, on the first call, on the state's device; later calls only load
    the state's weights into it."""
    from tpu_pillars_torch.detector import Detector

    cache: list = []

    def serve(state: TrainState):
        weights = state.model.state_dict()
        if not cache:
            device = next(state.model.parameters()).device
            cache.append(Detector(config, weights, device=device))
        else:
            cache[0].load_state_dict(weights)
        return cache[0]

    return serve


def make_synthetic_eval_fn(config: PillarsConfig, num_scenes: int = 8,
                           seed: int = 100_000, **scene_kw):
    """eval_fn for :func:`fit`: detection mAP on a fixed held-out synthetic
    split, served in f32 by one ``Detector`` (:func:`_serving`)."""
    from tpu_pillars_torch.evaluation.pipeline import evaluate_scenes

    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, config, **scene_kw) for _ in range(num_scenes)]
    serve = _serving(config)

    def eval_fn(state: TrainState):
        mAP, _table = evaluate_scenes(serve(state), scenes)
        return {"mAP": mAP}

    return eval_fn


def make_dataset_eval_fn(config: PillarsConfig, dataset, tokens,
                         mesh=None):
    """eval_fn for :func:`fit`: detection mAP of ``evaluate_dataset`` on
    the held-out ``tokens`` of ``dataset``, served in f32 by one
    ``Detector`` (the JAX loop's ``Detector(config, state.variables)``);
    with a ``mesh``, in every rank, each predicting its share."""
    from tpu_pillars_torch.evaluation.pipeline import evaluate_dataset

    serve = _serving(config)

    def eval_fn(state: TrainState):
        mAP, _table, _preds = evaluate_dataset(serve(state), dataset,
                                               sample_tokens=tokens,
                                               mesh=mesh)
        return {"mAP": mAP}

    return eval_fn


def dataset_stream(args, config: PillarsConfig, tcfg: TrainConfig,
                   mesh=None):
    """``main --data``'s batches and eval hook, wired as the JAX loop wires
    them: the last ``--val-samples`` samples are held out (with
    ``--eval-every``), the GT database is built from the unique train
    tokens before ``--cbgs`` resamples them. The eval hook runs over
    ``mesh``'s ranks when given. Returns (batches, eval_fn)."""
    from tpu_pillars_torch.data.augment import AugmentConfig, ObjectNoiseConfig
    from tpu_pillars_torch.data.lyft import LyftDataset
    from tpu_pillars_torch.train.data import (
        class_balanced_tokens, dataset_batches,
    )

    ds = LyftDataset(args.data)
    tokens = list(ds.sample_tokens())
    train_tokens = tokens
    eval_fn = None
    if args.eval_every > 0 and args.val_samples > 0:
        n_val = min(args.val_samples, max(len(tokens) - args.batch, 0))
        train_tokens = tokens[: len(tokens) - n_val]
        val_tokens = tokens[len(tokens) - n_val:]
        if val_tokens:
            eval_fn = make_dataset_eval_fn(config, ds, val_tokens, mesh)
    gt_sampler = None
    if args.gt_sample > 0:
        from tpu_pillars_torch.data.gt_sampler import (
            GTDatabase, GTSampleConfig, GTSampler,
        )

        db = GTDatabase.from_dataset(ds, config, tokens=train_tokens)
        gt_sampler = GTSampler(
            db, GTSampleConfig(target_per_class=args.gt_sample))
    if args.cbgs > 0:
        # balance AFTER the GT database build: its per-class counts must
        # come from the unique tokens
        train_tokens = class_balanced_tokens(
            ds, config, tokens=train_tokens, seed=args.seed, ratio=args.cbgs)
    batches = dataset_batches(
        ds, config, tcfg.batch_size, tcfg.max_gt_boxes, tokens=train_tokens,
        augment=None if args.no_augment else AugmentConfig(),
        object_noise=ObjectNoiseConfig() if args.object_noise else None,
        gt_sampler=gt_sampler, seed=args.seed,
        num_workers=max(args.workers, 0))
    return batches, eval_fn


def parse_args(argv=None) -> argparse.Namespace:
    """``main``'s command line."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--out", type=str, default="tpu_pillars_torch_run")
    p.add_argument("--data", type=str, default=None,
                   help="Lyft-format dataset directory (data.lyft.LyftDataset"
                        " json root). Default: seeded synthetic scenes")
    p.add_argument("--workers", type=int, default=4,
                   help="thread-pool width for per-sample dataset loads "
                        "(--data only; any value yields the same stream)")
    p.add_argument("--no-augment", action="store_true",
                   help="disable the global flip/rotate/scale/translate "
                        "augmentation on dataset samples")
    p.add_argument("--object-noise", action="store_true",
                   help="per-object augmentation: independent yaw jitter + "
                        "xy translation of each GT box and its points, "
                        "collision-rejected (--data only)")
    p.add_argument("--cbgs", type=float, default=0.0,
                   help="class-balanced scene resampling (CBGS, "
                        "arXiv:1908.09492): >0 resamples the train tokens "
                        "so every class gets an equal share; the value is "
                        "the output/input length ratio (--data only)")
    p.add_argument("--gt-sample", type=int, default=0,
                   help="if > 0, GT-database sampling augmentation: paste-"
                        "inject stored objects until each class has N "
                        "instances per scene (--data only)")
    p.add_argument("--val-samples", type=int, default=8,
                   help="with --data and --eval-every: hold out the last N "
                        "samples for detection-mAP eval (never trained on)")
    p.add_argument("--full-size", action="store_true",
                   help="full 400x400 config instead of the tiny smoke config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", choices=("all", "pfn", "rpn", "off"),
                   default="all",
                   help="activation checkpointing tier (recompute in the "
                        "backward pass instead of saving)")
    p.add_argument("--no-fused-frontend", action="store_true",
                   help="train on the classic front end (K1 on the raw "
                        "points, decorate, the PillarFeatureNet on batch "
                        "statistics, K3) instead of the fused one")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel training over N ranks, one process "
                        "each (parallel.launch): the first N cards (NCCL), "
                        "or with --device cpu N CPU ranks (gloo); per-rank "
                        "step with sync-BN and averaged gradients "
                        "(parallel/train_dp.py). --batch must divide by N")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision training: bf16 canvas, RPN and "
                        "head; f32 parameters, optimizer, BN statistics, "
                        "losses and checkpoints")
    p.add_argument("--ema", type=float, default=0.0,
                   help="parameter-EMA decay (e.g. 0.999); 0 disables. "
                        "Evals run on raw AND EMA weights; checkpoints "
                        "also export <ckpt>.ema inference weights")
    p.add_argument("--resume", action="store_true",
                   help="continue from {out}/ckpt.msgpack if it exists: "
                        "restores the parameters, statistics, optimizer "
                        "state and step, and skips the batches the killed "
                        "run consumed, so the loss curve continues where "
                        "it left off")
    p.add_argument("--eval-every", type=int, default=0,
                   help="if > 0, log detection mAP on a held-out synthetic "
                        "split every N steps (and at the end)")
    p.add_argument("--eval-scenes", type=int, default=8)
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalar events to {out}/tb "
                        "(dependency-free writer, utils/tensorboard.py)")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; 'cpu' runs the kernels' "
                        "plain versions")
    p.add_argument("--prefetch", type=int, default=2,
                   help="input-pipeline depth: batches built ahead in a "
                        "background thread and moved to the device there "
                        "(0 = synchronous)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.dp > 1:
        from tpu_pillars_torch.parallel import launch, mesh_devices

        if args.batch % args.dp:
            raise SystemExit(f"--batch {args.batch} must divide by "
                             f"--dp {args.dp}")
        per_shard = args.batch // args.dp
        if per_shard % args.accum:
            raise SystemExit(
                f"per-shard batch {per_shard} (--batch {args.batch} / --dp "
                f"{args.dp}) must divide by --accum {args.accum}")
        launch(train, mesh_devices(args.dp, args.device), args=(args,))
        return
    if args.batch % args.accum:
        raise SystemExit(f"--batch {args.batch} must divide by --accum "
                         f"{args.accum}")
    train(args)


def train(args: argparse.Namespace) -> None:
    """``main``'s run on one device, or in each rank of ``--dp``'s group:
    every rank builds the same global batches and trains on its slice
    (``parallel.make_shardmap_train_step``). Every rank keeps the EMA and
    runs the eval hook (a ``--data`` split is evaluated over the mesh), so
    that no rank waits in a collective while another evaluates; rank 0
    alone writes the checkpoints, the JSONL, TensorBoard and the
    heartbeat."""
    mesh = None
    if args.dp > 1:
        from tpu_pillars_torch.parallel import make_mesh_n

        mesh = make_mesh_n(args.dp, device=args.device)
    lead = mesh is None or mesh.rank == 0
    config = PillarsConfig() if args.full_size else tiny_config()
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       batch_size=args.batch,
                       compute_dtype="bfloat16" if args.bf16 else "float32")
    state = create_train_state(
        config, tcfg, seed=args.seed,
        device=args.device if mesh is None else mesh.device)
    ckpt_path = os.path.join(args.out, "ckpt.msgpack")
    start = 0
    if args.resume and os.path.exists(ckpt_path):
        state = restore_checkpoint(ckpt_path, state, config=config)
        start = state.step
    device = next(state.model.parameters()).device

    eval_fn = None
    if args.data:
        batches, eval_fn = dataset_stream(args, config, tcfg, mesh)
    else:
        if args.cbgs > 0 and lead:
            print("warning: --cbgs needs --data; ignored on the synthetic "
                  "path", file=sys.stderr)
        batches = synthetic_batches(config, tcfg, seed=args.seed)
    if start:
        # the stream is a pure function of (seed, config): dropping the
        # first `start` batches, before any is moved to the device, replays
        # exactly the data the killed run saw
        batches = itertools.islice(batches, start, None)
    if mesh is not None:
        from tpu_pillars_torch.parallel.mesh import local_shard

        # each rank keeps its slice of the global batch, on the host
        batches = (local_shard(b, mesh) for b in batches)
    if args.prefetch > 0:
        batches = device_prefetch(batches, size=args.prefetch, device=device)
    if eval_fn is None and args.eval_every > 0 and not args.data:
        eval_fn = make_synthetic_eval_fn(config, num_scenes=args.eval_scenes,
                                         seed=args.seed + 100_000)

    logger_ctx = JsonlLogger(os.path.join(args.out, "train.jsonl")
                             if lead else None, echo=lead)
    if args.tensorboard and lead:
        from tpu_pillars_torch.utils.tensorboard import (
            TeeLogger, TensorBoardWriter,
        )

        logger_ctx = TeeLogger(logger_ctx, TensorBoardWriter(
            os.path.join(args.out, "tb")))
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    step_kw = dict(remat=args.remat, accum_steps=args.accum,
                   compute_dtype=getattr(torch, tcfg.compute_dtype),
                   fused_frontend=not args.no_fused_frontend)
    if mesh is None:
        step_fn = make_train_step(config, **step_kw)
    else:
        from tpu_pillars_torch.parallel import make_shardmap_train_step

        step_fn = make_shardmap_train_step(config, mesh, **step_kw)
    try:
        with logger_ctx as logger, GracefulShutdown() as shutdown:
            logger.log("start", steps=args.steps, batch=args.batch,
                       resumed_at=start, device=kind,
                       full_size=args.full_size, remat=args.remat,
                       accum=args.accum, prefetch=args.prefetch,
                       fused_frontend=not args.no_fused_frontend,
                       compute_dtype=tcfg.compute_dtype, data=args.data,
                       dp=max(args.dp, 1),
                       params=sum(x.numel()
                                  for x in state.model.parameters()))
            # under --dp every rank stops at the same step: a signal seen
            # by one rank is seen by all
            stop = (shutdown if mesh is None
                    else (lambda: mesh.any(shutdown())))
            fit(state, batches, steps=max(0, args.steps - start),
                step_fn=step_fn, config=config, logger=logger,
                ckpt_path=ckpt_path if lead else None,
                eval_fn=eval_fn,
                eval_every=args.eval_every or 1000, stop=stop,
                heartbeat=Heartbeat(os.path.join(args.out,
                                                 "heartbeat.json"))
                if lead else None,
                guard=NaNGuard(os.path.join(args.out, "diverged.msgpack"),
                               config=config) if lead else None,
                ema=maybe_tracker(state.model.parameters(), args.ema))
    finally:
        if args.prefetch > 0:
            # a preempted fit leaves the producer thread waiting on its
            # queue: closing the generator stops it
            batches.close()


if __name__ == "__main__":
    main(sys.argv[1:])
