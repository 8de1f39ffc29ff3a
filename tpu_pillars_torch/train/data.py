"""Dataset -> training batches, host numpy — port of
``tpu_pillars/train/data.py``: sample tokens -> padded point clouds and
class-mapped, padded GT boxes, with the augmentation stack (GT-database
sampling, per-object noise, the global transforms) and class-balanced
resampling. The batches are the numpy tuples (points, num_points,
gt_boxes, gt_classes, gt_valid) that ``train.loop.fit`` moves to the
device with ``train.step.batch_to_device`` (or ``train.prefetch``), as
``train.loop.synthetic_batches`` gives them; the same seed gives the JAX
package's stream bit for bit.

Multi-sweep configs (``num_sweeps > 1``, e.g. ``config.multisweep_config``)
load each sample with ``LyftDataset.load_sweeps_padded``: the sweeps moved
into the keyframe frame, cropped, with the dt column, by the native C++
loader (``data.native_io``) or its bit-equal numpy path (``use_native``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Sequence

import numpy as np

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.data.augment import (
    AugmentConfig, ObjectNoiseConfig, augment_scene, noise_per_object,
)
from tpu_pillars_torch.data.lyft import LyftDataset


def sample_to_arrays(dataset: LyftDataset, token: str, config: PillarsConfig,
                     max_gt_boxes: int, use_native: Optional[bool] = None):
    """One sample -> (points (n, F) real rows only, gt (G, 7), cls (G,),
    valid (G,)). Unknown category names are dropped. ``use_native`` picks
    the multi-sweep loader (``data.native_io``: None native when it builds,
    True native or raise, False numpy)."""
    if config.num_sweeps > 1:
        padded, n = dataset.load_sweeps_padded(token, config,
                                               use_native=use_native)
        points = padded[: int(n)]
    else:
        sd = dataset.lidar_sample_data(token)
        points = dataset.load_point_cloud(sd)[:, : config.num_raw_features]

    name_to_id = {c.name: i for i, c in enumerate(config.classes)}
    boxes: List[np.ndarray] = []
    classes: List[int] = []
    for b in dataset.get_boxes_lidar(token):
        ci = name_to_id.get(b.label)
        if ci is None:
            continue
        boxes.append(b.to_array().astype(np.float32))
        classes.append(ci)

    gb = np.zeros((max_gt_boxes, 7), np.float32)
    gc = np.zeros((max_gt_boxes,), np.int32)
    gv = np.zeros((max_gt_boxes,), bool)
    g = min(len(boxes), max_gt_boxes)
    if g:
        gb[:g] = np.stack(boxes[:g])
        gc[:g] = classes[:g]
        gv[:g] = True
    return points, gb, gc, gv


def class_balanced_tokens(dataset: LyftDataset, config: PillarsConfig,
                          tokens: Optional[Sequence[str]] = None,
                          seed: int = 0, ratio: float = 1.0) -> List[str]:
    """CBGS-style scene-level class-balanced resampling (Zhu et al.,
    arXiv:1908.09492 §3.1).

    Each class present in at least one sample gets an equal share
    (``round(ratio * len(tokens) / n_present)``) of the output, drawn WITH
    replacement from the samples containing it. A sample holding k classes
    can be drawn through any of its k buckets, so dedicated rare-class
    scenes are repeated more than crowded multi-class ones and the
    expected per-class sample frequency flattens. Samples with no
    known-class boxes are dropped.

    Returns a new token list of length ``~ratio * len(tokens)`` — pass it
    as ``dataset_batches(tokens=...)``; per-epoch shuffling stays
    :func:`dataset_batches`' job. Deterministic in ``seed``. Build any
    ``GTDatabase`` from the ORIGINAL (unique) tokens, not this list, or the
    database's per-class counts inherit the duplication.
    """
    tokens = list(tokens or dataset.sample_tokens())
    name_to_id = {c.name: i for i, c in enumerate(config.classes)}
    buckets: dict = {}
    for tok in tokens:
        ids = {name_to_id[b.label] for b in dataset.get_boxes_lidar(tok)
               if b.label in name_to_id}
        for ci in ids:
            buckets.setdefault(ci, []).append(tok)
    if not buckets:
        raise ValueError(
            "class_balanced_tokens: no sample contains a known-class box — "
            "nothing to balance (check config.classes vs the dataset's "
            "category names)")
    share = max(1, round(ratio * len(tokens) / len(buckets)))
    rng = np.random.default_rng(seed)
    out: List[str] = []
    for ci in sorted(buckets):
        pool = buckets[ci]
        out.extend(pool[int(j)] for j in rng.integers(len(pool), size=share))
    return out


def dataset_batches(dataset: LyftDataset, config: PillarsConfig,
                    batch_size: int, max_gt_boxes: int,
                    tokens: Optional[Sequence[str]] = None,
                    augment: Optional[AugmentConfig] = None,
                    object_noise: Optional[ObjectNoiseConfig] = None,
                    gt_sampler=None, seed: int = 0,
                    epochs: Optional[int] = None,
                    use_native: Optional[bool] = None,
                    num_workers: int = 0) -> Iterable[tuple]:
    """Shuffled epoch iterator of numpy batches (points, num_points,
    gt_boxes, gt_classes, gt_valid); drops the ragged tail batch.

    gt_sampler: optional ``data.gt_sampler.GTSampler`` — paste-injects
    stored GT objects of under-represented classes (collision-checked)
    BEFORE the global transforms, the SECOND-lineage order: sampling ->
    per-object noise (``object_noise``) -> global transforms (``augment``).

    use_native: the multi-sweep loader, as :func:`sample_to_arrays`.

    num_workers > 0 builds the batch's samples on a thread pool (loads and
    augmentation are numpy and file reads, which release the GIL; the
    native loader releases it for its whole pass). Each
    sample draws from its own RNG spawned in a fixed order from the stream
    RNG, so every worker count yields the bit-identical stream: resume
    replay does not depend on the worker setting."""
    rng = np.random.default_rng(seed)
    tokens = list(tokens or dataset.sample_tokens())
    if len(tokens) < batch_size:
        # without this the epoch loop would yield nothing and spin forever
        raise ValueError(
            f"dataset_batches: {len(tokens)} sample(s) < batch_size "
            f"{batch_size} — every epoch would be empty")
    f_expect = config.num_input_features

    def build_sample(j: int, srng: np.random.Generator):
        pts, b, c, v = sample_to_arrays(dataset, tokens[j], config,
                                        max_gt_boxes, use_native=use_native)
        if gt_sampler is not None:
            pts, b, c, v = gt_sampler.inject_padded(srng, pts, b, c, v)
        if object_noise is not None:
            nv = int(v.sum())          # valid rows are contiguous
            if nv:
                pts, moved = noise_per_object(srng, pts, b[:nv],
                                              object_noise)
                b = np.concatenate([moved, b[nv:]], axis=0)
        if augment is not None:
            pts, b = augment_scene(srng, pts, b, augment)
        return pts, b, c, v

    pool = (ThreadPoolExecutor(num_workers, "tpu-pillars-torch-data")
            if num_workers > 0 else None)
    try:
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(tokens))
            for start in range(0, len(tokens) - batch_size + 1, batch_size):
                idxs = order[start: start + batch_size]
                # spawned serially => deterministic regardless of workers
                srngs = rng.spawn(batch_size)
                if pool is not None:
                    samples = list(pool.map(build_sample, idxs, srngs))
                else:
                    samples = [build_sample(j, r)
                               for j, r in zip(idxs, srngs)]
                pts_b = np.full((batch_size, config.max_points, f_expect),
                                1e6, np.float32)
                npts = np.zeros((batch_size,), np.int32)
                gb = np.zeros((batch_size, max_gt_boxes, 7), np.float32)
                gc = np.zeros((batch_size, max_gt_boxes), np.int32)
                gv = np.zeros((batch_size, max_gt_boxes), bool)
                for i, (pts, b, c, v) in enumerate(samples):
                    n = min(len(pts), config.max_points)
                    pts_b[i, :n] = pts[:n, :f_expect]
                    npts[i] = n
                    gb[i], gc[i], gv[i] = b, c, v
                yield pts_b, npts, gb, gc, gv
            epoch += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
