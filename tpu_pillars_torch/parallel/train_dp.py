"""Data-parallel training over the ranks of a mesh. Port of
``tpu_pillars/parallel/train_dp.py``.

The JAX package has two formulations: the same step jitted with the batch
sharded (XLA inserts the gradient all-reduce), and its explicit
``shard_map`` twin (per-shard step, psum'ed BatchNorm statistics,
pmean'ed gradients). Torch has no partitioner, so both are the explicit
one here: the step runs in each rank's process on the rank's slice of the
global batch, with the collectives of ``train.step.make_train_step(mesh=)``.
:func:`make_dp_train_step` takes the global batch and slices it itself;
:func:`make_shardmap_train_step` takes the slice (:func:`shard_train_batch`).
"""

from __future__ import annotations

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.parallel.mesh import Mesh, local_shard
from tpu_pillars_torch.train.step import (
    TrainBatch, batch_to_device, make_train_step,
)


def shard_train_batch(batch, mesh: Mesh, axis_name: str = "data"
                      ) -> TrainBatch:
    """A host-global batch -> this rank's slice (:func:`local_shard`) as a
    :class:`TrainBatch` on the rank's device."""
    mesh.check_axis(axis_name)
    return batch_to_device(local_shard(batch, mesh), mesh.device)


def make_shardmap_train_step(config: PillarsConfig, mesh: Mesh,
                             axis_name: str = "data", iou_chunk: int = 8192,
                             **step_kw):
    """The per-rank step: step(state, shard, split=None) -> (state,
    LossBreakdown), ``shard`` this rank's slice (:func:`shard_train_batch`).
    BatchNorm statistics are reduced over the ranks (sync-BN), gradients
    and losses averaged and num_pos summed before the optimizer, so every
    rank computes the global batch's update and returns the global
    losses. Extra kwargs (compute_dtype, remat, fused_frontend,
    accum_steps, assigner) pass through to ``make_train_step``."""
    mesh.check_axis(axis_name)
    return make_train_step(config, iou_chunk=iou_chunk, mesh=mesh, **step_kw)


def make_dp_train_step(config: PillarsConfig, mesh: Mesh,
                       axis_name: str = "data", iou_chunk: int = 8192,
                       **step_kw):
    """step(state, batch, split=None) -> (state, LossBreakdown) with
    global-batch semantics: each rank takes its slice of the global
    ``batch`` (numpy arrays or a :class:`TrainBatch`) and runs
    :func:`make_shardmap_train_step`'s step on it."""
    step = make_shardmap_train_step(config, mesh, axis_name, iou_chunk,
                                    **step_kw)

    def dp_step(state, batch, split=None):
        return step(state, shard_train_batch(batch, mesh, axis_name), split)

    return dp_step
