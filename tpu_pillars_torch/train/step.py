"""The training step: points and GT boxes in, one AdamW update out. Port of
``tpu_pillars/train/step.py``, with both of its front ends:

  points -> fused (default): sort + cell-centre + K1 emit
            (``ops.fused_pfn``), the differentiable fused PFN, masked
            BatchNorm from sufficient statistics (``pfn_train_from_table``)
         -> classic (``fused_frontend=False``): sort + K1 emit on the raw
            points + ``decorate`` (``ops.emit.pillarize_batch_emit``), the
            PillarFeatureNet on batch statistics (``models.pfn``)
         -> K3 scatter, row-gather backward (``ops.bev.scatter_to_bev_diff``)
         -> batch-statistics RPN -> feature-major head
  GT     -> target assignment: K5 windowed (``ops.assign``, default), the
            dense class-blocked assigner or its banded form
            (``ops.target_assigner``)
         -> focal / smooth-L1 / direction loss -> backward
         -> global-norm clip + AdamW (``train.state.AdamW``)

The forward and backward run under ``models.pointpillars.full_fp32`` (no
TF32 in cuDNN or cuBLAS), like the f32 reference. ``compute_dtype=
torch.bfloat16`` is the JAX package's mixed precision: the fused PFN
stays f32 and its rows are cast to bf16 before K3, the classic
PillarFeatureNet's linear layer runs in bf16 (BatchNorm moments and
normalise in f32, output bf16); K3 writes a bf16 canvas from bf16 rows,
the RPN and the head run in bf16 (BatchNorm moments in f32), and the head
returns f32 to f32 losses; the parameters, running
statistics and AdamW moments stay f32, and the gradients reach them
through the casts. BatchNorm running statistics are updated by the step
itself from the moments the forward returns (momentum 0.99, biased
variance), once per microbatch — never inside a checkpointed block, whose
forward runs twice under remat.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.models.pointpillars import (
    ModelOutputs, PointPillars, full_fp32, remat_flags,
)
from tpu_pillars_torch.ops.assign import make_windowed_assigner
from tpu_pillars_torch.ops.bev import scatter_to_bev_diff
from tpu_pillars_torch.ops.emit import pillarize_batch_emit
from tpu_pillars_torch.ops.fused_pfn import (
    emit_centered_table, pfn_train_from_table,
)
from tpu_pillars_torch.ops.losses import LossBreakdown, detection_loss_fm
from tpu_pillars_torch.ops.target_assigner import make_classwise_assigner
from tpu_pillars_torch.train.state import TrainState
from tpu_pillars_torch.utils import profiling


class TrainBatch(NamedTuple):
    """One statically padded batch of tensors on the training device.

    points (B, M, F) f32; num_points (B,) int; gt_boxes (B, G, 7) f32;
    gt_classes (B, G) int; gt_valid (B, G) bool."""

    points: torch.Tensor
    num_points: torch.Tensor
    gt_boxes: torch.Tensor
    gt_classes: torch.Tensor
    gt_valid: torch.Tensor


def batch_to_device(arrays, device) -> TrainBatch:
    """numpy (points, num_points, gt_boxes, gt_classes, gt_valid) (e.g.
    ``data.synthetic.scenes_to_train_batch``) -> :class:`TrainBatch`."""
    dtypes = (torch.float32, torch.int64, torch.float32, torch.int64,
              torch.bool)
    return TrainBatch(*(torch.as_tensor(a).to(device, dt)
                        for a, dt in zip(arrays, dtypes)))


# the recorder of every step's ``split=``, apart from the module's spans
_SPLIT = profiling.Recorder()


class _Phases:
    """The step's phases, each from one ``begin`` to the next or to
    ``end``. With a ``split`` dict: a host-clock split in ms, the card
    synchronised at each boundary, on the recorder ``_SPLIT``. Without
    one, while ``utils.profiling`` records: device spans ``step.<phase>``
    that never synchronise. Otherwise nothing."""

    def __init__(self, out: Optional[dict], device):
        self.out = out
        self.device = device
        self.own = None if out is None else _SPLIT
        self.on = out is not None or profiling.recording()
        self.open = self.name = None
        if out is not None:
            self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin(self, name: str) -> None:
        if not self.on:
            return
        self.end()
        self.name = name
        self.open = (profiling.span("step." + name, device=self.device)
                     if self.own is None else self.own.span("step." + name))
        self.open.__enter__()

    def end(self) -> None:
        if self.open is None:
            return
        if self.own is not None:
            self._sync()
        self.open.__exit__(None, None, None)
        if self.own is not None:
            self.out[self.name] = (self.out.get(self.name, 0.0)
                                   + self.open.host_ms)
        self.open = None


# the banded assigner's window: the JAX package's choice, ~2x the largest
# class's diagonal at the 1 m feature stride of PillarsConfig()
BAND_CELLS = 48


def make_assigner(config: PillarsConfig, assigner="windowed",
                  max_gt_per_class: int = 16, iou_chunk: int = 16384):
    """The JAX package's assigner names -> a batched assign(gt_boxes,
    gt_classes, gt_valid) -> Targets: "windowed" is K5
    (``ops.assign.make_windowed_assigner``), "dense" the class-blocked
    dense IoU (``ops.target_assigner.make_classwise_assigner``, chunks of
    ``iou_chunk`` anchors), "banded" the same assigner with each GT's IoU
    only in the ``BAND_CELLS`` x ``BAND_CELLS`` window of anchors around
    its centre. A callable is returned as it is. (The JAX
    package's "auto" picks per backend; the port always runs on its card,
    where that is "windowed", so it has no "auto".)"""
    if callable(assigner):
        return assigner
    if assigner == "windowed":
        return make_windowed_assigner(config, max_gt_per_class)
    if assigner == "dense":
        return make_classwise_assigner(config, max_gt_per_class,
                                       iou_chunk=iou_chunk)
    if assigner == "banded":
        return make_classwise_assigner(config, max_gt_per_class,
                                       band_cells=BAND_CELLS)
    raise ValueError(f"assigner must be 'windowed', 'dense', 'banded' or a "
                     f"callable; got {assigner!r}")


def make_train_step(config: PillarsConfig, max_gt_per_class: int = 16,
                    remat=True, accum_steps: int = 1, assigner="windowed",
                    compute_dtype=torch.float32,
                    fused_frontend: bool = True,
                    iou_chunk: int = 16384, mesh=None):
    """Returns step(state, batch, split=None) -> (state, LossBreakdown).

    The step updates ``state.model`` and its optimizer in place and returns
    the batch's losses as 0-d tensors: total, cls, loc and dir are means
    over the samples, num_pos is their sum.

    remat: True/"all" checkpoints the PFN and every RPN block
    (``torch.utils.checkpoint``), "pfn" or "rpn" one tier, False/"off"
    none; the numbers are the same in every mode.

    accum_steps > 1 splits the batch into that many equal microbatches,
    sums their gradients, averages, and makes ONE optimizer update;
    BatchNorm moments are per microbatch, and the running statistics take
    one momentum update per microbatch, as in the JAX package.

    assigner: "windowed" (default) for K5, "dense" for the
    class-blocked dense assigner (its IoU ``iou_chunk`` anchors at a time),
    "banded" for it in a window around each GT, or a callable (gt_boxes, gt_classes, gt_valid) -> batched Targets
    (:func:`make_assigner`).

    fused_frontend: True (default) for the fused front end, False for the
    classic one (see the module docstring). The JAX package's default
    picks the fused one on its accelerator and the classic one elsewhere;
    the port always runs on its card, so its default is the fused one.

    compute_dtype: torch.float32 (default) or torch.bfloat16, the type of
    the canvas, the RPN and the head (see the module docstring).

    mesh: a ``parallel.Mesh`` when the step runs per rank on the rank's
    slice of a global batch (``parallel.make_shardmap_train_step``; the
    JAX ``axis_name``). Every BatchNorm takes its batch statistics over
    the ranks (sync-BN: K2's training twin sums its sufficient statistics,
    the PillarFeatureNet its count and moment numerators, the RPN averages
    its moments), and before the optimizer the gradients and the loss
    terms are averaged over the ranks and num_pos summed, so that every
    rank makes the same update, the global batch's.

    split: a dict that receives the step's synchronised host-clock split
    in ms (frontend, assign, forward, backward, allreduce with a mesh,
    optimizer). Without one, while ``utils.profiling`` records, the same
    phases are device spans ``step.<phase>`` that do not synchronise."""
    remat_pfn, remat_rpn = remat_flags(remat)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be torch.float32 or "
                        f"torch.bfloat16, got {compute_dtype}")
    assign_b = make_assigner(config, assigner, max_gt_per_class, iou_chunk)
    if fused_frontend:
        def inputs_of(batch: TrainBatch):
            return emit_centered_table(batch.points, batch.num_points,
                                       config)

        def canvas_of(model, inputs):
            """-> (canvas, the PFN's batch mean and var)."""
            table, meta = inputs
            p = model.pfn

            def pfn_feats(w, scale, bias):
                return pfn_train_from_table(table, meta, w, scale, bias,
                                            config, mesh=mesh)

            args = (p.kernel, p.bn.weight, p.bn.bias)
            feats, pid, cnt, b_mean, b_var = (
                checkpoint(pfn_feats, *args, use_reentrant=False)
                if remat_pfn else pfn_feats(*args))
            canvas = scatter_to_bev_diff(feats.to(compute_dtype), pid,
                                         cnt > 0.0, config, compute_dtype)
            return canvas, b_mean, b_var
    else:
        def inputs_of(batch: TrainBatch):
            return pillarize_batch_emit(batch.points, batch.num_points,
                                        config)

        def canvas_of(model, pillars):
            return model.train_canvas_from_batch(pillars, remat_pfn,
                                                 compute_dtype, mesh)

    def grads_of(model, batch: TrainBatch, phases: _Phases, after: str):
        """``after``: the phase that starts when the backward ends."""
        with torch.no_grad():
            inputs = inputs_of(batch)
        phases.begin("assign")
        targets = assign_b(batch.gt_boxes, batch.gt_classes, batch.gt_valid)
        phases.begin("forward")

        with full_fp32():
            canvas, b_mean, b_var = canvas_of(model, inputs)
            feat, moments = model.train_features_from_canvas(
                canvas, remat_rpn, compute_dtype, mesh)
            cls_fm, box_fm, dir_fm = model.head.feature_major(feat,
                                                              compute_dtype)
            losses = detection_loss_fm(cls_fm, box_fm, dir_fm, targets,
                                       config)
            total = losses.total.mean()
            phases.begin("backward")
            total.backward()
        phases.begin(after)
        # the running statistics: once per (micro)batch, here and only here
        model.pfn.bn.update_running(b_mean.detach(), b_var.detach())
        for bn, (mean, var) in zip(model.rpn.batch_norms(), moments):
            bn.update_running(mean.detach(), var.detach())
        return LossBreakdown(total.detach(), losses.cls.detach().mean(),
                             losses.loc.detach().mean(),
                             losses.dir.detach().mean(),
                             losses.num_pos.sum())

    def train_step(state: TrainState, batch: TrainBatch,
                   split: Optional[dict] = None):
        phases = _Phases(split, batch.points.device)
        phases.begin("frontend")
        try:
            return step_phases(state, batch, phases)
        finally:
            phases.end()

    def step_phases(state: TrainState, batch: TrainBatch, phases: _Phases):
        model = state.model
        for prm in model.parameters():
            prm.grad = None
        B = batch.points.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} not divisible by accum_steps "
                             f"{accum_steps}")
        mb = B // accum_steps
        sums = None
        for i in range(accum_steps):
            micro = TrainBatch(*(x[i * mb:(i + 1) * mb] for x in batch))
            after = ("frontend" if i + 1 < accum_steps else
                     "optimizer" if mesh is None else "allreduce")
            losses = grads_of(model, micro, phases, after)
            sums = losses if sums is None else LossBreakdown(
                *(a + b for a, b in zip(sums, losses)))
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            with torch.no_grad():
                for prm in model.parameters():
                    prm.grad.mul_(inv)
            # means of per-microbatch means are the batch means (equal
            # microbatches); num_pos stays a batch sum
            sums = LossBreakdown(sums.total * inv, sums.cls * inv,
                                 sums.loc * inv, sums.dir * inv,
                                 sums.num_pos)
        grads = None
        if mesh is not None:
            grads, sums = _reduce_over(mesh, model, sums)
            phases.begin("optimizer")
        state.optimizer.step(grads)
        state.step += 1
        return state, sums

    return train_step


@torch.no_grad()
def _reduce_over(mesh, model, losses: LossBreakdown):
    """The JAX step's ``pmean`` of the gradients and loss terms and ``psum``
    of num_pos: one all-reduce of the flat gradients, one of the five
    losses. Returns (the averaged gradients in parameter order, the
    reduced losses)."""
    params = list(model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    flat.div_(mesh.size)
    out, at = [], 0
    for p in params:
        out.append(flat[at:at + p.numel()].view_as(p))
        at += p.numel()
    terms = mesh.all_reduce_(torch.stack([x.float() for x in losses]))
    mean = terms / mesh.size
    return out, LossBreakdown(mean[0], mean[1], mean[2], mean[3],
                              terms[4].to(losses.num_pos.dtype))


def make_eval_forward(config: PillarsConfig, dtype=torch.float32):
    """The JAX ``make_eval_forward``: returns forward(model, points (B, M,
    F), num_points (B,)) -> anchor-major ``ModelOutputs``, the classic front
    end (K1 + ``decorate``) and the model on its running statistics
    (frozen BatchNorm), no gradients; for validation losses and
    ``ops.postprocess.postprocess``."""
    @torch.no_grad()
    def forward(model: PointPillars, points, num_points) -> ModelOutputs:
        pb = pillarize_batch_emit(points, num_points, config)
        return model(pb, dtype)

    return forward
