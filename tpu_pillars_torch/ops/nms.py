"""Greedy rotated NMS — port of ``tpu_pillars/ops/nms.py``.

Greedy keeping is the unique solution of

    keep_i = valid_i  AND  no j < i with (keep_j AND over_ji)

over score-sorted candidates (a suppressed box never suppresses; ties break
by lowest index). The op ``tpu_pillars::nms_fixpoint`` computes it from the
(B, K, K) overlap matrix. On the card it is one launch of
``csrc/nms_scan.cu`` (:func:`nms_scan_cuda`), which scans the candidates in
order and reads nothing back to the host. On the CPU it runs the JAX
package's fixpoint (:func:`nms_fixpoint_loop`): keep = valid, swept until it
stops changing, one masked any-reduction a sweep, batched over samples;
that loop is the plain version the kernel is held against.

:func:`rotated_nms` is the JAX package's single-set entry: the dense IoU
matrix (the arithmetic of ``ops.iou.rotated_iou_bev_chunked``, stock torch
ops, as the JAX package leaves it to XLA), the strict upper triangle above
the threshold, then the op. :func:`rotated_nms_batched` is the same on
every sample of a batch at once (the postprocess's ``nms_impl=
"fixpoint"``). The serving path's batched, class-blocked NMS on the K4
overlap kernel is ``ops.nms_overlap.rotated_nms_overlap``.
"""

from __future__ import annotations

import functools

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.ops.iou import rotated_iou_bev_colchunked
from tpu_pillars_torch.utils.profiling import count


def nms_fixpoint(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """over (B, K, K) bool, over[b, j, i]: higher-ranked j < i suppresses
    i; valid (B, K) bool -> keep (B, K) bool. The op
    ``tpu_pillars::nms_fixpoint`` (``_build.kernel_op``):
    :func:`nms_scan_cuda` on a CUDA tensor, :func:`nms_fixpoint_loop` on a
    CPU tensor; ``torch.export`` records the op."""
    return _NMS_FIXPOINT(over, valid)


@functools.lru_cache(maxsize=None)
def _smem_bytes(index: int) -> int:
    """The shared memory a block of card ``index`` may opt into."""
    return torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin


def nms_scan_cuda(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation of ``tpu_pillars::nms_fixpoint``: one launch
    of ``csrc/nms_scan.cu``, one block a row, bit-equal to
    :func:`nms_fixpoint_loop` on any ``over`` that is zero on and below the
    diagonal (the kernel reads only the strict upper triangle). A row's
    packed bits, K * ceil(K / 32) words, go to shared memory when they fit
    and to a global scratch the wrapper allocates when they do not. The
    counter ``nms.scan_rows`` counts the rows."""
    if valid.dim() != 2 or over.shape != valid.shape + valid.shape[-1:] \
            or over.dtype != torch.bool or valid.dtype != torch.bool:
        raise ValueError(f"nms_fixpoint wants bool over (B, K, K) and valid "
                         f"(B, K), got {over.dtype} {tuple(over.shape)} and "
                         f"{valid.dtype} {tuple(valid.shape)}")
    B, K = valid.shape
    keep = torch.empty((B, K), dtype=torch.bool, device=valid.device)
    words = -(-K // 32)
    scratch = (None if (K + 1) * words * 4 <= _smem_bytes(valid.device.index)
               else torch.empty((B, K, words), dtype=torch.int32,
                                device=valid.device))
    _build.launch("nms_scan", "nms_scan", "ppppii", over.contiguous(),
                  valid.contiguous(), keep, scratch, B, K)
    count("nms.scan_rows", B)
    return keep


def nms_fixpoint_loop(over: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """The sweep until the keep mask stops changing, the CPU implementation
    of ``tpu_pillars::nms_fixpoint`` (each sweep ends in a read of the
    mask). The counter ``nms.loop_rows`` counts the rows."""
    k = valid.shape[-1]
    over_f = over.to(torch.float32)
    keep = valid
    for _ in range(k):
        # suppressed_i = any_j keep_j & over_ji, as a 0/1 count (exact in f32
        # up to 2^24 suppressors)
        hits = torch.matmul(keep.to(torch.float32)[:, None, :], over_f)[:, 0]
        new_keep = valid & ~(hits > 0.0)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    count("nms.loop_rows", valid.shape[0])
    # an op's output may not be its input (nothing was suppressed)
    return keep.clone() if keep is valid else keep


_NMS_FIXPOINT = _build.kernel_op("nms_fixpoint", nms_scan_cuda,
                                 nms_fixpoint_loop,
                                 lambda over, valid: torch.empty_like(valid))


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy rotated BEV NMS over one score-sorted set: boxes (K, 7) in
    descending score order, scores (K,) (unused: the order is positional),
    valid (K,) bool (never kept, never suppressing) -> keep (K,) bool."""
    del scores
    return rotated_nms_batched(boxes[None], valid[None], iou_threshold)[0]


def rotated_nms_batched(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """:func:`rotated_nms` on each sample of boxes (B, K, 7), valid (B, K)
    -> keep (B, K), one IoU pass and one NMS op for the batch. Pair (j,
    i) rounds as ``rotated_iou_bev_chunked(boxes, boxes)[j, i]``, i.e.
    ``rotated_iou_bev``'s arithmetic with box i first; 256 columns at a
    time."""
    K = boxes.shape[-2]
    iou = rotated_iou_bev_colchunked(boxes, boxes,
                                     chunk=min(K, 256)).transpose(-1, -2)
    idx = torch.arange(K, device=boxes.device)
    over = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    return nms_fixpoint(over, valid)
