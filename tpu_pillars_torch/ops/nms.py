"""Greedy rotated NMS as a fixpoint — port of ``tpu_pillars/ops/nms.py``.

Greedy keeping is the unique solution of

    keep_i = valid_i  AND  no j < i with (keep_j AND over_ji)

over score-sorted candidates; iterating that equation from keep = valid
until it stops changing gives the sequential greedy result (a suppressed box
never suppresses; ties break by lowest index). Each sweep is one masked
any-reduction over the (K, K) overlap matrix, batched over samples; the loop
ends when no sample changed, which costs one host sync per sweep (typically
< 8 sweeps).
"""

from __future__ import annotations

import torch


def nms_fixpoint(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """over (B, K, K) bool, over[b, j, i]: higher-ranked j suppresses i;
    valid (B, K) bool -> keep (B, K) bool."""
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
    return keep
