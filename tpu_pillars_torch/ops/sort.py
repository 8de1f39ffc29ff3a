"""K10 bitonic sort: the per-sample stable sort of pillar ids, payload
carried.

Port of ``tpu_pillars/ops/sort_pallas.py`` (``_sort_batched``,
``sort_points_by_pillar_bitonic``): a drop-in for
``ops.voxelize.sort_points_by_pillar`` that gives the same keys and rows bit
for bit. A bitonic network is not stable by itself; comparing (key, index)
lexicographically makes every element unique, so the network's result is
exactly the stable order. Each sample is padded to a power of two with
INT32_MAX keys, which sort after every real key.

On a CUDA tensor :func:`bitonic_sort` launches the hand-written kernel
(``csrc/bitonic_sort.cu``: 64-bit (key, index) composites, shared-memory
tiles for the small strides, global passes for the large ones, the payload
gathered once through the order); on a CPU tensor it runs
:func:`bitonic_sort_plain`, the same network written in torch ops.
``torch.sort`` is the yardstick, not the plain version.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.voxelize import pillar_ids

INT32_MAX = 2**31 - 1


def padded_size(m: int) -> int:
    """The network's per-sample size: the power of two >= max(m, 2)."""
    return max(2, 1 << (m - 1).bit_length())


def _check(key, payload):
    if key.dtype != torch.int32 or key.dim() != 2:
        raise TypeError(f"bitonic_sort wants (B, M) int32 keys, got "
                        f"{key.dtype} {tuple(key.shape)}")
    if payload is not None:
        if payload.dtype != torch.float32 or payload.dim() != 3 \
                or payload.shape[:2] != key.shape:
            raise ValueError(f"bitonic_sort wants a (B, M, F) float32 "
                             f"payload, got {payload.dtype} "
                             f"{tuple(payload.shape)}")
        if payload.device != key.device:
            raise ValueError("keys and payload lie on different devices")


def bitonic_sort(key: torch.Tensor, payload=None):
    """key (B, M) int32, payload (B, M, F) f32 or None -> (key_sorted
    (B, M) int32 ascending per sample, order (B, M) int32 — the stable
    permutation, payload_sorted (B, M, F) or None)."""
    _check(key, payload)
    if key.device.type != "cuda":
        return bitonic_sort_plain(key, payload)
    B, M = key.shape
    F = payload.shape[2] if payload is not None else 0
    mp = padded_size(M)
    k = key.contiguous()
    pay = payload.contiguous() if payload is not None else None
    key_out = torch.empty_like(k)
    order = torch.empty_like(k)
    pay_out = torch.empty_like(pay) if pay is not None else None
    scratch = torch.empty((B, mp), dtype=torch.int64, device=k.device)
    fn = _build.function("bitonic_sort", "bitonic_sort", "ppppppiiii")
    err = fn(k.data_ptr(), pay.data_ptr() if pay is not None else None,
             key_out.data_ptr(), order.data_ptr(),
             pay_out.data_ptr() if pay_out is not None else None,
             scratch.data_ptr(), B, M, mp, F, _build.stream_ptr(k))
    _build.check(err, "bitonic_sort")
    _build.LAUNCHES["bitonic_sort"] += 1
    return key_out, order, pay_out


def bitonic_sort_plain(key: torch.Tensor, payload=None):
    """Plain PyTorch version of :func:`bitonic_sort`: the JAX kernel's
    network — for size = 2, 4, .., M and stride = size/2, .., 1 each element
    meets its partner i ^ stride, ascending where (i & size) == 0, with the
    lexicographic (key, index) comparator; the payload rides the same swap
    decisions."""
    _check(key, payload)
    B, M = key.shape
    mp = padded_size(M)
    dev = key.device
    k = torch.cat([key, torch.full((B, mp - M), INT32_MAX, dtype=torch.int32,
                                   device=dev)], dim=1)
    idx = torch.arange(mp, dtype=torch.int32, device=dev).expand(B, mp)
    pay = None
    if payload is not None:
        pay = torch.cat([payload, torch.zeros(
            (B, mp - M, payload.shape[2]), dtype=payload.dtype, device=dev)],
            dim=1)
    i = torch.arange(mp, device=dev)
    size = 2
    while size <= mp:
        asc = (i & size) == 0
        stride = size // 2
        while stride >= 1:
            partner = i ^ stride
            pk, pi = k[:, partner], idx[:, partner]
            gt = (k > pk) | ((k == pk) & (idx > pi))
            take = gt == (asc == ((i & stride) == 0))
            k = torch.where(take, pk, k)
            idx = torch.where(take, pi, idx)
            if pay is not None:
                pay = torch.where(take[..., None], pay[:, partner], pay)
            stride //= 2
        size *= 2
    return (k[:, :M], idx[:, :M],
            pay[:, :M] if pay is not None else None)


def sort_points_by_pillar_bitonic(points: torch.Tensor,
                                  num_points: torch.Tensor,
                                  config: PillarsConfig,
                                  carry_payload: bool = True):
    """Drop-in for ``ops.voxelize.sort_points_by_pillar``: (B, M, F)
    points -> (gid_sorted (B, M) int32 ascending per sample with H*W as the
    invalid sentinel, pts_sorted (B, M, F)), bit-identical to the stable
    ``torch.sort`` path. ``carry_payload`` hands the points to the sort
    (on the card the kernel gathers them through the order); otherwise one
    ``torch.gather`` follows the sort. Both give the same rows."""
    pid = pillar_ids(points, num_points, config)
    gid, order, pts = bitonic_sort(pid, points if carry_payload else None)
    if pts is None:
        F = points.shape[-1]
        pts = torch.gather(points, 1, order.long()[..., None].expand(-1, -1,
                                                                     F))
    return gid, pts
