"""K10: the per-sample stable sort of pillar ids, payload carried.

Port of ``tpu_pillars/ops/sort_pallas.py`` (``_sort_batched``,
``sort_points_by_pillar_bitonic``): a drop-in for
``ops.voxelize.sort_points_by_pillar`` that gives the same keys and rows bit
for bit. The JAX kernel is a bitonic network with a lexicographic (key,
index) comparator, which makes every element unique, so its result is
exactly the stable order; the names keep the JAX ones.

On a CUDA tensor :func:`bitonic_sort` is a radix sort: it launches
``csrc/radix_sort.cu``, a stable LSD radix sort (Onesweep: an upfront
histogram, one pass per digit with decoupled look-back, the payload
gathered once through the order), which gives the same stable order. On a
CPU tensor it runs :func:`bitonic_sort_plain`, the JAX network written in
torch ops (each sample padded to a power of two with INT32_MAX keys, which
sort after every real key). ``torch.sort`` is the yardstick, not the plain
version.
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


def bitonic_sort(key: torch.Tensor, payload=None, key_bits: int = 32):
    """key (B, M) int32, payload (B, M, F) f32 or None -> (key_sorted
    (B, M) int32 ascending per sample, order (B, M) int32 — the stable
    permutation, payload_sorted (B, M, F) or None).

    ``key_bits`` (1..32): the keys are known to lie in ``[0,
    2**key_bits)``; 32 takes any int32, negatives and INT32_MAX included.
    PRECONDITION for ``key_bits < 32``: no key outside that range (not
    checked here: that would need a sync with the card); the radix kernel
    sorts only the low ``key_bits`` bits. Fewer bits are fewer passes."""
    _check(key, payload)
    if not isinstance(key_bits, int) or not 1 <= key_bits <= 32:
        raise ValueError(f"bitonic_sort wants key_bits in 1..32, got "
                         f"{key_bits!r}")
    if key.device.type == "cpu":
        return bitonic_sort_plain(key, payload)
    B, M = key.shape
    if M >= 2**30:
        raise ValueError(f"bitonic_sort takes fewer than 2^30 keys per "
                         f"sample, got {M}")
    F = payload.shape[2] if payload is not None else 0
    k = key.contiguous()
    pay = payload.contiguous() if payload is not None else None
    key_out = torch.empty_like(k)
    order = torch.empty_like(k)
    pay_out = torch.empty_like(pay) if pay is not None else None
    scratch = torch.empty(_radix_scratch_bytes(B, M, key_bits),
                          dtype=torch.uint8, device=k.device)
    _build.launch("radix_sort", "radix_sort", "ppppppiiii", k, pay, key_out,
                  order, pay_out, scratch, B, M, F, key_bits)
    return key_out, order, pay_out


def _radix_scratch_bytes(batch: int, m: int, key_bits: int) -> int:
    """Bytes of scratch the radix kernel needs (its own layout)."""
    import ctypes

    fn = _build.library("radix_sort").radix_sort_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(batch, m, key_bits))


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
    ``torch.gather`` follows the sort. Both give the same rows. The sort
    takes ``(H*W).bit_length()`` key bits (18 at ``PillarsConfig()``),
    exact because the ids never exceed the sentinel H*W."""
    pid = pillar_ids(points, num_points, config)
    key_bits = (config.grid_h * config.grid_w).bit_length()
    gid, order, pts = bitonic_sort(pid, points if carry_payload else None,
                                   key_bits=key_bits)
    if pts is None:
        F = points.shape[-1]
        pts = torch.gather(points, 1, order.long()[..., None].expand(-1, -1,
                                                                     F))
    return gid, pts
