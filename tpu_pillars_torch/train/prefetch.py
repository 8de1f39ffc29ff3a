"""Asynchronous input pipeline — port of ``tpu_pillars/train/prefetch.py``.

* ``prefetch(it, size)`` runs an iterator in one background producer
  thread with a bounded queue, so host batch construction (file reads,
  padding) overlaps the device work the consumer launches. It yields
  exactly the producer's sequence; a producer exception re-raises where
  the failed item would have appeared; closing the generator stops the
  producer.
* ``device_prefetch(batches, size, device)`` is ``prefetch`` with each
  batch moved ``.to(device, non_blocking=True)`` in the producer thread.

Threads, not processes: the per-batch host work is numpy and file I/O,
which release the interpreter lock.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_END = object()


def prefetch(iterable: Iterable[T], size: int = 2) -> Iterator[T]:
    """Yield ``iterable`` unchanged, produced ahead by a background thread.

    ``size`` bounds how many ready items may wait in the queue. The
    producer stops promptly when the consumer closes the generator (or it
    is garbage-collected)."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(size)))
    stop = threading.Event()
    failure: list = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce() -> None:
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            failure.append(e)
        finally:
            _put(_END)

    t = threading.Thread(target=_produce, daemon=True,
                         name="tpu-pillars-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


def _to_device(x, device):
    """Move a batch — tensors and numpy arrays, in tuples (named or not),
    lists and dicts — to ``device``; other leaves pass through."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device, non_blocking=True)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, device) for v in x)
    return x


def device_prefetch(batches: Iterable[T], size: int = 2,
                    device=None) -> Iterator[T]:
    """``prefetch``, with each batch moved to ``device`` (None: the card,
    as ``detector.resolve_device``) in the producer thread, so the consumer
    receives device tensors."""
    from tpu_pillars_torch.detector import resolve_device

    dev = resolve_device(device)

    def _staged() -> Iterator[T]:
        for b in batches:
            yield _to_device(b, dev)

    return prefetch(_staged(), size=size)
