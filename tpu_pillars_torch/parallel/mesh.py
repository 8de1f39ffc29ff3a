"""The data-parallel process model: one process per rank, a 1-D mesh over
the ranks, and the collectives that the JAX package gets from a mesh axis.
Port of ``tpu_pillars/parallel/mesh.py``.

JAX runs one process over N devices; torch runs one process per rank.
:func:`launch` starts the ranks (start method ``spawn``: a fork is unsafe
once CUDA is initialised), joins them into one ``torch.distributed`` group
through a ``FileStore`` in a temporary directory (no fixed port), runs a
function on each and returns rank 0's result. The group's backend is NCCL
only when every rank has a card of its own; otherwise gloo, on the CPU and
for ranks that share a card (NCCL refuses two ranks on one device). Gloo
reduces a CUDA tensor through the host, so the collectives here stage it
there themselves. The group has a bounded ``timeout``, and the launcher
kills every rank as soon as one fails or dies, so no rank is left blocked
in a collective. A SIGTERM to the launcher is passed on to every rank,
whose training loop then stops at the same step (the ranks sit in a
process group of their own, so a signal sent to the launcher's group
reaches each rank once).

Inside a rank, :func:`make_mesh` / :func:`make_mesh_n` return the rank's
view (:class:`Mesh`: rank, size, device, group and axis name;
``mesh.devices.size`` is the mesh size, as in JAX).

:meth:`Mesh.psum` and :meth:`Mesh.pmean` are differentiable: their
backward sums (or averages) the cotangents over the ranks, the transpose
that JAX's ``psum`` gets under ``shard_map``, so a rank's gradient carries
the other ranks' losses through shared batch statistics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the bound on one collective: a rank whose peer is gone raises after it
COLLECTIVE_TIMEOUT_S = 300.0

# set in a rank by :func:`launch`: every rank's device, in rank order
_LAUNCHED: Optional[List[str]] = None


class _PSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents over them."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a 1-D data-parallel mesh, and its collectives.

    devices: every rank's device name in rank order (an array, so that
    ``devices.size`` is the mesh size); rank: this process's rank; device:
    its ``torch.device``; axis_name: the JAX axis name it stands for;
    group: the ``torch.distributed`` group; host_staged: collectives copy
    CUDA tensors through the host (gloo)."""

    devices: np.ndarray
    rank: int
    device: torch.device
    axis_name: str = "data"
    group: object = None
    host_staged: bool = False

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def check_axis(self, axis_name: str) -> None:
        """Raise unless ``axis_name`` names this mesh's axis."""
        if axis_name != self.axis_name:
            raise ValueError(f"axis {axis_name!r} is not the mesh's "
                             f"{self.axis_name!r}")

    def all_reduce_(self, t: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the ranks (a sum by default), in place;
        returns ``t``. No autograd."""
        if self.host_staged:
            host = t.cpu()
            dist.all_reduce(host, op=op, group=self.group)
            return t.copy_(host)
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's ``lax.psum``: the sum over the ranks, whose backward sums
        the cotangents over the ranks."""
        return _PSum.apply(x, self)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's ``lax.pmean``: :meth:`psum` over the mesh size."""
        return self.psum(x) / self.size

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's tiled ``all_gather`` on axis 0: every rank's ``x``
        concatenated in rank order, on every rank. No autograd."""
        src = x.cpu() if self.host_staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(x.device)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on one."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        return bool(self.all_reduce_(t, dist.ReduceOp.MAX).item())


def _backend_for(devices: Sequence[str]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devs)
                 and len({d.index for d in devs}) == len(devs))
    return "nccl" if own_cards else "gloo"


def mesh_devices(n: int, device=None) -> List[str]:
    """The devices of an ``n``-rank mesh: the first ``n`` cards for
    ``device`` None or "cuda" (SystemExit, with the JAX package's message,
    when fewer are visible); ``n`` CPU ranks for "cpu"; ``n`` ranks sharing
    one card for "cuda:k"."""
    d = torch.device(device if device is not None else "cuda")
    if d.type == "cpu":
        return ["cpu"] * n
    if d.type != "cuda":
        raise ValueError(f"a mesh runs on 'cpu' or CUDA devices, got {d}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if d.index is None:
        if visible < n:
            raise SystemExit(f"requested {n} devices, only {visible} "
                             f"visible (backend: cuda)")
        return [f"cuda:{i}" for i in range(n)]
    if d.index >= visible:
        raise SystemExit(f"requested {d}, only {visible} visible "
                         f"(backend: cuda)")
    return [str(d)] * n


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "data") -> Mesh:
    """The calling rank's view of a 1-D mesh over ``devices`` (default:
    the devices :func:`launch` started the ranks on), inside a launched
    group only."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh runs one process per rank: start the "
                           "ranks with tpu_pillars_torch.parallel.launch")
    devices = [str(torch.device(d)) for d in (devices or _LAUNCHED)]
    if len(devices) != dist.get_world_size():
        raise ValueError(f"{len(devices)} devices for a group of "
                         f"{dist.get_world_size()} ranks")
    rank = dist.get_rank()
    device = torch.device(devices[rank])
    return Mesh(np.asarray(devices), rank, device, axis_name,
                group=dist.group.WORLD,
                host_staged=(dist.get_backend() == "gloo"
                             and device.type == "cuda"))


def make_mesh_n(n: int, axis_name: str = "data", device=None) -> Mesh:
    """The calling rank's view of a mesh over the first ``n`` devices of
    :func:`mesh_devices`; raises SystemExit with a clear message when fewer
    cards are visible (the CLI ``--dp N`` contract)."""
    return make_mesh(mesh_devices(n, device), axis_name)


def local_shard(arrays, mesh: Mesh) -> tuple:
    """This rank's slice of a global batch (a sequence of numpy arrays or
    tensors with the batch first): rows [rank * B/R, (rank + 1) * B/R) of
    each, as JAX's batch sharding over the mesh axis splits them. B must
    divide by the mesh size."""
    B = len(arrays[0])
    if B % mesh.size:
        raise ValueError(f"batch {B} does not divide over {mesh.size} ranks")
    k = B // mesh.size
    return tuple(x[mesh.rank * k:(mesh.rank + 1) * k] for x in arrays)


# ---- the launcher ----------------------------------------------------------

class RemoteTraceback(Exception):
    """The traceback of an exception raised in a rank (its ``__cause__``)."""


def _unpickled(exc_bytes, tb: str) -> BaseException:
    try:
        return pickle.loads(exc_bytes)
    except Exception:
        return RuntimeError(tb.strip().splitlines()[-1])


def _exit_with(parent: int) -> None:
    """End this process when its parent is gone (a killed launcher)."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(rank: int, devices: List[str], store_path: str,
               fn: Callable, args: tuple, results, parent: int,
               threads: int) -> None:
    global _LAUNCHED
    _exit_with(parent)
    # signals come from the launcher alone (a signal to its process group
    # would otherwise reach a rank twice)
    os.setpgrp()
    try:
        # every rank runs on this host: gloo connects over the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            # the CPU ranks share the launcher's intra-op threads
            torch.set_num_threads(threads)
        _LAUNCHED = list(devices)
        dist.init_process_group(
            _backend_for(devices),
            store=dist.FileStore(store_path, len(devices)),
            rank=rank, world_size=len(devices),
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = fn(*args)
        # pickled here, so that a result that does not pickle is an error
        results.put((rank, True, pickle.dumps(out if rank == 0 else None)))
    except BaseException as exc:
        try:
            exc_bytes = pickle.dumps(exc)
        except Exception:
            exc_bytes = None
        results.put((rank, False, (exc_bytes, traceback.format_exc())))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, args: tuple = (),
           timeout: Optional[float] = None):
    """Run ``fn(*args)`` in one spawned process per entry of ``devices``
    (rank r on ``devices[r]``; a card may be named more than once) joined
    in one ``torch.distributed`` group, and return rank 0's return value.
    ``fn``, ``args`` and rank 0's result must pickle.

    When a rank raises, the others are killed and its exception is raised
    here (the rank's traceback as its ``__cause__``); when a rank dies
    without a result, or ``timeout`` seconds pass (None: no deadline), the
    ranks are killed and this raises. A collective waits at most
    ``COLLECTIVE_TIMEOUT_S`` for its peers. A SIGTERM that reaches this
    process while it waits is sent on to every rank. Every process started
    here is stopped before this returns. The CPU ranks share the caller's
    intra-op threads (``torch.get_num_threads()``) equally.
    Call it from the main thread (it sets a signal handler)."""
    devices = [str(torch.device(d)) for d in devices]
    threads = max(1, torch.get_num_threads() // len(devices))
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tpu_pillars_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, devices, os.path.join(tmp, "store"), fn, tuple(args),
              results, os.getpid(), threads))
        for r in range(len(devices))]
    deadline = None if timeout is None else time.monotonic() + timeout

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                with contextlib.suppress(ProcessLookupError):
                    os.kill(p.pid, signum)

    previous = signal.signal(signal.SIGTERM, forward)
    try:
        for p in procs:
            p.start()
        out, done, dead_since = None, set(), {}
        while len(done) < len(procs):
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in done or p.exitcode in (None, 0):
                        continue
                    # a rank's last message may still be in the pipe
                    if now - dead_since.setdefault(r, now) > 2.0:
                        raise RuntimeError(
                            f"rank {r} exited with code {p.exitcode} "
                            f"without a result")
                if deadline is not None and now > deadline:
                    raise TimeoutError(
                        f"{len(procs) - len(done)} of {len(procs)} ranks "
                        f"gave no result within {timeout} s")
                continue
            if not ok:
                raise _unpickled(*payload) from RemoteTraceback(
                    f"in rank {rank}:\n{payload[1]}")
            done.add(rank)
            if rank == 0:
                out = pickle.loads(payload)
        for p in procs:
            p.join(timeout=30)
        return out
    finally:
        signal.signal(signal.SIGTERM, previous)
        for p in procs:
            if p.pid is not None and p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
