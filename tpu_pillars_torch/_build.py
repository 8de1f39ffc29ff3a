"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The build
runs on first use (so ``python3 chip_smoke.py`` alone builds everything),
all sources in parallel, into ``tpu_pillars_torch/_build/`` (git-ignored).
Each library's file name carries a hash of its source and flags, so an
unchanged tree never rebuilds.

Every wrapper launches through :func:`launch`, the one device guard: the
launch runs with its tensors' device as the current device, on that
device's current stream, so a tensor on ``cuda:1`` launches on ``cuda:1``
whatever the calling thread's current device is (when that device is
already current, it skips the guard). Every entry point returns the
``cudaError_t`` of its launch, and :func:`launch` raises on a non-zero
value. Kernels allocate nothing: the Python wrappers allocate outputs with
``torch``.

``LAUNCHES`` counts each kernel's launches. :func:`launch` adds one right
after a kernel launched, and nowhere else (a sidecar launch adds none) — so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# per-source extra flags: these kernels round every product on its own, as
# plain eager torch does (no fused multiply-add contraction), so each agrees
# with its plain version
EXTRA_FLAGS = {name: ["--fmad=false"] for name in (
    "fused_pfn", "nms_overlap", "assign", "pfn", "stream_pfn", "iou_tiled")}

KERNELS = ("emit", "fused_pfn", "bev_scatter", "nms_overlap", "assign", "pfn",
           "radix_sort", "binning", "bev_gather", "stream_pfn", "iou_tiled")
LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_libs: dict = {}
_paths: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of tpu_pillars_torch cannot be built")
    return found


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, []))
    digest = hashlib.sha256(src + b"\0" + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict:
    """Compile every kernel source whose library is missing, all ``nvcc``
    processes started together. Returns {name: library path}. Raises with
    the compiler's output if any build fails."""
    with _lock:
        todo = {n: _target(n) for n in KERNELS if n not in _paths}
        missing = {n: p for n, p in todo.items() if not p.exists()}
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, out in missing.items():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = ([nvcc] + NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
                       + ["-o", str(tmp), str(SRC_DIR / f"{name}.cu")])
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp)
            errors = []
            for name, (proc, tmp) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"--- nvcc {name}.cu (rc {proc.returncode})"
                                  f"\n{log}")
                else:
                    os.replace(tmp, missing[name])
            if errors:
                raise RuntimeError("CUDA kernel build failed:\n"
                                   + "\n".join(errors))
        _paths.update(todo)
        return dict(_paths)


def library(name: str):
    """The loaded ``ctypes.CDLL`` of kernel ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        import ctypes

        path = build_all()[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _libs[name] = lib
    return lib


def function(name: str, symbol: str, sig: str):
    """C entry ``symbol`` of kernel ``name``. ``sig`` spells its arguments
    before the trailing stream: ``p`` pointer, ``i`` int, ``f`` float.
    Returns a callable that returns the launch's ``cudaError_t``."""
    import ctypes

    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        fn.argtypes = [kinds[c] for c in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, symbol: str, sig: str, *args,
           count: bool = True) -> None:
    """Launch C entry ``symbol`` of kernel ``kernel`` (``sig`` as for
    :func:`function`) on ``args``: a tensor passes its data pointer, None a
    null pointer, anything else goes as it is. Every tensor must lie on one
    device; the launch runs with that device current (under
    ``torch.cuda.device`` unless it already is), on its current stream.
    Raises on a launch error; then adds one to ``LAUNCHES[kernel]`` unless
    ``count`` is false (a sidecar)."""
    import torch

    # one pass over the arguments: this runs on every launch, and the host
    # time of a wrapper is what a short kernel's caller waits on
    device = None
    ptrs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            d = a.device
            if device is None:
                device = d
            elif d != device:
                device = False
            ptrs.append(a.data_ptr())
        else:
            ptrs.append(a)
    if not device:
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        raise ValueError(f"{symbol}: the tensors lie on "
                         f"{sorted(map(str, devices))}, not on one device")
    fn = function(kernel, symbol, sig)
    if device.type == "cuda" and device.index == torch.cuda.current_device():
        # already current: no guard, and the stream's raw handle without a
        # Stream object (the two cost more host time than a short kernel)
        err = fn(*ptrs, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} at launch")
    if count:
        LAUNCHES[kernel] += 1
