"""Native (C++) point-cloud loading for the host data path — port of
``tpu_pillars/data/native_io.py``.

Wraps ``tpu_pillars_torch/native/pointcloud.cc`` via ctypes: one pass fuses
the .bin read, the detection-range crop, the feature-column select and the
static-budget padding (and, for multi-sweep, the rigid sweep -> keyframe
transform and the dt column). :func:`crop_pad` is the same pass over a cloud
already in memory, which ``detector.pad_points`` takes whenever the library
loads: it keeps a row when ``x >= x0 and x < x1 and y >= y0 and y < y1 and
z >= z0 and z <= z1`` (so a NaN or infinite coordinate drops it, as the numpy
mask of those comparisons does), and quantises the int16 wire in the same
pass as numpy does: value / scale in f32, rounded half to even
(``np.round``), clipped to +-32767, cast (NaN to 0, numpy's cast on x86-64).
This is a host loader, not a device kernel, so it keeps its numpy path, with
the same semantics:

* ``use_native=None``: the native library when it builds, else numpy;
* ``use_native=True``: the native library, or ``RuntimeError`` carrying
  the compiler's output;
* ``use_native=False``: numpy.

The library is compiled on first use with ``g++ -O3 -shared -fPIC`` into
the git-ignored ``tpu_pillars_torch/_build/``, under a name that carries a
hash of the source and the flags (as ``_build._target`` names the CUDA
libraries), so an unchanged tree never rebuilds and a changed one never
loads a stale library.

Both paths are bit-equal, also for multi-sweep: the numpy path transforms
each coordinate as ``((r0 * x + r1 * y) + r2 * z) + t`` in f32, one rounding
per operation, the C++ loop's order (no ``-march``, so no fused
multiply-add). The JAX package's numpy path uses a matmul there, whose
rounding depends on the BLAS; it agrees with both within 1e-5, and the
native paths of the two packages are the same code.

In-range points beyond ``max_points`` are dropped first-max_points and
recorded in ``utils.truncation.IO_TRUNCATION``, never silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.utils.truncation import IO_TRUNCATION

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "pointcloud.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + b"\0"
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpointcloud-{digest}.so"


def _build() -> ctypes.CDLL:
    """Compile (if missing) and load the library; raises with the
    compiler's output on failure."""
    out = _target()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++"] + GXX_FLAGS + [str(SRC), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} (rc {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.load_crop_pad.restype = ctypes.c_int64
    lib.load_crop_pad.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.load_transform_crop_pad.restype = ctypes.c_int64
    lib.load_transform_crop_pad.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.crop_pad.restype = ctypes.c_int64
    lib.crop_pad.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def _load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when its build failed (the compiler's
    output stays in :func:`native_error`). Tried once per process."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _build()
            except (RuntimeError, OSError, AttributeError) as e:
                # g++ failed or is missing, or the library did not load:
                # kept for use_native=True to raise with
                _error = f"{type(e).__name__}: {e}"
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def native_error() -> Optional[str]:
    """Why the native library is unavailable (the compiler's output), or
    None when it loaded or was not tried yet."""
    return _error


def _library(use_native: Optional[bool]) -> Optional[ctypes.CDLL]:
    if use_native is False:
        return None
    lib = _load_library()
    if lib is None and use_native:
        raise RuntimeError(f"native pointcloud library unavailable: "
                           f"{_error}")
    return lib


def _crop_array(config: PillarsConfig) -> np.ndarray:
    return np.asarray(
        [config.x_min, config.x_max, config.y_min, config.y_max,
         config.z_min, config.z_max], dtype=np.float32)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _in_range(x, y, z, config: PillarsConfig) -> np.ndarray:
    return ((x >= config.x_min) & (x < config.x_max)
            & (y >= config.y_min) & (y < config.y_max)
            & (z >= config.z_min) & (z <= config.z_max))


def load_points_padded(path: str, config: PillarsConfig,
                       in_stride: int = 5, pad_value: float = 1e6,
                       use_native: Optional[bool] = None):
    """.bin file -> ((max_points, num_raw_features) f32 padded, count).

    Already cropped to the detection range, so every surviving point lands
    in a pillar. In-range points beyond max_points are dropped
    first-max_points (file order) and recorded in IO_TRUNCATION."""
    n_take = config.num_raw_features
    out = np.full((config.max_points, n_take), pad_value, dtype=np.float32)
    lib = _library(use_native)
    if lib is not None:
        total = lib.load_crop_pad(
            path.encode(), in_stride, n_take, _fptr(out),
            config.max_points, _fptr(_crop_array(config)))
        if total < 0:
            raise FileNotFoundError(path)
        n = min(int(total), config.max_points)
        IO_TRUNCATION.record(total, n, label=path)
        return out, np.int32(n)
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, in_stride)
    m = _in_range(pts[:, 0], pts[:, 1], pts[:, 2], config)
    kept = pts[m][: config.max_points, :n_take]
    out[: len(kept)] = kept
    IO_TRUNCATION.record(int(m.sum()), len(kept), label=path)
    return out, np.int32(len(kept))


def crop_pad(points: np.ndarray, n_take: int, crop: Optional[np.ndarray],
             max_points: int, pad: float,
             scales: Optional[np.ndarray] = None):
    """In-memory cloud (N, >= n_take) -> ((max_points, n_take) padded,
    in-range count) in one native pass; the count may exceed max_points,
    and only the first max_points in-range rows are kept.

    crop: [x_min, x_max, y_min, y_max, z_min, z_max] (float32), or None to
    keep every row. scales: None for a float32 array padded with ``pad``;
    per-column scales for the int16 fixed-point wire, padded with 32767.
    Raises ``RuntimeError`` when the library is unavailable."""
    lib = _library(True)
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] < n_take:
        raise ValueError(f"points of shape {points.shape} have fewer than "
                         f"{n_take} columns")
    out = np.empty((max_points, n_take),
                   np.float32 if scales is None else np.int16)
    if crop is not None:
        crop = np.ascontiguousarray(crop, dtype=np.float32)
        if crop.shape != (6,):
            raise ValueError(f"crop has shape {crop.shape}, not (6,)")
    if scales is not None:
        scales = np.ascontiguousarray(scales, dtype=np.float32)
        if scales.shape != (n_take,):
            raise ValueError(f"scales have shape {scales.shape}, not "
                             f"({n_take},)")
    in_range = lib.crop_pad(
        _fptr(points), len(points), points.shape[1], n_take,
        None if crop is None else _fptr(crop), out.ctypes.data, max_points,
        pad, None if scales is None else _fptr(scales))
    return out, int(in_range)


def _transform(pts: np.ndarray, rt: np.ndarray) -> np.ndarray:
    """(N, >=3) f32 points -> (N, 3) f32, each coordinate
    ``((r0 * x + r1 * y) + r2 * z) + t`` rounded per operation, as the C++
    loop computes it."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack([rt[i, 0] * x + rt[i, 1] * y + rt[i, 2] * z + rt[i, 3]
                     for i in range(3)], axis=1)


def load_sweeps_padded(paths, transforms, dts, config: PillarsConfig,
                       in_stride: int = 5, pad_value: float = 1e6,
                       use_native: Optional[bool] = None):
    """Fused multi-sweep load: for each sweep i, apply the 3x4 [R|t] rigid
    map into the keyframe frame, crop, append dt — accumulated into one
    (max_points, num_raw_features + 1) padded array.

    transforms: list of (3, 4) float row-major arrays; dts: seconds per
    sweep. In-range points beyond the budget are dropped first-max_points
    (sweep order, then file order) and recorded in IO_TRUNCATION."""
    n_take = config.num_raw_features
    out = np.full((config.max_points, n_take + 1), pad_value, dtype=np.float32)
    lib = _library(use_native)
    written = 0
    in_range = 0
    if lib is not None:
        crop = _crop_array(config)
        for path, rt, dt in zip(paths, transforms, dts):
            rt32 = np.ascontiguousarray(rt, dtype=np.float32)
            n = lib.load_transform_crop_pad(
                path.encode(), in_stride, n_take, _fptr(rt32),
                ctypes.c_float(float(dt)), _fptr(out), config.max_points,
                _fptr(crop), written)
            if n < 0:
                raise FileNotFoundError(path)
            in_range += n
            written = min(written + n, config.max_points)
        IO_TRUNCATION.record(in_range, written,
                             label=f"{len(paths)}-sweep accumulation")
        return out, np.int32(written)
    for path, rt, dt in zip(paths, transforms, dts):
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, in_stride)
        xyz = _transform(pts, np.asarray(rt, np.float32))
        m = _in_range(xyz[:, 0], xyz[:, 1], xyz[:, 2], config)
        in_range += int(m.sum())
        keep = np.nonzero(m)[0][: config.max_points - written]
        rows = np.concatenate(
            [xyz[keep], pts[keep, 3:n_take],
             np.full((len(keep), 1), dt, np.float32)], axis=1)
        out[written: written + len(rows)] = rows
        written += len(rows)
    IO_TRUNCATION.record(in_range, written,
                         label=f"{len(paths)}-sweep accumulation")
    return out, np.int32(written)
