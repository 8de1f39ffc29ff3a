"""tpu_pillars_torch's host pad and crop (``detector.pad_points``) on the
CPU: its one native pass (``data.native_io.crop_pad``, built from
``native/pointcloud.cc``) against its numpy path, byte for byte.

* One parametrised test over every wire (f32, f16, int16) and the inputs
  that reach the pass: host crop on and off, wire buckets, a cloud over
  ``max_points`` (the truncation record too), the 5-column multi-sweep
  config, extra columns, rows on each bound of the crop box and just past
  it, NaN and +-inf in every column, an empty cloud, float64, strided and
  Fortran-ordered input; and the int16 wire's rounding ties and clip.
* A library that does not build: ``pad_points`` takes the numpy path and
  gives the same bytes.
* The counters ``detector.pad_native`` and ``detector.pad_numpy`` count
  each sweep by the path that padded it, only while tracing is on.

The parity of ``pad_points`` with the JAX package's is in
tests/test_torch_detector.py and tests/test_torch_serving.py.
"""

import warnings

import numpy as np
import pytest

from tpu_pillars_torch.config import tiny_config
from tpu_pillars_torch.data import native_io
from tpu_pillars_torch.detector import int16_wire_scales, pad_points
from tpu_pillars_torch.utils import profiling
from tpu_pillars_torch.utils.truncation import TruncationStats

CFG = tiny_config(max_points=2048)
MULTI = tiny_config(max_points=2048, num_sweeps=3)
WIRES = {"f32": np.float32, "f16": np.float16, "int16": np.int16}
CASES = ["crop", "no_crop", "buckets", "over_budget", "multisweep",
         "extra_columns", "bounds", "empty", "float64", "strided",
         "fortran"]


def _cloud(rng, cfg, n, cols=None):
    """(n, cols) f32: coordinates within and up to 5 m beyond the range,
    intensity 0-255, the dt column in [0, 0.5]."""
    cols = cols or cfg.num_input_features
    pts = rng.uniform(0.0, 1.0, (n, cols)).astype(np.float32)
    lo = np.asarray([cfg.x_min, cfg.y_min, cfg.z_min]) - 5
    hi = np.asarray([cfg.x_max, cfg.y_max, cfg.z_max]) + 5
    pts[:, :3] = rng.uniform(lo, hi, (n, 3))
    pts[:, 3] = rng.uniform(0, 255, n)
    if cols > 4:
        pts[:, 4:] = rng.uniform(0, 0.5, (n, cols - 4))
    return pts


def _bound_rows(cfg):
    """Rows on each bound of the host crop box (x_min, the grid-derived
    upper x and y bounds plus a voxel, y_min, z_min, z_max) as float32, one
    float32 step either side, and NaN and +-inf in every column."""
    f32 = np.float32
    xh = cfg.x_min + (cfg.grid_w + 1) * cfg.voxel_x
    yh = cfg.y_min + (cfg.grid_h + 1) * cfg.voxel_y
    inside = np.asarray([1.0, -2.0, 0.0, 7.0] + [0.25] * (
        cfg.num_input_features - 4), f32)
    rows = []
    for col, bound in ((0, cfg.x_min), (0, xh), (1, cfg.y_min), (1, yh),
                       (2, cfg.z_min), (2, cfg.z_max)):
        b = f32(bound)
        for v in (np.nextafter(b, f32(-np.inf)), b,
                  np.nextafter(b, f32(np.inf))):
            r = inside.copy()
            r[col] = v
            rows.append(r)
    for col in range(len(inside)):
        for v in (np.nan, np.inf, -np.inf):
            r = inside.copy()
            r[col] = v
            rows.append(r)
    return np.stack(rows)


def _inputs(case, rng):
    """-> (config, points, pad_points keywords) of a case."""
    if case == "multisweep":
        return MULTI, np.concatenate(
            [_cloud(rng, MULTI, 900), _bound_rows(MULTI)]), {}
    cloud = _cloud(rng, CFG, 900)
    if case == "no_crop":
        return CFG, np.concatenate([cloud, _bound_rows(CFG)]), {
            "host_crop": False}
    if case == "buckets":
        return CFG, cloud[:700], {"buckets": (256, 1024, CFG.max_points)}
    if case == "over_budget":
        return CFG, _cloud(rng, CFG, 12000), {}
    if case == "extra_columns":
        return CFG, _cloud(rng, CFG, 900, cols=7), {}
    if case == "bounds":
        return CFG, np.concatenate([_bound_rows(CFG), cloud[:50]]), {}
    if case == "empty":
        return CFG, np.zeros((0, 4), np.float32), {}
    if case == "float64":
        return CFG, cloud.astype(np.float64) + 1e-9, {}
    if case == "strided":
        wide = np.repeat(cloud, 2, axis=1)
        return CFG, wide[:, ::2], {}
    if case == "fortran":
        return CFG, np.asfortranarray(cloud), {}
    return CFG, cloud, {}


def _pad(cfg, points, wire, **kw):
    tr = TruncationStats()
    if wire == "int16" and "scales" not in kw:
        kw["scales"] = int16_wire_scales(cfg)
    with warnings.catch_warnings():
        # the truncation warning, and numpy's cast of NaN to int16
        warnings.simplefilter("ignore", RuntimeWarning)
        out, n = pad_points(points, cfg, tr, wire_np=WIRES[wire], **kw)
    return out, n, (tr.clouds, tr.truncated_clouds, tr.dropped_points,
                    tr.last_dropped)


def _numpy_pad(monkeypatch, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(native_io, "_load_library", lambda: None)
        return _pad(*args, **kw)


def _assert_same(got, want):
    (g, gn, gt), (w, wn, wt) = got, want
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()
    assert (gn, gt) == (wn, wt) and gn.dtype == wn.dtype == np.int32


@pytest.mark.parametrize("case,wire", [(c, w) for c in CASES for w in WIRES]
                         + [("int16_ties", "int16")])
def test_native_pad_is_bit_identical_to_numpy(case, wire, monkeypatch):
    """Same dtype, shape, bytes, count and truncation record on both
    paths."""
    assert native_io.native_available(), native_io.native_error()
    rng = np.random.default_rng(sum(map(ord, case + wire)))
    if case == "int16_ties":
        # scale 1: ties round to even, values past +-32767 clip, NaN -> 0
        cfg = CFG
        vals = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49999, 32766.5,
                           32767.5, -32767.5, 1e9, -1e9, np.inf, -np.inf,
                           np.nan, -0.0], np.float32)
        points = np.zeros((len(vals), 4), np.float32)
        points[:, 3] = vals
        kw = {"scales": np.ones(4, np.float32)}
    else:
        cfg, points, kw = _inputs(case, rng)
    got = _pad(cfg, points, wire, **kw)
    want = _numpy_pad(monkeypatch, cfg, points, wire, **kw)
    _assert_same(got, want)
    out, n, record = got
    m = cfg.max_points
    if case == "buckets":
        m = next(b for b in kw["buckets"] if b >= n)
        assert m < cfg.max_points
    assert out.shape == (m, cfg.num_input_features)
    if case == "over_budget":
        assert n == cfg.max_points and record[1] == 1 and record[2] > 0
    if case in ("bounds", "multisweep"):
        # of each bound's three rows the outer one drops (the upper x and
        # y bounds are exclusive, z_max inclusive), and every NaN and
        # infinite coordinate drops
        assert 0 < n < len(points)
    if case == "empty":
        assert n == 0
    if case == "int16_ties":
        assert out[:n, 3].tolist() == [0, 2, 2, 0, -2, -2, 3, 32766, 32767,
                                       -32767, 32767, -32767, 32767, -32767,
                                       0, 0]


def test_pad_falls_back_to_numpy_when_the_library_does_not_build(
        monkeypatch, tmp_path):
    """A source that does not compile: ``pad_points`` takes the numpy path
    and gives the native path's bytes."""
    cfg, points, kw = _inputs("bounds", np.random.default_rng(3))
    want = _pad(cfg, points, "int16", **kw)
    bad = tmp_path / "pointcloud.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native_io, "SRC", bad)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", None)
    got = _pad(cfg, points, "int16", **kw)
    assert not native_io.native_available()
    assert "error" in native_io.native_error()
    _assert_same(got, want)


def test_pad_counters_count_each_sweep_by_path(monkeypatch):
    """``detector.pad_native`` / ``detector.pad_numpy``: one a sweep, by
    the path that padded it, while tracing is on and at no other time."""
    rng = np.random.default_rng(4)
    clouds = [_cloud(rng, CFG, 300) for _ in range(3)]
    profiling.disable()
    profiling.reset()
    try:
        for c in clouds:
            _pad(CFG, c, "f32")
        assert profiling.summary()["counters"] == {}
        profiling.enable()
        for c in clouds:
            _pad(CFG, c, "f32")
        for c in clouds[:2]:
            _numpy_pad(monkeypatch, CFG, c, "f16")
        assert profiling.summary()["counters"] == {
            "detector.pad_native": 3, "detector.pad_numpy": 2}
    finally:
        profiling.disable()
        profiling.reset()
