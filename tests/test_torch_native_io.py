"""tpu_pillars_torch's native sweep loader (``data/native_io.py``, its copy
of ``native/pointcloud.cc``) and ``LyftDataset._sweep_chain`` /
``load_sweeps_padded``, on the CPU.

* The cases of tests/test_native_io.py on the port: the library compiles
  (with ``g++`` into ``tpu_pillars_torch/_build/``), native equals numpy
  (single and multi-sweep, bit for bit), crop semantics, overflow counted.
* tests/test_lyft_data.py's fused multi-sweep load against the python
  ``load_sweeps`` + crop.
* Parity with the JAX package on the same files: ``load_points_padded``,
  ``load_sweeps_padded`` and ``_sweep_chain`` bit-equal, and the JAX numpy
  path (a matmul) within its own test's 1e-5.
* ``use_native=True`` raises with the compiler's output when the build
  fails; ``None`` then takes the numpy path.
"""

import numpy as np
import pytest

from tpu_pillars_torch.config import tiny_config
from tpu_pillars_torch.data import native_io
from tpu_pillars_torch.data.fixture import build_fixture
from tpu_pillars_torch.data.lyft import LyftDataset
from tpu_pillars_torch.utils.truncation import IO_TRUNCATION

CFG = tiny_config(max_points=2048)


def _rt(theta, t):
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return np.hstack([R, np.asarray(t, np.float32).reshape(3, 1)])


RT0 = _rt(0.0, (0, 0, 0))
RT1 = _rt(0.2, (1.0, -0.5, 0.1))


@pytest.fixture(scope="module")
def bin_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    n = 3000
    pts = np.zeros((n, 5), np.float32)
    pts[:, 0] = rng.uniform(CFG.x_min - 10, CFG.x_max + 10, n)
    pts[:, 1] = rng.uniform(CFG.y_min - 10, CFG.y_max + 10, n)
    pts[:, 2] = rng.uniform(CFG.z_min - 2, CFG.z_max + 2, n)
    pts[:, 3] = rng.uniform(0, 255, n)
    pts[:, 4] = rng.integers(0, 64, n)
    path = tmp_path_factory.mktemp("bins") / "sweep.bin"
    pts.tofile(str(path))
    return str(path), pts


@pytest.fixture(scope="module")
def sweep_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("lyft_sweeps")
    return LyftDataset(build_fixture(str(root), tiny_config(), num_scenes=1,
                                     samples_per_scene=3,
                                     sweeps_per_sample=3, seed=2))


def _in_range(raw, cfg):
    return ((raw[:, 0] >= cfg.x_min) & (raw[:, 0] < cfg.x_max)
            & (raw[:, 1] >= cfg.y_min) & (raw[:, 1] < cfg.y_max)
            & (raw[:, 2] >= cfg.z_min) & (raw[:, 2] <= cfg.z_max))


def test_native_compiles():
    assert native_io.native_available(), native_io.native_error()
    assert native_io.native_error() is None
    lib = native_io._target()
    assert lib.exists() and lib.parent == native_io.BUILD_DIR
    assert lib.name.startswith("libpointcloud-") and lib.suffix == ".so"


def test_native_matches_numpy(bin_file):
    path, _ = bin_file
    out_n, n_n = native_io.load_points_padded(path, CFG, use_native=True)
    out_p, n_p = native_io.load_points_padded(path, CFG, use_native=False)
    assert n_n == n_p > 0
    assert out_n.dtype == out_p.dtype == np.float32
    np.testing.assert_array_equal(out_n, out_p)


def test_crop_semantics(bin_file):
    path, raw = bin_file
    out, n = native_io.load_points_padded(path, CFG)
    kept = out[:n]
    assert np.all(kept[:, 0] >= CFG.x_min) and np.all(kept[:, 0] < CFG.x_max)
    assert np.all(kept[:, 2] >= CFG.z_min) and np.all(kept[:, 2] <= CFG.z_max)
    assert n == min(_in_range(raw, CFG).sum(), CFG.max_points)
    assert np.all(out[n:] == 1e6)


def test_multisweep_native_matches_numpy(bin_file):
    """Two sweeps, the keyframe and a rotated, translated one: bit-equal
    (the numpy path rounds as the C++ loop does), dt column per sweep."""
    path, _ = bin_file
    args = ([path, path], [RT0, RT1], [0.0, 0.1])
    out_n, n_n = native_io.load_sweeps_padded(*args, CFG, use_native=True)
    out_p, n_p = native_io.load_sweeps_padded(*args, CFG, use_native=False)
    assert n_n == n_p > 0
    np.testing.assert_array_equal(out_n, out_p)
    kept = out_n[:n_n]
    assert set(np.unique(kept[:, 4])) == {np.float32(0.0), np.float32(0.1)}


def test_overflow_is_counted_not_silent(bin_file):
    path, raw = bin_file
    m = _in_range(raw, CFG)
    in_range = int(m.sum())
    small = tiny_config(max_points=max(8, in_range // 2))
    assert in_range > small.max_points  # the fixture must actually overflow

    for use_native in (True, False):
        IO_TRUNCATION.reset()
        with pytest.warns(RuntimeWarning, match="exceed the static"):
            out, n = native_io.load_points_padded(path, small,
                                                  use_native=use_native)
        assert n == small.max_points
        assert IO_TRUNCATION.last_dropped == in_range - small.max_points
        assert IO_TRUNCATION.truncated_clouds == 1
        expect = raw[m][: small.max_points, : small.num_raw_features]
        np.testing.assert_array_equal(out[:n], expect)

    for use_native in (True, False):
        IO_TRUNCATION.reset()
        with pytest.warns(RuntimeWarning, match="2-sweep accumulation"):
            out, n = native_io.load_sweeps_padded(
                [path, path], [RT0, RT0], [0.0, 0.1], small,
                use_native=use_native)
        assert n == small.max_points
        assert IO_TRUNCATION.last_dropped == 2 * in_range - small.max_points

    IO_TRUNCATION.reset()
    native_io.load_points_padded(path, CFG)
    assert IO_TRUNCATION.last_dropped == 0
    assert IO_TRUNCATION.truncated_clouds == 0


def test_missing_file_raises(tmp_path):
    missing = str(tmp_path / "nope.bin")
    for use_native in (True, False):
        with pytest.raises((FileNotFoundError, OSError)):
            native_io.load_points_padded(missing, CFG, use_native=use_native)


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path,
                                                   bin_file):
    """A source that does not compile: ``use_native=True`` raises with
    g++'s message, ``None`` takes the numpy path, ``False`` never builds."""
    bad = tmp_path / "pointcloud.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native_io, "SRC", bad)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", None)
    path, _ = bin_file
    with pytest.raises(RuntimeError, match="g\\+\\+ .*rc [1-9].*\n.*error"):
        native_io.load_points_padded(path, CFG, use_native=True)
    assert not native_io.native_available()
    assert "error" in native_io.native_error()
    want, n = native_io.load_points_padded(path, CFG, use_native=False)
    got, m = native_io.load_points_padded(path, CFG)
    assert n == m
    np.testing.assert_array_equal(got, want)


def test_load_sweeps_padded_matches_python_path(sweep_dataset):
    """Fused load (crop during the read) == python ``load_sweeps`` + crop
    (tests/test_lyft_data.py)."""
    cfg = tiny_config(num_sweeps=2, max_points=16384)
    tok = sweep_dataset.sample_tokens()[1]
    padded, n = sweep_dataset.load_sweeps_padded(tok, cfg)
    assert padded.shape == (cfg.max_points, 5)  # x,y,z,i,dt
    cloud = sweep_dataset.load_sweeps(tok, num_sweeps=2)
    ref = np.concatenate([cloud[:, :4], cloud[:, 5:6]], axis=1)
    ref = ref[_in_range(ref, cfg)]
    assert int(n) == len(ref)
    np.testing.assert_allclose(padded[: int(n)], ref, atol=1e-4)


def test_loader_matches_jax_bit_for_bit(bin_file, sweep_dataset):
    """The same files through both packages: ``load_points_padded``,
    ``load_sweeps_padded`` (native and numpy) and ``_sweep_chain`` equal
    bit for bit the JAX package's native loader; the JAX numpy path (a
    matmul) within its own test's 1e-5."""
    from tpu_pillars.config import tiny_config as jax_tiny_config
    from tpu_pillars.data import native_io as jnative
    from tpu_pillars.data.lyft import LyftDataset as JaxLyftDataset

    assert jnative.native_available()
    path, _ = bin_file
    jcfg = jax_tiny_config(max_points=2048)
    want, wn = jnative.load_points_padded(path, jcfg, use_native=True)
    for use_native in (True, False):
        got, n = native_io.load_points_padded(path, CFG,
                                              use_native=use_native)
        assert n == wn
        np.testing.assert_array_equal(got, want)

    jds = JaxLyftDataset(sweep_dataset.json_path)
    for num_sweeps in (2, 3):
        cfg = tiny_config(num_sweeps=num_sweeps, max_points=16384)
        jcfg = jax_tiny_config(num_sweeps=num_sweeps, max_points=16384)
        for tok in sweep_dataset.sample_tokens():
            chain = sweep_dataset._sweep_chain(tok, num_sweeps)
            jchain = jds._sweep_chain(tok, num_sweeps)
            assert chain[0] == jchain[0] and chain[2] == jchain[2]
            for a, b in zip(chain[1], jchain[1]):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            want, wn = jds.load_sweeps_padded(tok, jcfg, use_native=True)
            want_np, wn_np = jds.load_sweeps_padded(tok, jcfg,
                                                    use_native=False)
            assert wn == wn_np
            np.testing.assert_allclose(want_np, want, atol=1e-5)
            for use_native in (True, False):
                got, n = sweep_dataset.load_sweeps_padded(
                    tok, cfg, use_native=use_native)
                assert n == wn
                np.testing.assert_array_equal(got, want)
