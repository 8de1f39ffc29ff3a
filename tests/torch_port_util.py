"""Shared inputs of the tests that hold tpu_pillars_torch against the JAX
package: random model variables and padded point clouds drawn with numpy
from a seed, so the same numbers feed both packages."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pillars.models import PointPillars
from tpu_pillars.ops.voxelize import PillarBatch


def random_variables(cfg, seed=0):
    """Flax variables {'params', 'batch_stats'} of ``PointPillars(cfg)`` as
    numpy arrays: kernels normal with fan-in scaling (unit per-layer gain),
    BatchNorm affine and statistics jittered away from identity."""
    rng = np.random.default_rng(seed)
    dummy = PillarBatch(
        jnp.zeros((cfg.max_pillars, cfg.max_points_per_pillar,
                   cfg.num_decorated_features)),
        jnp.zeros((cfg.max_pillars, cfg.max_points_per_pillar), bool),
        jnp.zeros((cfg.max_pillars, 2), jnp.int32),
        jnp.zeros((cfg.max_pillars,), bool),
    )
    shapes = jax.eval_shape(
        lambda: PointPillars(cfg).init(jax.random.PRNGKey(0), dummy))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            x = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif name == "scale":
            x = rng.normal(1.0, 0.1, shape)
        elif name == "var":
            x = np.abs(rng.normal(1.0, 0.1, shape)) + 0.1
        else:                                        # bias, mean
            x = rng.normal(0.0, 0.1, shape)
        return x.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def cloud_batch(rng, ns, cfg, f=4, margin=2.0):
    """(len(ns), cfg.max_points, f) f32 clouds padded with 1e6, sample i
    holding ns[i] uniform points over the detection range widened by
    ``margin`` (so some fall outside), and the (len(ns),) int32 counts."""
    pts = np.full((len(ns), cfg.max_points, f), 1e6, dtype=np.float32)
    for i, n in enumerate(ns):
        pts[i, :n, 0] = rng.uniform(cfg.x_min - margin, cfg.x_max + margin, n)
        pts[i, :n, 1] = rng.uniform(cfg.y_min - margin, cfg.y_max + margin, n)
        pts[i, :n, 2] = rng.uniform(cfg.z_min - 0.5, cfg.z_max + 0.5, n)
        pts[i, :n, 3:] = rng.uniform(0, 1, (n, f - 3))
    return pts, np.asarray(ns, np.int32)


def dense_cell_batch(rng, cfg, n_dense=2500, n_rest=1200):
    """Two clouds: the first puts ``n_dense`` points in one cell (a pillar
    spanning several 1,024-point chunks) before ``n_rest`` uniform ones, the
    second holds the uniform ones alone."""
    pts = np.full((2, cfg.max_points, 4), 1e6, np.float32)
    pts[0, :n_dense, 0] = 3.2 + rng.uniform(0, 0.2, n_dense)
    pts[0, :n_dense, 1] = -1.4 + rng.uniform(0, 0.2, n_dense)
    pts[0, :n_dense, 2] = rng.uniform(-1, 1, n_dense)
    pts[0, :n_dense, 3] = np.arange(n_dense) / n_dense
    rest, _ = cloud_batch(rng, [n_rest], cfg)
    pts[0, n_dense:n_dense + n_rest] = rest[0, :n_rest]
    pts[1, :n_rest] = rest[0, :n_rest]
    return pts, np.asarray([n_dense + n_rest, n_rest], np.int32)


def assert_packed_close(got, want, score_tol, geo_tol):
    """Row-for-row (D, 10) packed detections: same valid rows and classes,
    scores / centres / sizes / yaws within the tolerances. Returns the
    number of valid rows."""
    np.testing.assert_array_equal(got[:, 9], want[:, 9])
    n = int(want[:, 9].sum())
    g, w = got[:n], want[:n]
    np.testing.assert_array_equal(g[:, 8], w[:, 8])
    np.testing.assert_allclose(g[:, 7], w[:, 7], atol=score_tol)
    np.testing.assert_allclose(g[:, :6], w[:, :6], atol=geo_tol)
    dyaw = (g[:, 6] - w[:, 6] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(dyaw).max(initial=0.0) < geo_tol
    return n
