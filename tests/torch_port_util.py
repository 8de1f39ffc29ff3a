"""Shared inputs of the tests that hold tpu_pillars_torch against the JAX
package: random model variables drawn with numpy from a seed, so the same
numbers feed both packages."""

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
