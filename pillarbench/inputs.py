"""The one generator of the benchmark's inputs. A traffic file
(``pillarbench/traffic/<mix>.json``) names a ``scene`` kind and its
parameters; :func:`make_pool` turns them and ``--seed`` into the pool of
inputs a run cycles through, with ``make(traffic, cfg, rng)`` of
``scenes/<scene>.py``. The same seed gives the same pool. Every seed gets
the same set of sizes (:func:`spread`, evenly over the file's range) in
another order, so that seeds change the order of the work and not its
amount.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def spread(lo: float, hi: float, n: int, rng) -> np.ndarray:
    """``n`` values spread evenly over [lo, hi], in an order drawn from
    ``rng``."""
    return rng.permutation(np.linspace(lo, hi, n))


def make_pool(traffic: dict, cfg: dict, seed: int, home: Path = HERE) -> list:
    """The pool of a run from ``seed``: clouds or numpy training batches,
    as the traffic's scene kind makes them."""
    from pillarbench.cells import load_part

    scene = load_part(home, "scenes", traffic["scene"])
    return scene.make(traffic, cfg, np.random.default_rng(seed))
