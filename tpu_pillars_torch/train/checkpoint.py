"""Inference checkpoints in the JAX package's format. Port of
``export_inference_checkpoint`` in ``tpu_pillars/train/checkpoint.py``.

The file is one msgpack map ``{"step", "params", "batch_stats",
"config_fp"}`` laid out as ``flax.serialization.to_bytes`` writes it (arrays
as ext type 1), so both packages' ``Detector.from_checkpoint`` serve it.
The write is atomic (temporary file + ``os.replace``): an interrupted save
never corrupts the previous checkpoint. A full resume checkpoint (with the
optimizer state) is not written yet.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.weights import (
    config_fingerprint, flax_from_params, flax_msgpack_bytes,
)


def export_inference_checkpoint(path: str, state, config: PillarsConfig
                                ) -> None:
    """Write ``state``'s parameters and BatchNorm running statistics (a
    ``train.state.TrainState``) with the config's fingerprint to ``path``."""
    variables = flax_from_params(state.model.state_dict(), config)
    payload = {"step": np.asarray(state.step, np.int32),
               "params": variables["params"],
               "batch_stats": variables["batch_stats"],
               "config_fp": config_fingerprint(config)}
    data = flax_msgpack_bytes(payload)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
