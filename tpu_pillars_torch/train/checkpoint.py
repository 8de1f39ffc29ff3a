"""Checkpoints in the JAX package's format. Port of
``tpu_pillars/train/checkpoint.py``.

A full checkpoint (:func:`save_checkpoint`) is one msgpack map ``{"step",
"params", "batch_stats", "opt_state", "config_fp"}`` laid out as
``flax.serialization.to_bytes`` writes the JAX ``TrainState`` (arrays as
ext type 1), so each package resumes the other's file. ``opt_state`` is
the state of optax's ``chain(clip_by_global_norm, adamw(schedule))``::

    {"0": {},                                   # clip_by_global_norm
     "1": {"0": {"count", "mu", "nu"},          # scale_by_adam
           "1": {},                             # add_decayed_weights
           "2": {"count"}}}                     # scale_by_schedule

with both counts 0-d int32 arrays and ``mu`` / ``nu`` shaped as ``params``
(``weights.flax_param_tree``). The empty maps stay: flax restores into a
template only when every key of the template is in the file.

An inference checkpoint (:func:`export_inference_checkpoint`) drops
``opt_state``; both packages' ``Detector.from_checkpoint`` serve either
kind, and :func:`restore_checkpoint` refuses an inference one. Writes are
atomic (temporary file + ``os.replace``): an interrupted save never
corrupts the previous checkpoint.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from tpu_pillars_torch.weights import (
    check_fingerprint, config_fingerprint, flax_msgpack_bytes,
    flax_param_tree, load_flax_msgpack, param_tensors_from_flax,
    params_from_flax,
)


def _write_atomic(path: str, payload: dict) -> None:
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


def _opt_state(state) -> dict:
    arrays = state.optimizer.state_arrays()
    names = [n for n, _ in state.model.named_parameters()]
    cfg = state.model.config
    count = np.asarray(arrays["count"], np.int32)
    return {"0": {}, "1": {
        "0": {"count": count,
              "mu": flax_param_tree(dict(zip(names, arrays["mu"])), cfg),
              "nu": flax_param_tree(dict(zip(names, arrays["nu"])), cfg)},
        "1": {},
        "2": {"count": count}}}


def save_checkpoint(path: str, state, config=None) -> None:
    """Write ``state`` (a ``train.state.TrainState``) whole: step,
    parameters, BatchNorm running statistics and the optimizer's moments
    and count, with ``config``'s fingerprint when given."""
    payload = {"step": np.asarray(state.step, np.int32),
               **state.variables,
               "opt_state": _opt_state(state)}
    if config is not None:
        payload["config_fp"] = config_fingerprint(config)
    _write_atomic(path, payload)


def export_inference_checkpoint(path: str, state_or_ckpt, config=None
                                ) -> None:
    """Write a serving artifact: step, parameters and BatchNorm running
    statistics (+ ``config_fp``) without the optimizer state, about a third
    of a full checkpoint. ``Detector.from_checkpoint`` serves it;
    :func:`restore_checkpoint` refuses it (it is not a resume point).

    state_or_ckpt: a ``TrainState``, or the path of a full checkpoint,
    stripped on the host (no model is built); its ``config_fp`` is kept
    when no ``config`` is given."""
    if isinstance(state_or_ckpt, (str, os.PathLike)):
        raw = load_flax_msgpack(os.fspath(state_or_ckpt))
        payload = {"step": raw["step"], "params": raw["params"],
                   "batch_stats": raw["batch_stats"]}
        if config is None and "config_fp" in raw:
            payload["config_fp"] = np.asarray(raw["config_fp"], np.uint8)
    else:
        payload = {"step": np.asarray(state_or_ckpt.step, np.int32),
                   **state_or_ckpt.variables}
    if config is not None:
        payload["config_fp"] = config_fingerprint(config)
    _write_atomic(path, payload)


def restore_checkpoint(path: str, template, config=None):
    """Load a full checkpoint of either package into ``template`` (a
    ``TrainState`` of the same config, e.g. a fresh ``create_train_state``)
    on the template's device, and return it. Its step and optimizer count
    become the file's.

    Raises ValueError when ``config`` is given and the file recorded
    another config's fingerprint, and when the file holds no optimizer
    state (an inference export, a ``.ema`` file)."""
    tree = load_flax_msgpack(os.fspath(path))
    if config is not None:
        check_fingerprint(tree, config, path)
    if "opt_state" not in tree:
        raise ValueError(f"checkpoint {path} holds no optimizer state (an "
                         f"inference export?); refusing to resume from it")
    cfg = template.model.config
    adam = tree["opt_state"]["1"]["0"]
    names = [n for n, _ in template.model.named_parameters()]
    mu = param_tensors_from_flax(adam["mu"], cfg)
    nu = param_tensors_from_flax(adam["nu"], cfg)
    template.model.load_state_dict(params_from_flax(tree, cfg))
    template.optimizer.load_state_arrays({
        "count": int(adam["count"]), "mu": [mu[n] for n in names],
        "nu": [nu[n] for n in names]})
    template.step = int(tree["step"])
    return template
