"""tpu_pillars_torch's full checkpoints vs the JAX package on the CPU, at
``tiny_config()``, batch 2, inputs drawn with numpy from seeds.

* Each package resumes the other's full checkpoint: after two steps in
  one package, the other's ``restore_checkpoint`` gives the same step,
  parameters, running statistics, AdamW moments and both optax counts,
  leaf for leaf and bit for bit; the port re-saves a JAX file byte for
  byte. One further step in each package from the restored state agrees
  at the tolerance of tests/test_torch_train.py::test_train_steps_match_jax
  (loss rtol 2e-3, parameters atol 5e-4, statistics rtol 1e-2 / atol 1e-4).
* A port run killed by ``fit(stop=)`` after 2 of 4 steps, restored and fed
  the rest of the seeded stream, logs the unbroken run's losses and ends
  with its weights and moments, bit for bit.
* ``restore_checkpoint`` refuses a file of another config and an inference
  file; ``export_inference_checkpoint`` strips a full file on the host,
  and both packages' ``Detector.from_checkpoint`` serve the result.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tpu_pillars.config import tiny_config
from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import weights
from tpu_pillars_torch.data.synthetic import make_scene, scenes_to_train_batch
from tpu_pillars_torch.train import checkpoint as tckpt
from tpu_pillars_torch.train import loop
from tpu_pillars_torch.train import state as tstate
from tpu_pillars_torch.train.step import batch_to_device, make_train_step

CFG, TCFG = tiny_config(), tconfig.tiny_config()
PORT_TCFG = tstate.TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_step():
    from tpu_pillars.train import make_train_step as jax_make_step

    return jax.jit(jax_make_step(CFG, fused_frontend=True))


def _batch(seed):
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, TCFG, num_objects=6, points_per_object=60,
                         clutter=400) for _ in range(2)]
    return scenes_to_train_batch(scenes, TCFG, 16)


def _jax_template():
    from tpu_pillars.train import TrainConfig, create_train_state

    return create_train_state(CFG, TrainConfig(batch_size=2, max_gt_boxes=16,
                                               total_steps=10))


def _jax_state(variables):
    st = _jax_template()
    params = jax.tree.map(jnp.asarray, variables["params"])
    return st.replace(params=params,
                      batch_stats=jax.tree.map(jnp.asarray,
                                               variables["batch_stats"]),
                      opt_state=st.tx.init(params))


def _port_state(variables=None, seed=0):
    sd = None if variables is None else weights.params_from_flax(variables,
                                                                 TCFG)
    return tstate.create_train_state(TCFG, PORT_TCFG, seed=seed,
                                     device="cpu", state_dict=sd)


def _port_tree(st):
    """The port state as the JAX state's tree: step, params, batch_stats,
    mu, nu and the two optax counts."""
    names = [n for n, _ in st.model.named_parameters()]
    arrays = st.optimizer.state_arrays()
    return {"step": st.step, **st.variables,
            "mu": weights.flax_param_tree(dict(zip(names, arrays["mu"])),
                                          TCFG),
            "nu": weights.flax_param_tree(dict(zip(names, arrays["nu"])),
                                          TCFG),
            "counts": (arrays["count"], arrays["count"])}


def _jax_tree(st):
    adam, sched = st.opt_state[1][0], st.opt_state[1][2]
    return {"step": int(st.step), "params": st.params,
            "batch_stats": st.batch_stats, "mu": adam.mu, "nu": adam.nu,
            "counts": (int(adam.count), int(sched.count))}


def _assert_trees_equal(got, want):
    assert got["step"] == want["step"]
    assert got["counts"] == want["counts"]
    for key in ("params", "batch_stats", "mu", "nu"):
        g = jax.tree_util.tree_leaves_with_path(got[key])
        w = dict(jax.tree_util.tree_leaves_with_path(want[key]))
        assert len(g) == len(w) > 0
        for path, leaf in g:
            np.testing.assert_array_equal(
                np.asarray(leaf), np.asarray(w[path]),
                err_msg=f"{key}{jax.tree_util.keystr(path)}")


def _assert_next_step_agrees(port_st, jax_st, jax_step, arrays):
    from tpu_pillars.train import TrainBatch

    jax_st, jl = jax_step(jax_st, TrainBatch(*(jnp.asarray(x)
                                               for x in arrays)))
    port_st, tl = make_train_step(TCFG)(port_st,
                                        batch_to_device(arrays, "cpu"))
    np.testing.assert_allclose(float(tl.total), float(jl.total), rtol=2e-3)
    assert int(tl.num_pos) == int(jl.num_pos) > 0
    v = port_st.variables
    for a, b in zip(jax.tree.leaves(v["params"]),
                    jax.tree.leaves(jax_st.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4)
    for a, b in zip(jax.tree.leaves(v["batch_stats"]),
                    jax.tree.leaves(jax_st.batch_stats)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=1e-4)
    assert port_st.step == port_st.optimizer.count == int(jax_st.step) == 3


def test_jax_restores_port_checkpoint(tmp_path, jax_step):
    from tpu_pillars.train.checkpoint import restore_checkpoint

    port = _port_state(random_variables(CFG, seed=4))
    step = make_train_step(TCFG)
    for seed in (30, 31):
        port, _ = step(port, batch_to_device(_batch(seed), "cpu"))
    path = str(tmp_path / "port.msgpack")
    tckpt.save_checkpoint(path, port, config=TCFG)

    restored = restore_checkpoint(path, _jax_template(), config=CFG)
    _assert_trees_equal(_jax_tree(restored), _port_tree(port))
    _assert_next_step_agrees(port, restored, jax_step, _batch(32))


def test_port_restores_jax_checkpoint(tmp_path, jax_step):
    from tpu_pillars.train import TrainBatch
    from tpu_pillars.train.checkpoint import save_checkpoint

    variables = random_variables(CFG, seed=4)
    jst = _jax_state(variables)
    for seed in (30, 31):
        jst, _ = jax_step(jst, TrainBatch(*(jnp.asarray(x)
                                            for x in _batch(seed))))
    path = str(tmp_path / "jax.msgpack")
    save_checkpoint(path, jst, config=CFG)

    port = tckpt.restore_checkpoint(path, _port_state(seed=9), config=TCFG)
    _assert_trees_equal(_port_tree(port), _jax_tree(jst))
    # the port writes the JAX file again, byte for byte
    again = str(tmp_path / "again.msgpack")
    tckpt.save_checkpoint(again, port, config=TCFG)
    assert open(again, "rb").read() == open(path, "rb").read()
    _assert_next_step_agrees(port, jst, jax_step, _batch(32))


def _losses(logger_lines):
    return [(x["step"], x["loss"], x["cls"], x["loc"], x["dir"])
            for x in logger_lines if x["event"] == "train_step"]


class _ListLogger:
    def __init__(self):
        self.lines = []

    def log(self, event, **fields):
        self.lines.append({"event": event, **fields})


def _stream():
    return loop.synthetic_batches(TCFG, PORT_TCFG, seed=3, num_objects=4,
                                  points_per_object=60, clutter=300)


def test_killed_and_resumed_run_is_bit_equal(tmp_path):
    whole = _ListLogger()
    unbroken = loop.fit(_port_state(seed=1), _stream(), 4, config=TCFG,
                        logger=whole, log_every=1)

    first = _ListLogger()
    polls = itertools.count()
    path = str(tmp_path / "ckpt.msgpack")
    killed = loop.fit(_port_state(seed=1), _stream(), 4, config=TCFG,
                      logger=first, log_every=1, ckpt_path=path,
                      stop=lambda: next(polls) >= 2)
    assert killed.step == 2
    assert [x["event"] for x in first.lines][-1] == "preempted"
    assert first.lines[-1]["step"] == 2

    resumed = tckpt.restore_checkpoint(path, _port_state(seed=7), config=TCFG)
    assert resumed.step == resumed.optimizer.count == 2
    second = _ListLogger()
    resumed = loop.fit(resumed, itertools.islice(_stream(), 2, None), 2,
                       config=TCFG, logger=second, log_every=1)

    assert _losses(first.lines) + _losses(second.lines) == \
        _losses(whole.lines)
    _assert_trees_equal(_port_tree(resumed), _port_tree(unbroken))


def test_restore_refuses_other_config_and_inference_files(tmp_path):
    st = _port_state(seed=2)
    full = str(tmp_path / "full.msgpack")
    tckpt.save_checkpoint(full, st, config=TCFG)
    other = dataclasses.replace(TCFG, nms_iou_threshold=0.3)
    with pytest.raises(ValueError, match="different PillarsConfig"):
        tckpt.restore_checkpoint(full, _port_state(seed=2), config=other)
    inference = str(tmp_path / "inference.msgpack")
    tckpt.export_inference_checkpoint(inference, st, config=TCFG)
    with pytest.raises(ValueError, match="no optimizer state"):
        tckpt.restore_checkpoint(inference, _port_state(seed=2), config=TCFG)


def test_export_from_path_serves_in_both_packages(tmp_path):
    from tpu_pillars.data.synthetic import make_scene as jax_make_scene
    from tpu_pillars.detector import Detector as JaxDetector
    from tpu_pillars_torch.detector import Detector

    st = _port_state(random_variables(CFG, seed=6))
    st.step = 5
    full = str(tmp_path / "full.msgpack")
    tckpt.save_checkpoint(full, st, config=TCFG)
    stripped = str(tmp_path / "stripped.msgpack")
    tckpt.export_inference_checkpoint(stripped, full)
    direct = str(tmp_path / "direct.msgpack")
    tckpt.export_inference_checkpoint(direct, st, config=TCFG)
    # the config_fp is kept from the file: the same bytes as from the state
    assert open(stripped, "rb").read() == open(direct, "rb").read()
    raw = serialization.msgpack_restore(open(stripped, "rb").read())
    assert list(raw) == ["step", "params", "batch_stats", "config_fp"]

    cloud = jax_make_scene(np.random.default_rng(9), CFG, num_objects=6,
                           clutter=1000).points
    want = np.asarray(JaxDetector.from_checkpoint(CFG, stripped)
                      .predict_packed(cloud))
    got = Detector.from_checkpoint(TCFG, stripped, device="cpu") \
        .predict_packed(cloud).numpy()
    full_got = Detector.from_checkpoint(TCFG, full, device="cpu") \
        .predict_packed(cloud).numpy()
    np.testing.assert_array_equal(full_got, got)
    n = int(want[:, 9].sum())
    assert n > 0
    np.testing.assert_array_equal(got[:, 9], want[:, 9])
    np.testing.assert_array_equal(got[:n, 8], want[:n, 8])
    np.testing.assert_allclose(got[:n, 7], want[:n, 7], atol=1e-4)
    np.testing.assert_allclose(got[:n, :6], want[:n, :6], atol=5e-3)
