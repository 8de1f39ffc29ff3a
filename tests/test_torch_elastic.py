"""tpu_pillars_torch's training hooks vs the JAX package on the CPU, at
``tiny_config()``, batch 1-2.

* ``EmaTracker`` against the JAX tracker over 5 updates, warmup on and
  off: within 1 ulp, since XLA's CPU build contracts ``e * d + p * (1 -
  d)`` into an FMA and the port rounds both products as written (bit-equal
  to numpy's float32 products and sum). ``fit(ema=)`` writes a ``.ema``
  inference file of the EMA weights that both packages serve and
  ``restore_checkpoint`` refuses, and evaluates raw and EMA weights through
  ``make_synthetic_eval_fn``.
* ``Detector.load_state_dict`` serves the new weights (the folded PFN
  weights included) as a fresh ``Detector`` does.
* The elastic hooks: ``GracefulShutdown`` flags SIGTERM and restores the
  handler; ``fit(stop=)`` checkpoints cleanly; ``NaNGuard`` saves the last
  finite state, not the poisoned one; ``check_heartbeat``'s three states;
  ``main`` preempted by SIGTERM exits, stops its prefetch thread, and
  ``--resume`` finishes on the unbroken run's weights; ``main --dp 2``
  trains on two gloo ranks with the one-process loss, rank 0 writes, and
  ``--resume`` continues it; a SIGTERM to its launcher stops both ranks at
  one step, checkpointed, from which ``--resume`` finishes on the unbroken
  run's weights; an eval hook longer than the collective timeout does not
  end the run (``--bf16`` trains: tests/test_torch_bf16.py).
* The TensorBoard writer writes the JAX writer's bytes for the same events
  (wall time pinned), its CRC-32C holds the published check values, and
  the JSONL logger writes the JAX logger's lines.
"""

import json
import math
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import weights
from tpu_pillars_torch.train import checkpoint as tckpt
from tpu_pillars_torch.train import elastic, loop
from tpu_pillars_torch.train import state as tstate
from tpu_pillars_torch.train.ema import EmaTracker, maybe_tracker
from tpu_pillars_torch.train.step import make_train_step
from tpu_pillars_torch.utils.logging import JsonlLogger

CFG, TCFG = tiny_config(), tconfig.tiny_config()
PORT_TCFG = tstate.TrainConfig(batch_size=1, max_gt_boxes=4, total_steps=6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0, variables=None):
    sd = None if variables is None else weights.params_from_flax(variables,
                                                                 TCFG)
    return tstate.create_train_state(TCFG, PORT_TCFG, seed=seed,
                                     device="cpu", state_dict=sd)


def _stream(seed=0):
    return loop.synthetic_batches(TCFG, PORT_TCFG, seed=seed, num_objects=2,
                                  points_per_object=60, clutter=50)


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---- EMA -----------------------------------------------------------------

@pytest.mark.parametrize("warmup", [False, True])
def test_ema_matches_jax_tracker(warmup):
    """Five updates of a slowly moving iterate, as training gives. The port
    rounds both products of ``e * d + p * (1 - d)`` and the sum, as written,
    bit for bit; XLA's CPU build contracts the same expression into one FMA
    (``e * d`` unrounded), so each update from the same EMA agrees with the
    JAX tracker within 1 ulp, most values exactly."""
    import jax.numpy as jnp
    from tpu_pillars.train.ema import EmaTracker as JaxEmaTracker

    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 3), (64,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jax_tr = JaxEmaTracker({f"p{i}": x for i, x in enumerate(params)},
                           decay=0.9, warmup=warmup)
    port_tr = EmaTracker([torch.from_numpy(x.copy()) for x in params],
                         decay=0.9, warmup=warmup)
    ref = [x.copy() for x in params]
    equal = total = 0
    for n in range(1, 6):
        params = [x + np.float32(0.01) * rng.standard_normal(x.shape)
                  .astype(np.float32) for x in params]
        jax_tr.params = {f"p{i}": jnp.asarray(t.numpy())
                         for i, t in enumerate(port_tr.params)}
        jax_tr.update({f"p{i}": x for i, x in enumerate(params)})
        port_tr.update([torch.from_numpy(x) for x in params])
        d = np.float32(min(0.9, (1 + n) / (10 + n)) if warmup else 0.9)
        ref = [e * d + p * (np.float32(1) - d) for e, p in zip(ref, params)]
        for i, got in enumerate(port_tr.params):
            np.testing.assert_array_equal(got.numpy(), ref[i])
            ulps = np.abs(got.numpy().view(np.int32).astype(np.int64)
                          - np.asarray(jax_tr.params[f"p{i}"])
                          .view(np.int32))
            assert ulps.max() <= 1
            equal += int((ulps == 0).sum())
            total += ulps.size
    assert port_tr.count == jax_tr.count == 5
    assert equal > total // 2


def test_maybe_tracker_gate():
    p = [torch.zeros(3)]
    assert maybe_tracker(p, 0.0) is None
    assert maybe_tracker(p, 0.99) is not None
    with pytest.raises(ValueError):
        EmaTracker(p, decay=1.5)


def test_detector_load_state_dict_serves_new_weights():
    from tpu_pillars.data.synthetic import make_scene
    from tpu_pillars_torch.detector import Detector

    sd_a = weights.params_from_flax(random_variables(CFG, seed=1), TCFG)
    sd_b = weights.params_from_flax(random_variables(CFG, seed=2), TCFG)
    cloud = make_scene(np.random.default_rng(3), CFG, num_objects=6,
                       clutter=1000).points
    want = Detector(TCFG, sd_b, device="cpu").predict_packed(cloud)
    det = Detector(TCFG, sd_a, device="cpu")
    assert not torch.equal(det.predict_packed(cloud), want)
    det.load_state_dict(sd_b)
    assert torch.equal(det.predict_packed(cloud), want)


def test_fit_with_ema_and_eval(tmp_path):
    from tpu_pillars.detector import Detector as JaxDetector
    from tpu_pillars_torch.detector import Detector

    state = _state(variables=random_variables(CFG, seed=4))
    ema = EmaTracker(state.model.parameters(), decay=0.5)
    logger = JsonlLogger(str(tmp_path / "log.jsonl"))
    ckpt = str(tmp_path / "ck.msgpack")
    eval_fn = loop.make_synthetic_eval_fn(TCFG, num_scenes=2, num_objects=3,
                                          clutter=200)
    state = loop.fit(state, _stream(), 3, config=TCFG, logger=logger,
                     ckpt_path=ckpt, ema=ema, eval_fn=eval_fn, eval_every=2)
    logger.close()
    assert ema.count == 3
    evals = [x for x in _read(str(tmp_path / "log.jsonl"))
             if x["event"] == "eval"]
    assert [x["step"] for x in evals] == [2, 3]
    assert all(math.isfinite(x["mAP"]) and math.isfinite(x["mAP_ema"])
               for x in evals)

    raw = [p.detach() for p in state.model.parameters()]
    assert not all(torch.equal(a, b) for a, b in zip(raw, ema.params))
    view = ema.swap_into(state)
    assert view.optimizer is None and view.step == 3
    # the .ema file: EMA parameters, live statistics; served by both
    # packages, refused by resume
    tree = weights.load_flax_msgpack(ckpt + ".ema")
    assert "opt_state" not in tree and int(tree["step"]) == 3
    names = [n for n, _ in state.model.named_parameters()]
    want = weights.flax_param_tree(dict(zip(names, ema.params)), TCFG)
    live = state.variables["batch_stats"]
    for got, exp in zip(jax.tree.leaves(tree["params"])
                        + jax.tree.leaves(tree["batch_stats"]),
                        jax.tree.leaves(want) + jax.tree.leaves(live)):
        np.testing.assert_array_equal(got, exp)
    det = Detector.from_checkpoint(TCFG, ckpt + ".ema", device="cpu")
    for a, b in zip(det.model.parameters(), ema.params):
        assert torch.equal(a, b)
    jdet = JaxDetector.from_checkpoint(CFG, ckpt + ".ema")
    assert isinstance(jdet.predict(np.zeros((10, 4), np.float32)), list)
    with pytest.raises(ValueError, match="no optimizer state"):
        tckpt.restore_checkpoint(ckpt + ".ema", _state(), config=TCFG)
    # the training state itself is untouched by the view and resumes
    full = tckpt.restore_checkpoint(ckpt, _state(seed=5), config=TCFG)
    for a, b in zip(full.model.parameters(), raw):
        assert torch.equal(a, b)


# ---- elastic hooks -------------------------------------------------------

def test_graceful_shutdown_flag_and_restore():
    prev = signal.getsignal(signal.SIGTERM)
    with elastic.GracefulShutdown() as s:
        assert not s()
        os.kill(os.getpid(), signal.SIGTERM)
        assert s()           # flag, not death
    assert signal.getsignal(signal.SIGTERM) is prev


def test_fit_stop_flag_checkpoints_cleanly(tmp_path):
    hb = elastic.Heartbeat(str(tmp_path / "hb.json"))
    fired = {"n": 0}

    def stop():
        fired["n"] += 1
        return fired["n"] > 2   # allow 2 steps, then preempt

    out = loop.fit(_state(), _stream(), 4, config=TCFG,
                   ckpt_path=str(tmp_path / "c.msgpack"), stop=stop,
                   heartbeat=hb)
    assert out.step == 2
    st = elastic.check_heartbeat(str(tmp_path / "hb.json"),
                                 stall_after_s=1e9)
    assert st == {"status": "ok", "age_s": st["age_s"], "step": 2}
    restored = tckpt.restore_checkpoint(str(tmp_path / "c.msgpack"),
                                        _state(seed=3))
    assert restored.step == restored.optimizer.count == 2


def test_nan_guard_saves_the_last_finite_state(tmp_path):
    diag = str(tmp_path / "diverged.msgpack")
    guard = elastic.NaNGuard(diag, config=TCFG)
    real_step = make_train_step(TCFG)
    finite = {}

    def poisoned_step(s, b):
        s, losses = real_step(s, b)         # the model is mutated in place
        if s.step == 2:
            finite.update({k: v.clone()
                           for k, v in s.model.state_dict().items()})
            finite.update({f"mu{i}": m.clone()
                           for i, m in enumerate(s.optimizer.mu)})
        if s.step >= 3:
            losses = losses._replace(total=torch.tensor(float("nan")))
        return s, losses

    with pytest.raises(elastic.TrainingDiverged) as ei:
        loop.fit(_state(), _stream(), 6, config=TCFG, step_fn=poisoned_step,
                 log_every=1, guard=guard)
    assert ei.value.diagnostic_path == diag
    restored = tckpt.restore_checkpoint(diag, _state(seed=3), config=TCFG)
    assert restored.step == restored.optimizer.count == 2
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, finite[k]), k
    for i, m in enumerate(restored.optimizer.mu):
        assert torch.equal(m, finite[f"mu{i}"])


def test_check_heartbeat_states(tmp_path):
    path = str(tmp_path / "hb.json")
    assert elastic.check_heartbeat(path, 10)["status"] == "missing"
    elastic.Heartbeat(path).beat(7)
    st = elastic.check_heartbeat(path, stall_after_s=60)
    assert st["status"] == "ok" and st["step"] == 7
    with open(path, "w") as f:
        f.write(json.dumps({"step": 7, "time": time.time() - 120}))
    st = elastic.check_heartbeat(path, stall_after_s=60)
    assert st["status"] == "stalled" and st["age_s"] > 100


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "tpu-pillars-torch-prefetch" and t.is_alive()]


def test_main_preempted_then_resumed(tmp_path, monkeypatch):
    """SIGTERM at step 2 of 4: ``main`` logs 'preempted', checkpoints step
    2, stops its prefetch thread and returns; ``--resume`` logs
    ``resumed_at`` 2 and ends at step 4 with the unbroken run's weights."""
    args = ["--steps", "4", "--batch", "1", "--device", "cpu"]
    whole = str(tmp_path / "whole")
    loop.main(args + ["--out", whole])

    beat = elastic.Heartbeat.beat

    def beat_then_term(self, step):
        beat(self, step)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    out = str(tmp_path / "run")
    monkeypatch.setattr(elastic.Heartbeat, "beat", beat_then_term)
    loop.main(args + ["--out", out])
    monkeypatch.setattr(elastic.Heartbeat, "beat", beat)
    deadline = time.time() + 10
    while _prefetch_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _prefetch_threads()
    events = _read(os.path.join(out, "train.jsonl"))
    assert [e["step"] for e in events if e["event"] == "preempted"] == [2]
    ckpt = os.path.join(out, "ckpt.msgpack")
    assert int(weights.load_flax_msgpack(ckpt)["step"]) == 2

    loop.main(args + ["--out", out, "--resume"])
    events = _read(os.path.join(out, "train.jsonl"))
    assert [e["resumed_at"] for e in events if e["event"] == "start"] == \
        [0, 2]
    got = weights.load_flax_msgpack(ckpt)
    want = weights.load_flax_msgpack(os.path.join(whole, "ckpt.msgpack"))
    assert int(got["step"]) == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_main_data_parallel_two_ranks(tmp_path):
    """``main --dp 2 --device cpu``: two gloo ranks train 2 steps of the
    global batch 2 (one sample each) with the loss of the one-process run
    (rtol 1e-4); rank 0 alone writes the JSONL and the checkpoint, which
    ``--resume`` picks up for a third step. ``--batch 3 --dp 2`` exits
    before it builds anything."""
    args = ["--steps", "2", "--batch", "2", "--device", "cpu",
            "--prefetch", "0"]
    dp, one = str(tmp_path / "dp"), str(tmp_path / "one")
    loop.main(args + ["--dp", "2", "--out", dp])
    loop.main(args + ["--out", one])
    events = _read(os.path.join(dp, "train.jsonl"))
    starts = [e for e in events if e["event"] == "start"]
    assert len(starts) == 1 and starts[0]["dp"] == 2
    (last,) = [e for e in events if e["event"] == "train_step"]
    (want,) = [e for e in _read(os.path.join(one, "train.jsonl"))
               if e["event"] == "train_step"]
    assert last["step"] == want["step"] == 2 and math.isfinite(last["loss"])
    assert last["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert last["num_pos"] == want["num_pos"]
    ckpt = os.path.join(dp, "ckpt.msgpack")
    assert int(weights.load_flax_msgpack(ckpt)["step"]) == 2

    loop.main(["--steps", "3", "--batch", "2", "--device", "cpu", "--dp",
               "2", "--out", dp, "--resume"])
    events = _read(os.path.join(dp, "train.jsonl"))
    assert [e["resumed_at"] for e in events if e["event"] == "start"] == \
        [0, 2]
    assert [e["step"] for e in events if e["event"] == "train_step"] == \
        [2, 3]
    assert int(weights.load_flax_msgpack(ckpt)["step"]) == 3

    with pytest.raises(SystemExit, match="--batch 3 must divide by --dp 2"):
        loop.main(["--device", "cpu", "--batch", "3", "--dp", "2",
                   "--out", str(tmp_path / "refused")])
    assert not os.path.exists(tmp_path / "refused")


def _term_after_first_step(beat_path, done, deadline_s=120.0):
    """Send SIGTERM to this process (the launcher) once ``beat_path``
    shows step 1, unless ``done`` is set first."""
    end = time.time() + deadline_s
    while not done.is_set() and time.time() < end:
        try:
            with open(beat_path) as f:
                step = json.load(f)["step"]
        except (OSError, ValueError):
            step = 0
        if step >= 1:
            os.kill(os.getpid(), signal.SIGTERM)
            return
        time.sleep(0.01)


def test_main_data_parallel_preempted_then_resumed(tmp_path):
    """SIGTERM to ``main --dp 2``'s launcher after the first step: the
    launcher passes it on, both ranks stop at the same step, rank 0 logs
    'preempted' and checkpoints it, and ``--resume`` ends at step 6 on the
    unbroken two-rank run's weights."""
    args = ["--steps", "6", "--batch", "2", "--device", "cpu",
            "--prefetch", "0", "--dp", "2"]
    whole = str(tmp_path / "whole")
    loop.main(args + ["--out", whole])

    out = str(tmp_path / "run")
    done = threading.Event()
    sender = threading.Thread(
        target=_term_after_first_step,
        args=(os.path.join(out, "heartbeat.json"), done), daemon=True)
    sender.start()
    # a signal that comes after the run is only flagged
    with elastic.GracefulShutdown():
        loop.main(args + ["--out", out])
        done.set()
        sender.join()
    events = _read(os.path.join(out, "train.jsonl"))
    (stopped,) = [e["step"] for e in events if e["event"] == "preempted"]
    assert 1 <= stopped < 6
    ckpt = os.path.join(out, "ckpt.msgpack")
    assert int(weights.load_flax_msgpack(ckpt)["step"]) == stopped

    loop.main(args + ["--out", out, "--resume"])
    events = _read(os.path.join(out, "train.jsonl"))
    assert [e["resumed_at"] for e in events if e["event"] == "start"] == \
        [0, stopped]
    got = weights.load_flax_msgpack(ckpt)
    want = weights.load_flax_msgpack(os.path.join(whole, "ckpt.msgpack"))
    assert int(got["step"]) == 6
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_data_parallel_eval_longer_than_the_collective_timeout(tmp_path):
    """``main --dp 2 --eval-every 1``'s ranks with a 5 s collective
    timeout and an eval hook that first sleeps 10 s: every rank runs the
    hook, so none waits in the next step's collective, and the run ends
    with both evals logged once, by rank 0."""
    from tpu_pillars_torch.parallel import launch, mesh_devices

    import torch_parallel_ranks as ranks

    out = str(tmp_path / "run")
    args = loop.parse_args(["--steps", "2", "--batch", "2", "--device",
                            "cpu", "--prefetch", "0", "--dp", "2",
                            "--eval-every", "1", "--eval-scenes", "2",
                            "--out", out])
    launch(ranks.train_with_slow_eval, mesh_devices(2, "cpu"),
           args=(args, 5.0, 10.0), timeout=240.0)
    events = _read(os.path.join(out, "train.jsonl"))
    assert [e["step"] for e in events if e["event"] == "eval"] == [1, 2]
    assert [e["step"] for e in events if e["event"] == "train_step"] == \
        [2]


# ---- logging -------------------------------------------------------------

class _Clock:
    """Stands in for the ``time`` module: a fixed wall time."""

    @staticmethod
    def time():
        return 1_700_000_000.25


def test_tensorboard_writer_matches_jax_bytes(tmp_path, monkeypatch):
    from tpu_pillars.utils import tensorboard as jtb
    from tpu_pillars_torch.utils import tensorboard as ttb

    assert ttb.crc32c(b"123456789") == 0xE3069283
    assert ttb.crc32c(b"") == 0
    assert ttb.crc32c(b"\x00" * 32) == 0x8A9136AA
    monkeypatch.setattr(jtb, "time", _Clock)
    monkeypatch.setattr(ttb, "time", _Clock)
    files = []
    for mod, sub in ((jtb, "jax"), (ttb, "port")):
        with mod.TensorBoardWriter(str(tmp_path / sub)) as tb:
            tb.add_scalar("loss", 0.5, step=1)
            tb.log("train_step", step=2, loss=0.25, lr=1e-3, note="x",
                   flag=True)
            tb.log("bench", value=3.0)
            tb.log("bench", value=4.0)
            files.append(tb.path)
    data = [open(f, "rb").read() for f in files]
    assert data[0] == data[1] and len(data[0]) > 100
    events = list(ttb.read_events(files[1]))
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[2]["scalars"]["train_step/loss"] == 0.25


def test_jsonl_logger_matches_jax(tmp_path, monkeypatch):
    from tpu_pillars.utils import logging as jlog
    from tpu_pillars_torch.utils import logging as tlog
    from tpu_pillars_torch.utils.tensorboard import (
        TeeLogger, TensorBoardWriter, read_events,
    )

    monkeypatch.setattr(jlog, "time", _Clock)
    monkeypatch.setattr(tlog, "time", _Clock)
    paths = [str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")]
    with jlog.JsonlLogger(paths[0]) as a:
        a.log("train_step", step=3, loss=0.5, num_pos=4.0)
    with TeeLogger(tlog.JsonlLogger(paths[1]),
                   TensorBoardWriter(str(tmp_path / "tb"))) as b:
        b.log("train_step", step=3, loss=0.5, num_pos=4.0)
        tb_path = b.sinks[1].path
    assert open(paths[0]).read() == open(paths[1]).read()
    assert _read(paths[1])[0]["t"] == 0.0
    assert list(read_events(tb_path))[1]["scalars"] == {
        "train_step/loss": 0.5, "train_step/num_pos": 4.0}
