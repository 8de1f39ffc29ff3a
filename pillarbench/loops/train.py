"""``train``: ``train.loop.fit`` with ``make_train_step(config)`` on a pool
of numpy batches. One ``fit`` call, with one feed, runs the whole run:
the first ``compared_steps`` steps are set-up (they warm every shape),
then the feed synchronises, the window starts, and the feed hands out
batches until the window's end. The metric is ``train_sweeps_per_s``:
the samples of the steps taken in the window over its seconds, ending in
a synchronise.

Weights come from the seed on the card (``weights.seeded_state``), and
the same tensors start the reference. What is compared:

* the first steps, from the seed: each step's loss, the gradient of step
  1 as the optimizer took it (from its first moment) and each leaf's
  change over the steps (``judge.compare_training``);
* one step of the window, step ``compared_steps`` + w with w drawn from
  the seed in ``window_step`` [lo, hi]: the same three numbers, with the
  reference going on from the program's own state before that step
  (parameters and the optimizer's moments and count), and the step's
  gradient taken from the two first moments around it. So a fault that
  shows only once the loop runs steadily, or a schedule that goes wrong
  past the first steps, is seen too.
"""

from __future__ import annotations

import time

import numpy as np

from pillarbench import judge
from pillarbench import weights as W
from pillarbench.inputs import make_pool
from pillarbench.program import options, program_config
from pillarbench.reference.config import RefConfig
from pillarbench.roofline.counts import mean_counts
from pillarbench.session import Window, free, profiled_seconds, sync
from pillarbench.trace import DeviceProfile, Spans

KINDS = ("loss_gap", "grad_gap", "change_gap")


def _clone(tensors):
    return {k: v.detach().clone() for k, v in tensors}


class _Quiet:
    """A ``fit`` logger that keeps nothing."""

    def log(self, event, **kw):
        pass


class Watched:
    """The step, watched: keeps the loss of the first ``compared`` steps
    and of step ``at`` (0-d tensors, no synchronise), the gradient the
    optimizer took at step 1, the parameters after step ``compared``, and
    the state before and after step ``at``."""

    def __init__(self, step, compared: int, at: int):
        self.step, self.compared, self.at = step, compared, at
        self.n = 0
        self.names = None
        self.losses = {}
        self.grad1 = self.params = self.before = self.after = None

    def __call__(self, state, batch, split=None):
        self.n += 1
        n, model, opt = self.n, state.model, state.optimizer
        if self.names is None:
            self.names = [k for k, _ in model.named_parameters()]
        names = self.names
        if n == self.at:
            self.before = {"params": _clone(model.named_parameters()),
                           "count": opt.count,
                           "mu": _clone(zip(names, opt.mu)),
                           "nu": _clone(zip(names, opt.nu))}
        state, losses = self.step(state, batch, split)
        if n <= self.compared or n == self.at:
            self.losses[n] = losses.total
        if n == 1:
            self.grad1 = {k: m.detach() / (1.0 - opt.b1)
                          for k, m in zip(names, opt.mu)}
        if n == self.compared:
            self.params = _clone(model.named_parameters())
        if n == self.at:
            self.after = {"params": _clone(model.named_parameters()),
                          "mu": _clone(zip(names, opt.mu))}
        return state, losses


def _numpy(d: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


class Loop:
    def __init__(self, cell, args, device, root, split):
        from tpu_pillars_torch.train.state import (
            TrainConfig, create_train_state,
        )
        from tpu_pillars_torch.train.step import make_train_step

        self.cell, self.device, self.split = cell, device, split
        self.traffic = t = cell.traffic
        fields = cell.config["config"]
        self.rcfg = RefConfig(fields)
        self.pcfg = program_config(fields)
        at = time.perf_counter()
        self.init = W.seeded_state(W.state_shapes(self.rcfg), args.seed,
                                   device)
        split["weights"] = time.perf_counter() - at
        at = time.perf_counter()
        self.pool = make_pool(t, fields, args.seed, cell.home)
        split["pool"] = time.perf_counter() - at
        self.batch = t["batch"]
        self.compared = t["compared_steps"]
        lo, hi = t["window_step"]
        self.at = self.compared + int(
            np.random.default_rng([args.seed, 5]).integers(lo, hi + 1))
        opt = options(cell.config)
        self.tcfg = TrainConfig(batch_size=self.batch,
                                max_gt_boxes=t["max_gt"], **t["optimizer"])
        self.state = create_train_state(
            self.pcfg, self.tcfg, device=device,
            state_dict={k: v.clone() for k, v in self.init.items()})
        self.watched = Watched(
            make_train_step(self.pcfg,
                            max_gt_per_class=t["max_gt_per_class"],
                            compute_dtype=opt["dtype"],
                            fused_frontend=opt["fused_frontend"]),
            self.compared, self.at)
        self.steps = 0

    def _feed(self, begin):
        """The first steps' batches, then ``begin()`` (which returns the
        window's end), then batches until that end. Step n takes batch
        (n - 1) mod the pool's size."""
        for k in range(self.compared):
            yield self.pool[k]
        t_end = begin()
        k = self.compared
        while time.perf_counter() < t_end:
            self.steps += 1
            yield self.pool[k % len(self.pool)]
            k += 1

    def run_spans(self, t_end: float, spans: Spans) -> int:
        """Steps with the step's own synchronised split (ms by phase)."""
        from tpu_pillars_torch.train.step import batch_to_device

        steps = 0
        k = self.watched.n
        while time.perf_counter() < t_end:
            split = {}
            self.watched(self.state, batch_to_device(
                self.pool[k % len(self.pool)], self.device), split=split)
            for name, v in split.items():
                spans.ms[name].append(v)
            steps += 1
            k += 1
        return steps

    def measure(self, seconds: float, trace: bool) -> Window:
        from tpu_pillars_torch.train.loop import fit

        start = time.perf_counter()
        mark = {}

        def begin():
            sync(self.device)
            mark["t0"] = t0 = time.perf_counter()
            self.split["first_steps"] = t0 - start
            if not trace:
                return t0 + seconds
            mark["profile"] = DeviceProfile().start()
            return time.perf_counter() + profiled_seconds(seconds)

        fit(self.state, self._feed(begin), 1 << 40, self.watched, self.pcfg,
            logger=_Quiet())
        t0 = mark["t0"]
        if not trace:
            sync(self.device)
            window = time.perf_counter() - t0
            return Window(t0, {"train_sweeps_per_s":
                               self.steps * self.batch / window}, self.steps)
        prof = mark["profile"].stop()
        profiled = self.steps
        spans = Spans()
        steps = profiled + self.run_spans(
            time.perf_counter() + seconds - profiled_seconds(seconds), spans)
        return Window(t0, {}, steps, profile=prof,
                      profiled_items=profiled * self.batch, spans=spans)

    def lines(self) -> list:
        return [f"window step compared: step {self.at} of "
                f"{self.watched.n}"]

    def input_counts(self) -> dict:
        clouds = [b[0][i, :int(b[1][i])] for b in self.pool
                  for i in range(len(b[1]))]
        return mean_counts(clouds, self.rcfg, crop=False)

    # ---- the comparison

    def program_readings(self):
        """-> (first steps, window step): each {"losses", "grad1",
        "params"} (numpy) and the parameters it started from, or None
        where the window never reached its step."""
        w, b1 = self.watched, self.state.optimizer.b1
        first = ({"losses": [float(w.losses[n])
                             for n in range(1, self.compared + 1)],
                  "grad1": _numpy(w.grad1), "params": _numpy(w.params)},
                 {k: v.cpu().numpy() for k, v in self.init.items()})
        if w.after is None:
            return first, None
        before = w.before
        grad = {k: (w.after["mu"][k] - b1 * before["mu"][k]) / (1.0 - b1)
                for k in before["mu"]}
        window = ({"losses": [float(w.losses[self.at])],
                   "grad1": _numpy(grad),
                   "params": _numpy(w.after["params"])},
                  _numpy(before["params"]))
        return first, window

    def reference(self, window: bool, tf32: bool = False,
                  half: bool = False) -> dict:
        """The reference's first steps from the seed, or (``window``) its
        window step from the program's state before it; ``tf32`` computes
        it in TF32 (the control), ``half`` leaves out half of each batch
        (a fault)."""
        from pillarbench.reference.train import train_steps

        t = self.traffic
        if window:
            b = self.watched.before
            start = {"count": b["count"], "mu": b["mu"], "nu": b["nu"]}
            weights = b["params"]
            batches = [self.pool[(self.at - 1) % len(self.pool)]]
        else:
            start, weights = None, self.init
            batches = self.pool[:self.compared]
        if half:
            batches = [tuple(x[:len(x) // 2] for x in bt) for bt in batches]
        out = train_steps(weights, self.rcfg, batches, t["optimizer"],
                          t["max_gt_per_class"], self.device,
                          allow_tf32=tf32, start=start)
        return {"losses": out["losses"], "grad1": _numpy(out["grad1"]),
                "params": _numpy(out["params"])}

    def free_program(self):
        """Drops the program's state and step; the snapshots stay."""
        self.state = None
        self.watched.step = None
        free()

    def judge(self):
        (prog, initial), window = self.program_readings()
        self.free_program()
        at = time.perf_counter()
        ref = self.reference(window=False)
        numbers = judge.compare_training(prog, ref, initial)
        if window is None:
            numbers.update({f"window_{k}": float("inf") for k in KINDS})
        else:
            w = judge.compare_training(window[0], self.reference(True),
                                       window[1])
            numbers.update({f"window_{k}": w[k] for k in KINDS})
        return numbers, [
            f"reference: {self.compared} steps and window step {self.at} in "
            f"{time.perf_counter() - at:.1f} s; losses program "
            f"{prog['losses']} reference {ref['losses']}; "
            f"{numbers['moving_leaves']} leaves compared by their change",
            "numbers: " + ", ".join(f"{k} {numbers[k]!r}" for k in
                                    KINDS + tuple(f"window_{k}"
                                                  for k in KINDS))]

    def controls(self, seconds: float) -> dict:
        """Runs the program for a window of ``seconds`` (it has to reach the
        window step), then reads, against the reference in float32, the
        control (the reference in TF32 in the program's place) and the
        fault "half of the batch left out, the mean taken over the rest"
        (the reference on half of each batch), on the first steps from
        the seed and on the window step from the program's state. The
        fault "a step that returns its state unchanged" reads 1 on both
        change gaps by construction and needs no run."""
        self.measure(seconds, trace=False)
        (_, initial), window = self.program_readings()
        self.free_program()
        if window is None:
            raise RuntimeError(f"the window never reached step {self.at}")
        first, last = self.reference(False), self.reference(True)
        out = {}
        for kind, kw in (("control", {"tf32": True}),
                         ("half_batch", {"half": True})):
            numbers = judge.compare_training(self.reference(False, **kw),
                                             first, initial)
            w = judge.compare_training(self.reference(True, **kw), last,
                                       window[1])
            numbers.update({f"window_{k}": w[k] for k in KINDS})
            out[kind] = numbers
        return out

