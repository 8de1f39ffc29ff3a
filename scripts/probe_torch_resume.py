#!/usr/bin/env python3
"""SIGTERM and ``--resume`` of a full-size training run of the port, on the
card.

    python3 scripts/probe_torch_resume.py [--steps 6] [--kill-at 3] \\
        [--out DIR]

Runs ``python -m tpu_pillars_torch.train.loop --full-size --batch 8
--seed 0`` (``--cpu``: the tiny config, batch 1, on the CPU) three times,
each its own process with its files and output (``<run>.log``) under
``--out`` (default: a temporary directory, removed at the end; two full
checkpoints of the full config take 120 MB): unbroken for ``--steps``;
again, sent SIGTERM once its heartbeat reaches ``--kill-at`` (it must exit
0, having logged ``preempted`` and written its full checkpoint); then with
``--resume`` (it must log ``resumed_at`` equal to the preempted step and
write a checkpoint at ``--steps``). Prints the last step's losses of the
unbroken and the resumed run and the largest difference of their final
weights, and fails unless the losses agree within rtol 2e-3 (cuDNN's
backward need not be deterministic). Prints each process's wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fail(msg: str) -> None:
    print(f"probe_torch_resume: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def events(out: str) -> list:
    with open(os.path.join(out, "train.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--kill-at", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the CPU at the tiny config, batch 1")
    args = p.parse_args()
    if args.out is None:
        with tempfile.TemporaryDirectory() as tmp:
            args.out = tmp
            run(args)
    else:
        run(args)


def run(args) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np

    from tpu_pillars_torch.train.elastic import check_heartbeat
    from tpu_pillars_torch.weights import load_flax_msgpack

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")

    os.makedirs(args.out, exist_ok=True)

    def train(out, *extra):
        size = (["--device", "cpu", "--batch", "1"] if args.cpu
                else ["--full-size", "--batch", "8"])
        with open(f"{out}{'-resume' if extra else ''}.log", "w") as log:
            return subprocess.Popen(
                [sys.executable, "-m", "tpu_pillars_torch.train.loop", *size,
                 "--seed", "0", "--steps", str(args.steps), "--out", out,
                 *extra], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)

    def finish(proc, what):
        if proc.wait(timeout=600) != 0:
            fail(f"{what} exited {proc.returncode} (its log is under "
                 f"{args.out})")

    whole = os.path.join(args.out, "unbroken")
    broken = os.path.join(args.out, "broken")
    t0 = time.perf_counter()
    finish(train(whole), "the unbroken run")
    print(f"unbroken run: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    proc = train(broken)
    beat = os.path.join(broken, "heartbeat.json")
    while check_heartbeat(beat, 1e9)["step"] < args.kill_at:
        if proc.poll() is not None:
            fail(f"the run to be killed exited early (its log is under "
                 f"{args.out})")
        time.sleep(0.01)
    proc.send_signal(signal.SIGTERM)
    t_kill = time.perf_counter()
    finish(proc, "the SIGTERMed run")
    pre = [e["step"] for e in events(broken) if e["event"] == "preempted"]
    if len(pre) != 1 or not 0 < pre[0] < args.steps:
        fail(f"the SIGTERMed run logged preempted at {pre}")
    saved = int(load_flax_msgpack(os.path.join(broken, "ckpt.msgpack"))
                ["step"])
    if saved != pre[0]:
        fail(f"checkpoint at step {saved}, preempted at {pre[0]}")
    print(f"SIGTERM at heartbeat step >= {args.kill_at}: preempted at step "
          f"{pre[0]}, exit 0 {time.perf_counter() - t_kill:.2f} s after "
          f"the signal; run {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    finish(train(broken, "--resume"), "the resumed run")
    start = [e for e in events(broken) if e["event"] == "start"][-1]
    if start["resumed_at"] != pre[0]:
        fail(f"resumed_at {start['resumed_at']}, preempted at {pre[0]}")
    got = load_flax_msgpack(os.path.join(broken, "ckpt.msgpack"))
    want = load_flax_msgpack(os.path.join(whole, "ckpt.msgpack"))
    if int(got["step"]) != args.steps:
        fail(f"the resumed run ended at step {int(got['step'])}")
    keys = ("loss", "cls", "loc", "dir")
    last = [[e[k] for k in keys] for run in (whole, broken)
            for e in events(run)
            if e["event"] == "train_step" and e["step"] == args.steps]
    if len(last) != 2:
        fail(f"last-step losses {last}")
    d = float(np.abs(np.subtract(*last)).max())
    dw = max(float(np.abs(a - b).max())
             for a, b in zip(_leaves(got["params"]), _leaves(want["params"])))
    print(f"resumed run: resumed_at {pre[0]}, {time.perf_counter() - t0:.1f}"
          f" s; step {args.steps} losses (loss, cls, loc, dir) unbroken "
          f"{last[0]}, resumed {last[1]}; max |d| {d:.3e}, bit-equal "
          f"{last[0] == last[1]}; final parameters max |d| {dw:.3e}")
    if not np.allclose(last[1], last[0], rtol=2e-3, atol=0):
        fail("the resumed run left the unbroken run's loss curve")


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


if __name__ == "__main__":
    main()
