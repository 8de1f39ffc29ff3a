"""The control of the comparison that decides ``correct``, and a cell's
planted faults, read on the card at a cell's own size.

    python3 -m pillarbench.control --workload <cell> --seeds 21 22 23

For each seed it builds the cell as a run does and asks its loop for
``controls(seconds)``: by the cell's own numbers (``judge``), what the
reference computed in TF32 (the nearest precision below the float32 the
configuration states, with TF32 off) reads in the program's place, and
what each planted fault reads (see each loop's ``controls``). It prints
one line of numbers a seed and a last JSON line. The benchmark's runs do
not run it; ``tests/test_pillarbench_control.py`` runs it at a small
size.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pillarbench.cells import ROOT, Cell


def run(cell: Cell, seeds, device, seconds: float = 6.0) -> dict:
    out = {}
    for seed in seeds:
        args = argparse.Namespace(workload=cell.name, seed=seed,
                                  seconds=seconds, trace=0)
        loop = cell.loop()(cell, args, device, ROOT, {})
        out[seed] = loop.controls(seconds)
        del loop
        print(f"seed {seed}: {json.dumps(out[seed])}", flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0,
                    help="window of a loop that runs the program first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pillarbench.control: no CUDA device", file=sys.stderr)
        return 2
    from tpu_pillars_torch import _build

    _build.build_all()
    out = run(Cell(args.workload), args.seeds, torch.device("cuda", 0),
              args.seconds)
    first = next(iter(out.values()))
    summary = {}
    for kind in first:
        for name in first[kind]:
            vals = [o[kind][name] for o in out.values()]
            summary[f"{kind}.{name}"] = [float(np.min(vals)),
                                         float(np.max(vals))]
    print(json.dumps({"workload": args.workload, "min_max": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
