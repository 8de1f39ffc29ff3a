"""Run one cell of the benchmark once and print its result.

    python3 -m pillarbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The run loads the port (``tpu_pillars_torch``),
makes its inputs and weights from ``--seed``, warms the cell's shapes
(set-up), measures for ``--seconds``, then checks what the timed path
produced against the plain reference (``pillarbench/reference``). Its last
line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit. Earlier lines name
the card and its power limit, split the set-up and count truncated clouds.
With no CUDA card, or fewer than the cell asks for, it exits 2 and prints
no result; it exits 3 without a result when the JAX package or JAX was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".pillarbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pillars")


def _environment() -> None:
    """Every build and kernel cache inside the checkout at a fixed path;
    no library of the run loads JAX on its own."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def say(*a) -> None:
    print(*a, flush=True)


def main(argv=None, device=None) -> int:
    """``device`` other than None skips the look for a card (the tests'
    drive of a whole run on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from pillarbench import cells

    cell = cells.Cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("pillarbench: no CUDA device; the benchmark runs on the "
                  "card only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"pillarbench: {cell.name} needs {cell.chips} CUDA "
                  f"devices, {torch.cuda.device_count()} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    from pillarbench.session import run_cell

    result, lines, checks = run_cell(cell, args, device, T_START, ROOT)
    for line in lines:
        say(line)
    found = loaded_forbidden()
    if found:
        print(f"pillarbench: loaded {found} in the measuring process; no "
              f"result", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    say(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
