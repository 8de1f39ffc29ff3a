#!/usr/bin/env python
"""Build the ~1000-sample on-disk Lyft-format dress-rehearsal dataset with
the PyTorch/CUDA port's fixture writer (``tpu_pillars_torch.data.fixture``):
disk .bin sweeps and JSON tables in the layout ``data.lyft.LyftDataset``
reads, at realistic scale, so that the host loader's throughput can be
measured against the training step on real-sized data.

Host numpy only (no card, no torch tensor). The same arguments give the
same bytes as ``scripts/rehearsal_dataset.py``. ~1.3 GB on disk at the
default density (~33k points a sweep).

    python scripts/torch_rehearsal_dataset.py --root lyft1k
    python -m tpu_pillars_torch.train.loop --full-size --data lyft1k/data
    python -m tpu_pillars_torch.evaluation.cli --data lyft1k/data \\
        --ckpt CKPT --full-size
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="lyft1k")
    p.add_argument("--scenes", type=int, default=100)
    p.add_argument("--samples-per-scene", type=int, default=10)
    p.add_argument("--sweeps-per-sample", type=int, default=2)
    p.add_argument("--num-objects", type=int, default=25)
    p.add_argument("--points-per-object", type=int, default=300)
    p.add_argument("--clutter", type=int, default=25000)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Writes the dataset; returns {"json_dir", "samples", "bytes",
    "seconds"}."""
    args = parse_args(argv)

    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.data.fixture import build_fixture

    t0 = time.perf_counter()
    json_dir = build_fixture(args.root, PillarsConfig(),
                             num_scenes=args.scenes,
                             samples_per_scene=args.samples_per_scene,
                             sweeps_per_sample=args.sweeps_per_sample,
                             seed=args.seed,
                             num_objects=args.num_objects,
                             points_per_object=args.points_per_object,
                             clutter=args.clutter)
    dt = time.perf_counter() - t0
    n_samples = args.scenes * args.samples_per_scene
    size = 0
    for dirpath, _, files in os.walk(args.root):
        size += sum(os.path.getsize(os.path.join(dirpath, f)) for f in files)
    print(f"built {n_samples} samples ({args.sweeps_per_sample} sweeps each) "
          f"at {args.root}: {size / 1e9:.2f} GB in {dt:.0f} s "
          f"({n_samples / dt:.1f} samples/s)")
    return {"json_dir": json_dir, "samples": n_samples, "bytes": size,
            "seconds": dt}


if __name__ == "__main__":
    main()
