#!/usr/bin/env python
"""Export a training run of the PyTorch/CUDA port as an inference
artifact: the port of ``scripts/export_artifact.py``.

Host only (no card): reads the run directory of ``python -m
tpu_pillars_torch.train.loop`` (its ``train.log``, or the loop's own
``train.jsonl`` when there is no ``train.log``), picks the raw or the EMA
weights by the FINAL ``eval`` event's held-out mAP (EMA when ``mAP_ema >=
mAP``), then either strips the optimizer state from ``ckpt.msgpack`` with
``train.checkpoint.export_inference_checkpoint`` (raw; stamped with the
``PillarsConfig()`` fingerprint) or copies the loop's ``ckpt.msgpack.ema``
(already stripped), and writes a provenance note beside the file. Both
packages' ``Detector.from_checkpoint`` serve the result; from the same run
directory it is byte for byte the file ``scripts/export_artifact.py``
writes.

    python scripts/torch_export_artifact.py --run RUN_DIR \\
        [--out artifacts/pointpillars_synth4k.msgpack]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True,
                   help="run directory of tpu_pillars_torch.train.loop")
    p.add_argument("--out", default=os.path.join(
        REPO, "artifacts", "pointpillars_synth4k.msgpack"))
    return p.parse_args(argv)


def read_events(run: str):
    """The run's ``start`` event (or None) and its ``eval`` events, from
    ``train.log`` or else ``train.jsonl``; lines that are not JSON objects
    are skipped."""
    log_path = os.path.join(run, "train.log")
    if not os.path.exists(log_path):
        log_path = os.path.join(run, "train.jsonl")
    evals, start = [], None
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if rec.get("event") == "eval":
                evals.append(rec)
            elif rec.get("event") == "start":
                start = rec
    if not evals:
        sys.exit(f"no eval events in {log_path}")
    return start, evals


def main(argv=None) -> dict:
    """Writes the artifact and its PROVENANCE.md; returns {"out", "ema",
    "mAP", "mAP_ema", "bytes"}."""
    args = parse_args(argv)
    start, evals = read_events(args.run)
    final = evals[-1]
    m_raw, m_ema = final.get("mAP", 0.0), final.get("mAP_ema", -1.0)
    use_ema = m_ema >= m_raw
    print(f"final eval (step {final['step']}): mAP raw {m_raw:.4f} / "
          f"ema {m_ema:.4f} -> exporting {'EMA' if use_ema else 'RAW'}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if use_ema:
        shutil.copyfile(os.path.join(args.run, "ckpt.msgpack.ema"), args.out)
    else:
        from tpu_pillars_torch.config import PillarsConfig
        from tpu_pillars_torch.train.checkpoint import (
            export_inference_checkpoint,
        )

        export_inference_checkpoint(
            args.out, os.path.join(args.run, "ckpt.msgpack"),
            config=PillarsConfig())
    size = os.path.getsize(args.out)

    steps = start["steps"] if start else "?"
    batch = start["batch"] if start else "?"
    device = start.get("device", "?") if start else "?"
    prov = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                        "PROVENANCE.md")
    with open(prov, "w") as f:
        f.write(f"""# {os.path.basename(args.out)}

Trained inference checkpoint (params + batch_stats + config fingerprint,
no optimizer state) for the full-size `PillarsConfig()` operating point.

- produced by: `python -m tpu_pillars_torch.train.loop --steps {steps}
  --batch {batch} ...` on {device}, run directory `{args.run}`
- weights: {'EMA' if use_ema else 'raw'}, picked by the final held-out
  mAP: raw {m_raw:.4f} vs EMA {m_ema:.4f}
- final eval: step {final['step']}
- size: {size / 1e6:.1f} MB
- loads via `Detector.from_checkpoint(PillarsConfig(), path)` in either
  package
""")
    print(f"wrote {args.out} ({size / 1e6:.1f} MB) + {prov}")
    return {"out": args.out, "ema": use_ema, "mAP": m_raw, "mAP_ema": m_ema,
            "bytes": size}


if __name__ == "__main__":
    main()
