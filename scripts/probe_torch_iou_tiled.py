#!/usr/bin/env python3
"""K7 (tiled rotated IoU) on one NVIDIA card, at the drop-in path's
shapes: the kernel's device time, which ``chip_smoke.py`` does not show.

    python3 scripts/probe_torch_iou_tiled.py [--root DIR] [--label A]
        [--skip-ptxas] [--sass] [--variants 32x64 whole-strips ...]

``--root`` is the checkout whose ``tpu_pillars_torch`` is timed (default:
this one), so one call can time two trees with the same probe, each in
processes of its own (for example A B B A B B, A the parent commit unpacked
with ``git archive``). Inputs, as ``chip_smoke.py`` makes them: the top-k
candidates (8 x 1,024 boxes) of the committed checkpoint's serving batch
(8 lidar-like sweeps of 100,000 points, seed 0, ``PillarsConfig()``),
recorded from ``Detector.predict_packed_batch``. Cases:

* ``self``: the candidates against themselves (chip_smoke.py's input), at
  the default blocks of 128, and again at blocks of 64 and of 256;
* ``cross``: each sample's candidates against the next sample's;
* ``all cold``: against themselves moved 1 km along x (no pair passes the
  circumradius gate: zeros only);
* ``all hot``: against themselves with every centre moved within 0.3 m of
  the origin (every pair passes it).

For each: the pairs that pass the gate (for ``self`` also their mean
number in a 64 x 64 sub-range, by the sub-range's row strip), max |d|
against the plain version
(on the card), the device time per call of every kernel it launches
(``torch.profiler``, mean of 20 calls after a warm-up; a torch op in the
wrapper shows as a kernel of its own), their sum and the wrapper's time as
``chip_smoke.py`` takes it (CUDA events around 20 back-to-back calls,
median of 5); for ``self`` also the host's time per call (the wall clock of
200 calls not waited for). Prints the card (``nvidia-smi`` name and power
limit), the compiler's register, shared-memory and spill report of
``csrc/iou_tiled.cu`` with its own flags (``-Xptxas -v``; ``--skip-ptxas``
leaves it out) and, last, one JSON line. ``--variants`` also builds the
source changed as each named variant of ``VARIANTS`` says and times those
builds on all four cases through their C entry, against the tree's own
kernel. ``--sass`` counts the instructions of the loop over listed pairs
(between the kernel's second and third barrier, ``cuobjdump -sass``) by
opcode. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

from probe_torch_emit_pfn import device_ms, ptxas_report, report


def serving_candidates(root, cs):
    """The (B, 1,024, 7) top-k candidates of chip_smoke.py's serving batch,
    before the class shift (as ``chip_smoke.py`` records them)."""
    import numpy as np
    import torch

    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops import postprocess

    cfg = PillarsConfig()
    det = Detector.from_checkpoint(cfg, os.path.join(
        root, "artifacts", "pointpillars_synth4k.msgpack"))
    clouds = cs.lidar_batch(np.random.default_rng(cs.SEED), cfg, cs.BATCH,
                            cs.POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = torch.from_numpy(np.stack([q for q, _ in padded])).to("cuda")
    counts = torch.from_numpy(np.asarray([n for _, n in padded])).to("cuda")
    shift = 4.0 * ((cfg.x_max - cfg.x_min) + (cfg.y_max - cfg.y_min))
    cands = []
    nms_entry = postprocess.rotated_nms_overlap

    def recording(shifted, valid, thr, class_ids=None, class_gap=0.0):
        boxes = shifted.clone()
        boxes[..., 0] = shifted[..., 0] - class_ids.to(boxes.dtype) * shift
        cands.append(boxes)
        return nms_entry(shifted, valid, thr, class_ids=class_ids,
                         class_gap=class_gap)

    postprocess.rotated_nms_overlap = recording
    try:
        det.predict_packed_batch(points, counts)
    finally:
        postprocess.rotated_nms_overlap = nms_entry
    torch.cuda.synchronize()
    return cands[0]


def gate(b1, b2):
    """(B, n, m) bool: the pairs that pass the circumradius gate, as the
    kernel takes it."""
    import torch

    dx = b1[:, :, None, 0] - b2[:, None, :, 0]
    dy = b1[:, :, None, 1] - b2[:, None, :, 1]
    r1 = torch.sqrt(b1[..., 3] * b1[..., 3] + b1[..., 4] * b1[..., 4])
    r2 = torch.sqrt(b2[..., 3] * b2[..., 3] + b2[..., 4] * b2[..., 4])
    rr = 0.5 * (r1[:, :, None] + r2[:, None, :])
    return ~(dx * dx + dy * dy > rr * rr)


def strip_means(hot):
    """Mean hot pairs of a 64 x 64 sub-range (whole sub-ranges only), by
    its row strip."""
    B, n, m = hot.shape
    hot = hot[:, :n // 64 * 64, :m // 64 * 64].float()
    per = hot.reshape(B, n // 64, 64, m // 64, 64).sum((2, 4))
    return [round(float(v), 1) for v in per.mean((0, 2))]


# the source's lines that --variants rewrites, each (pattern, replacement)
WHOLE = (r"const long long split = [^;]+;", "const long long split = 0;")
VARIANTS = {
    # sub-ranges of 32 rows x 64 columns, twice as many blocks
    "32x64": [(r"constexpr int kSubR = \d+;", "constexpr int kSubR = 32;")],
    # no strip of row sub-ranges cut in halves
    "whole-strips": [WHOLE],
    # whole strips, and the blocks in sample-major order (each sample's
    # sub-ranges row by row, then the next sample's)
    "sample-major": [WHOLE, (
        r"const int unit = blockIdx.x;",
        "const int unit = (int)(blockIdx.x % (nrb * ncb) / ncb * ncb * batch"
        " + blockIdx.x % ncb * batch + blockIdx.x / (nrb * ncb));")],
}


def variant_builds(root, build_dir, names):
    """The kernel source built as each variant of ``VARIANTS`` in
    ``names``: {name: C entry}."""
    from tpu_pillars_torch import _build

    src = open(os.path.join(root, "tpu_pillars_torch", "csrc",
                            "iou_tiled.cu")).read()
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for side in names:
        body = src
        for pat, new in VARIANTS[side]:
            body, hits = re.subn(pat, new, body)
            if hits != 1:
                sys.exit(f"probe_torch_iou_tiled: variant {side}: "
                         f"{pat!r} matches {hits} lines")
        cu = os.path.join(build_dir, f"iou_tiled_{side}.cu")
        so = os.path.join(build_dir, f"libiou_tiled_{side}.so")
        with open(cu, "w") as f:
            f.write(body)
        procs[side] = (subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + _build.EXTRA_FLAGS["iou_tiled"] + ["-Xptxas", "-v", "-o", so,
                                                 cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    entries = {}
    for side, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            sys.exit(f"probe_torch_iou_tiled: {side} did not build:\n"
                     f"{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {side}: {ln.strip()}")
        fn = ctypes.CDLL(so).iou_tiled
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[side] = fn
    return entries


def sass_counts(build_dir):
    """Opcode counts of the instructions between the second and the third
    ``BAR.SYNC`` of the tree's K7 kernel: its loop over listed pairs (the
    divisions' slow paths, called, not counted)."""
    import collections

    from tpu_pillars_torch import _build

    lib = _build.build_all()["iou_tiled"]
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    with open(os.path.join(build_dir, "iou_tiled.sass"), "w") as f:
        f.write(sass)
    ops, bars = [], 0
    insn = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")
    for ln in sass.splitlines():
        m = insn.match(ln)
        if not m:
            continue
        op = m.group(1).split(".")[0]
        if op == "BAR":
            bars += 1
        elif bars == 2:
            ops.append(op)
    return dict(collections.Counter(ops).most_common())


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=here,
                   help="checkout whose tpu_pillars_torch is timed")
    p.add_argument("--label", default="",
                   help="a name for this tree in the output")
    p.add_argument("--skip-ptxas", action="store_true",
                   help="leave out the compiler's report")
    p.add_argument("--sass", action="store_true",
                   help="count the instructions of the loop over pairs")
    p.add_argument("--variants", nargs="*", default=[],
                   choices=sorted(VARIANTS),
                   help="also time the source built as these variants")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_torch_iou_tiled: needs a CUDA card")
    import chip_smoke as cs
    from tpu_pillars_torch import _build
    from tpu_pillars_torch.ops import iou_tiled

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"tree: {args.label or root} ({root})")
    _build.build_all()
    res = {"label": args.label, "root": root, "card": card,
           "pid": os.getpid()}
    if not args.skip_ptxas:
        res["ptxas"] = ptxas_report(str(_build.BUILD_DIR), ("iou_tiled",))
        for ln in res["ptxas"]["iou_tiled"]:
            print(f"ptxas iou_tiled: {ln}")
    if args.sass:
        res["sass"] = sass_counts(str(_build.BUILD_DIR))
        print(f"sass, loop over listed pairs: {sum(res['sass'].values())} "
              f"instructions: {res['sass']}")

    cands = serving_candidates(root, cs)
    B, K, _ = cands.shape
    gen = np.random.default_rng(cs.SEED + 3)
    far = cands.clone()
    far[..., 0] += 1000.0
    near = cands.clone()
    near[..., 0:2] = torch.from_numpy(gen.uniform(
        -0.3, 0.3, (B, K, 2)).astype(np.float32)).cuda()
    cases = {
        "self": (cands, cands, 128),
        "self, blocks of 64": (cands, cands, 64),
        "self, blocks of 256": (cands, cands, 256),
        "cross": (cands, cands.roll(1, 0), 128),
        "all cold": (cands, far, 128),
        "all hot": (near, near, 128),
    }
    ok = True
    for name, (b1, b2, blk) in cases.items():
        call = (lambda b1=b1, b2=b2, blk=blk:
                iou_tiled.rotated_iou_bev_tiled(b1, b2, blk, blk))
        got = call()
        want = iou_tiled.rotated_iou_bev_tiled_plain(b1, b2, blk, blk)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        warm = gate(b1, b2)
        hot = int(warm.sum())
        ok = ok and err <= 1e-5 and (name != "all cold" or not got.any())
        print(f"K7 {name}: {hot} of {B * K * K} pairs pass the gate; max "
              f"|d| {err:.3e} against the plain version (bit-equal: "
              f"{torch.equal(got, want)})", flush=True)
        res[f"{name} hot pairs"] = hot
        if name == "self":
            res["self hot pairs by row strip"] = strip_means(warm)
            print(f"K7 self: mean hot pairs of a 64 x 64 sub-range, by row "
                  f"strip: {res['self hot pairs by row strip']}")
        res[f"{name} max_abs_err"] = err
        del got, want
        torch.cuda.empty_cache()
        report(res, f"K7 {name}", call, cs.cuda_ms(call, 20),
               host=name == "self")
    if args.variants:
        variants(res, root, _build, cases, args.variants)
    print(json.dumps(res))
    if not ok:
        sys.exit(1)


def variants(res, root, _build, cases, names):
    """The source built as other variants, called through its C entry on
    the four cases at blocks of 128: device time, and max |d| against the
    tree's own kernel's output."""
    import torch

    from tpu_pillars_torch.ops import iou_tiled

    entries = variant_builds(root, str(_build.BUILD_DIR / "variants"), names)
    for name in ("self", "cross", "all cold", "all hot"):
        b1, b2, _ = cases[name]
        B, n, m = b1.shape[0], b1.shape[1], b2.shape[1]
        want = iou_tiled.rotated_iou_bev_tiled(b1, b2)
        for side, fn in entries.items():
            out = torch.empty((B, n, m), device=b1.device)

            def call(fn=fn, out=out, b1=b1, b2=b2, side=side):
                err = fn(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), B, n,
                         m, 128, 128, *b1.stride(), *b2.stride(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{side}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            d = float((out - want).abs().max())
            per = device_ms(call)
            res[f"variant {side} {name}"] = {"kernels": per,
                                            "max_abs_err": d}
            print(f"K7 {side} {name}: device "
                  + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
                  + f" ms; max |d| {d:.3e} against the tree's kernel",
                  flush=True)


if __name__ == "__main__":
    main()
