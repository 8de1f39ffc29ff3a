#!/usr/bin/env python3
"""K10 (radix sort), K9 (block gather), K3 (BEV scatter) and K11 (stream
front end) on one NVIDIA card, at the serving batch's shapes: what
``chip_smoke.py`` does not show.

    python3 scripts/probe_torch_sort_gather.py

Builds the port's kernels, prints the compiler's register and shared-memory
use of ``csrc/radix_sort.cu``, ``csrc/bev_gather.cu``,
``csrc/bev_scatter.cu`` and ``csrc/stream_pfn.cu`` (``-Xptxas -v``, each
with its own flags),
makes ``chip_smoke.py``'s batch (8 lidar-like sweeps of 100,000 points at
``PillarsConfig()``), checks each kernel bit for bit against its yardstick
(the stable ``torch.sort`` + gather; K3 and ``index_copy_``), and prints the
device time of each kernel launch (``torch.profiler``, mean of 20 calls)
for:

* K10 with 18 key bits (the main path's) and with 32;
* K9 on K6's features of the classic batch, and again with every pillar
  masked (zeros only: the fill alone), beside a plain ``zero_()`` of a
  canvas of the same size (the card's write rate, for scale) and
  ``index_copy_`` into ``torch.zeros``;
* K3 on the same inputs (bit-equal to K9), and again with every pillar
  masked;
* K11 on the batch sorted and centred (its budget pass, ``stream_index``
  and ``stream_cutoff``, and its canvas kernel by name; checked against its
  plain version), and again with every sample empty (all ids the
  sentinel: zeros only), beside ``zero_()``.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line.
Needs a card; imports nothing of JAX. Under Nsight Compute, where the
machine has it: ``ncu --section MemoryWorkloadAnalysis --section LaunchStats
-k regex:bev_gather_kernel -c 1 python3 scripts/probe_torch_sort_gather.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ptxas_report(build_dir):
    """Registers, shared memory and spills of the kernels' sources."""
    from tpu_pillars_torch import _build

    out = {}
    os.makedirs(build_dir, exist_ok=True)
    for name in ("radix_sort", "bev_gather", "bev_scatter", "stream_pfn"):
        cmd = ([_build._nvcc()] + _build.NVCC_FLAGS
               + _build.EXTRA_FLAGS.get(name, []) + [
                   "-Xptxas", "-v", "-o",
                   os.path.join(build_dir, f"probe_{name}.so"),
                   str(_build.SRC_DIR / f"{name}.cu")])
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        out[name] = [ln for ln in (res.stdout + res.stderr).splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]
    return out


def device_ms(fn, n=20):
    """Device time per call of each kernel that ``fn`` launches, in ms
    (``torch.profiler``, CUDA activity, ``n`` calls after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", 0) or 0
        if total > 0:
            out[ev.key[:70]] = total / n / 1e3
    return out


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_torch_sort_gather: needs a CUDA card")
    import chip_smoke as cs
    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops import (
        bev, emit, fused_pfn, pfn, sort, stream_pfn, voxelize,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    _build.build_all()
    for name, lines in ptxas_report(str(_build.BUILD_DIR)).items():
        for ln in lines:
            print(f"ptxas {name}: {ln.strip()}")

    cfg = PillarsConfig()
    dev = torch.device("cuda")
    det = Detector.from_checkpoint(cfg, cs.CKPT, fused_frontend=False)
    clouds = cs.lidar_batch(np.random.default_rng(cs.SEED), cfg, cs.BATCH,
                            cs.POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = torch.from_numpy(np.stack([p for p, _ in padded])).to(dev)
    counts = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)
    B, M, F = points.shape
    HW = cfg.grid_h * cfg.grid_w
    bits = HW.bit_length()
    res = {"card": card, "B": B, "M": M, "F": F}

    # K10
    pid = voxelize.pillar_ids(points, counts, cfg)
    key, order = torch.sort(pid, dim=1, stable=True)
    want = (key, order, torch.gather(points, 1,
                                     order[..., None].expand(-1, -1, F)))
    for kb in (bits, 32):
        got = sort.bitonic_sort(pid, points, key_bits=kb)
        ok = all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want))
        print(f"K10 {kb} bits: bit-equal to the stable torch.sort: {ok}")
        if not ok:
            sys.exit(1)
    del want, key, order

    # K9 on K6's features of the classic batch
    w_pfn, b_pfn = det.model.pfn.folded()
    pb = emit.pillarize_batch_emit(points, counts, cfg)
    _, P, N, D = pb.features.shape
    feats = pfn.pfn_fused(pb.features.reshape(B * P, N, D),
                          pb.mask.reshape(B * P, N), w_pfn, b_pfn)
    feats = feats.reshape(B, P, -1)
    pid9 = (pb.coords[..., 0] * cfg.grid_w + pb.coords[..., 1]).to(
        torch.int32)
    mask9 = pb.pillar_mask
    none9 = torch.zeros_like(mask9)
    del pb
    canvas = bev.scatter_to_bev_emit(feats, pid9, mask9, cfg)
    library = cs.index_copy_scatter(feats, pid9, mask9, HW)
    ok = (torch.equal(canvas, bev.scatter_to_bev(feats, pid9, mask9, cfg))
          and torch.equal(canvas, library().reshape(canvas.shape))
          and torch.equal(bev.block_row_ranges(pid9, mask9, HW),
                          bev.block_row_ranges_plain(pid9, mask9, HW))
          and not bev.scatter_to_bev_emit(feats, pid9, none9, cfg).any())
    print(f"K9: bit-equal to K3 and index_copy_, ranges equal, zeros with "
          f"every pillar masked: {ok}")
    if not ok:
        sys.exit(1)
    lo = bev.block_row_ranges(pid9, mask9, HW)
    tiles = lo.shape[1] - 1
    empty = int((lo[:, 1:] == lo[:, :-1]).sum())
    print(f"K9: {int(mask9.sum())} pillars, {empty} of {B * tiles} tiles "
          f"of {bev.GATHER_TILE_CELLS} cells empty")
    fill = torch.empty_like(canvas)
    res["device_ms"] = {
        "radix_sort_18": device_ms(
            lambda: sort.bitonic_sort(pid, points, key_bits=bits)),
        "radix_sort_32": device_ms(lambda: sort.bitonic_sort(pid, points)),
        "bev_gather": device_ms(
            lambda: bev.scatter_to_bev_emit(feats, pid9, mask9, cfg)),
        "bev_gather_all_masked": device_ms(
            lambda: bev.scatter_to_bev_emit(feats, pid9, none9, cfg)),
        "zero_": device_ms(fill.zero_),
        "index_copy_": device_ms(library),
    }
    for what, per in res["device_ms"].items():
        print(f"device time by kernel, {what}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in per.items()))
    # K3 on the same inputs, one launch into torch.empty
    k3 = bev.scatter_to_bev(feats, pid9, mask9, cfg)
    ok = (torch.equal(k3, canvas)
          and not bev.scatter_to_bev(feats, pid9, none9, cfg).any())
    print(f"K3: bit-equal to K9, zeros with every pillar masked: {ok}")
    if not ok:
        sys.exit(1)
    del k3
    k3_ms = {
        "bev_scatter": device_ms(
            lambda: bev.scatter_to_bev(feats, pid9, mask9, cfg)),
        "bev_scatter_all_masked": device_ms(
            lambda: bev.scatter_to_bev(feats, pid9, none9, cfg)),
    }
    k3_ms["zero_"] = device_ms(fill.zero_)
    k3_ms["index_copy_"] = device_ms(library)
    res["device_ms"].update(k3_ms)
    for what, per in k3_ms.items():
        print(f"device time by kernel, {what}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in per.items()))
    # K11 on the batch, sorted and centred, with the checkpoint's folded
    # PFN; and with every sample empty
    del library, lo
    gid_s, pts_s = voxelize.sort_points_by_pillar(points, counts, cfg)
    pts_c = fused_pfn.center_points(gid_s, pts_s, cfg)
    w_eff, w_dec = fused_pfn.fold_decoration(w_pfn, b_pfn, cfg)
    empty_gid = torch.full_like(gid_s, HW)
    k11 = stream_pfn.stream_canvas_from_sorted(gid_s, pts_c, w_eff, w_dec,
                                               cfg)
    plain = stream_pfn.stream_canvas_from_sorted_plain(gid_s, pts_c, w_eff,
                                                       w_dec, cfg)
    ok = (torch.allclose(k11, plain, atol=1e-5, rtol=1e-5)
          and torch.equal(k11.ne(0).any(-1), plain.ne(0).any(-1))
          and not stream_pfn.stream_canvas_from_sorted(
              empty_gid, pts_c, w_eff, w_dec, cfg).any())
    print(f"K11: within 1e-5 of its plain version, occupancy equal, zeros "
          f"with every sample empty: {ok}")
    if not ok:
        sys.exit(1)
    del k11, plain
    k11_ms = {
        "stream_pfn": device_ms(lambda: stream_pfn.stream_canvas_from_sorted(
            gid_s, pts_c, w_eff, w_dec, cfg)),
        "stream_pfn_all_empty": device_ms(
            lambda: stream_pfn.stream_canvas_from_sorted(
                empty_gid, pts_c, w_eff, w_dec, cfg)),
        "zero_": device_ms(fill.zero_),
    }
    res["device_ms"].update({f"k11_{k}": v for k, v in k11_ms.items()})
    for what, per in k11_ms.items():
        print(f"device time by kernel, {what}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in per.items()))
    res["canvas_bytes"] = canvas.numel() * 4
    res["empty_tiles"] = empty
    res["tiles"] = B * tiles
    print(json.dumps(res))


if __name__ == "__main__":
    main()
