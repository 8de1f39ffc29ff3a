"""tpu_pillars_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor the
JAX package, so it also runs on a machine that has neither:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

K1 emit and K3 scatter are held bit for bit, K3's backward too; K2 fused
PFN and K6 PFN to atol 1e-5, rtol 1e-5 (both sides round the same f32
operations in the same order; the kernels are built without fused
multiply-adds); K10 radix sort, K8 binning and K9 block gather bit for
bit (K10 also against the stable torch.sort, K9 against K3); K11 stream
front end to atol 1e-5 / rtol 1e-5 with the occupancy equal, and to atol
1e-4 of the fused path's canvas (K1, K2, K3); K7 tiled IoU to atol 1e-5,
and to 1e-3 of the dense IoU on boxes within 8 m of the origin (the JAX
package's own test of its kernel); K4
overlap equal except pairs whose IoU lies within 1e-4 of the threshold; K5
best IoU within 2e-5 and the best GT equal wherever the IoU is positive and
not tied within 2e-5; the detector's packed output on the card against the
same detector on the CPU at the tolerance of
tests/test_detector_e2e.py::test_jitted_pipeline_matches_cpu_reference; two
training steps on the card against the same steps on the CPU (loss rtol
1e-3, equal positives)."""

import numpy as np
import pytest
import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.detector import Detector
from tpu_pillars_torch.models.pointpillars import PointPillars
from tpu_pillars_torch.ops import (
    assign, bev, binning, emit, fused_pfn, iou, iou_tiled, nms_overlap, pfn,
    sort, stream_pfn,
)
from tpu_pillars_torch.ops.target_assigner import group_gt_by_class
from tpu_pillars_torch.ops.voxelize import (
    pillarize_batch, sort_points_by_pillar,
)

pytestmark = pytest.mark.cuda

CFG = tconfig.tiny_config()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cloud(rng, ns, cfg=CFG, f=4, margin=2.0):
    pts = np.full((len(ns), cfg.max_points, f), 1e6, dtype=np.float32)
    for i, n in enumerate(ns):
        pts[i, :n, 0] = rng.uniform(cfg.x_min - margin, cfg.x_max + margin, n)
        pts[i, :n, 1] = rng.uniform(cfg.y_min - margin, cfg.y_max + margin, n)
        pts[i, :n, 2] = rng.uniform(cfg.z_min - 0.5, cfg.z_max + 0.5, n)
        pts[i, :n, 3:] = rng.uniform(0, 1, (n, f - 3))
    return pts, np.asarray(ns, np.int32)


def _one_cell(rng, n_dense=2500):
    """One cell holding more points than two kernel chunks."""
    pts, ns = _cloud(rng, [n_dense, 1200])
    pts[0, :n_dense, 0] = 3.2 + rng.uniform(0, 0.2, n_dense)
    pts[0, :n_dense, 1] = -1.4 + rng.uniform(0, 0.2, n_dense)
    return pts, ns


CASES = {
    "random": (CFG, lambda rng: _cloud(rng, [3000, 4096, 1, 0])),
    "one_cell": (CFG, _one_cell),
    "budget": (tconfig.tiny_config(max_pillars=64),
               lambda rng: _cloud(rng, [4096, 4096])),
    "empty": (CFG, lambda rng: _cloud(rng, [0, 0])),
    "multisweep_f5": (
        tconfig.multisweep_config(num_sweeps=3, max_points=4096,
                                  max_pillars=2000, max_points_per_pillar=16),
        lambda rng: _cloud(rng, [3500, 900], cfg=tconfig.multisweep_config(
            max_points=4096), f=5, margin=-60.0)),
}


def _sorted_centered(case, dev):
    cfg, make = CASES[case]
    pts, ns = make(np.random.default_rng(0))
    gid, p = sort_points_by_pillar(torch.from_numpy(pts).to(dev),
                                   torch.from_numpy(ns).to(dev), cfg)
    return cfg, gid, fused_pfn.center_points(gid, p, cfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emit_kernel_bit_equal(dev, case):
    cfg, gid, pts = _sorted_centered(case, dev)
    args = (gid, pts, cfg.max_points_per_pillar, cfg.max_pillars,
            cfg.grid_h * cfg.grid_w)
    before = _build.LAUNCHES["emit"]
    table, meta = emit.emit_table(*args)
    assert _build.LAUNCHES["emit"] == before + 1
    want_t, want_m = emit.emit_table_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(table, want_t)
    assert torch.equal(meta, want_m)
    cpu_t, cpu_m = emit.emit_table(gid.cpu(), pts.cpu(), *args[2:])
    assert torch.equal(table.cpu(), cpu_t) and torch.equal(meta.cpu(), cpu_m)


@pytest.mark.parametrize("case", ["random", "one_cell", "multisweep_f5"])
def test_fused_pfn_kernel_matches_plain(dev, case):
    cfg, gid, pts = _sorted_centered(case, dev)
    table, meta = emit.emit_table(gid, pts, cfg.max_points_per_pillar,
                                  cfg.max_pillars, cfg.grid_h * cfg.grid_w)
    rng = np.random.default_rng(1)
    D, C = cfg.num_decorated_features, cfg.pfn_channels
    w = torch.from_numpy((rng.normal(size=(D, C)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32))
    w_eff, w_dec = fused_pfn.fold_decoration(w.to(dev), b.to(dev), cfg)
    got, pid, cnt = fused_pfn.pfn_from_table(table, meta, w_eff, w_dec, cfg)
    want, want_pid, want_cnt = fused_pfn.pfn_from_table_plain(
        table, meta, w_eff, w_dec, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(pid, want_pid) and torch.equal(cnt, want_cnt)


def test_scatter_kernel_bit_equal(dev):
    cfg, gid, pts = _sorted_centered("random", dev)
    table, meta = emit.emit_table(gid, pts, cfg.max_points_per_pillar,
                                  cfg.max_pillars, cfg.grid_h * cfg.grid_w)
    cnt = meta.reshape(-1, 8, cfg.max_pillars)[:, 0]
    pid = meta.reshape(-1, 8, cfg.max_pillars)[:, 1].to(torch.int32)
    feats = torch.randn((cnt.shape[0], cfg.max_pillars, 64), device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    mask = cnt > 0
    got = bev.scatter_to_bev(feats, pid, mask, cfg)
    want = bev.scatter_to_bev_plain(feats, pid, mask, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _boxes(rng, batch, n, span):
    b = np.zeros((batch, n, 7), dtype=np.float32)
    b[..., 0:2] = rng.uniform(-span, span, (batch, n, 2))
    b[..., 2] = rng.uniform(-1, 1, (batch, n))
    b[..., 3] = rng.uniform(0.5, 3.0, (batch, n))
    b[..., 4] = rng.uniform(0.5, 6.0, (batch, n))
    b[..., 5] = rng.uniform(0.5, 3.0, (batch, n))
    b[..., 6] = rng.uniform(-np.pi, np.pi, (batch, n))
    return b


@pytest.mark.parametrize("k", [128, 200, 1024])
def test_overlap_kernel_matches_plain(dev, k):
    boxes = torch.from_numpy(_boxes(np.random.default_rng(k), 3, k,
                                    span=8.0 + k / 64)).to(dev)
    got = nms_overlap.overlap_matrix(boxes, 0.2)
    want = nms_overlap.overlap_matrix_plain(boxes, 0.2)
    torch.cuda.synchronize()
    assert want.any()
    bad = (got != want).nonzero().cpu()
    if len(bad):
        # the referee: the plain IoU of each disagreeing pair, in float64,
        # must sit at the threshold
        b, j, i = bad.unbind(1)
        pair = iou.rotated_iou_bev(boxes[b, j].double().cpu(),
                                   boxes[b, i].double().cpu()).diagonal()
        assert (pair - 0.2).abs().max() < 1e-4


def test_wrappers_refuse_wrong_inputs(dev):
    gid = torch.zeros((1, 8), dtype=torch.int64, device=dev)
    pts = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(TypeError):
        emit.emit_table(gid, pts, 4, 4, 16)
    with pytest.raises(ValueError):
        nms_overlap.overlap_matrix(torch.zeros((4, 7), device=dev), 0.2)
    feats = torch.zeros((5, 4, 9), device=dev)
    mask = torch.ones((5, 4), dtype=torch.bool, device=dev)
    w, b = torch.zeros((9, 8), device=dev), torch.zeros(8, device=dev)
    with pytest.raises(TypeError):
        pfn.pfn_fused(feats, mask.float(), w, b)
    with pytest.raises(ValueError):
        pfn.pfn_fused(feats, mask, w[:8], b)
    with pytest.raises(ValueError):
        pfn.pfn_fused(feats, mask, w.cpu(), b.cpu())
    with pytest.raises(TypeError):
        sort.bitonic_sort(gid)
    with pytest.raises(ValueError):
        sort.bitonic_sort(gid.int(), pts[:, :4])
    for bits in (0, 33):
        with pytest.raises(ValueError):
            sort.bitonic_sort(gid.int(), key_bits=bits)
    with pytest.raises(TypeError):
        binning.rank_and_hist(gid, gid, 8, 128)
    with pytest.raises(ValueError):
        binning.rank_and_hist(gid.int(), gid.int().cpu(), 8, 128)
    pid = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        bev.scatter_to_bev_emit(pts, pid, pid, CFG)
    with pytest.raises(ValueError):
        bev.scatter_to_bev_emit(pts, pid[:, :4], pid.bool(), CFG)


def _classic_batch(case, dev):
    cfg, make = CASES[case]
    pts, ns = make(np.random.default_rng(0))
    return cfg, emit.pillarize_batch_emit(torch.from_numpy(pts).to(dev),
                                          torch.from_numpy(ns).to(dev), cfg)


@pytest.mark.parametrize("case", ["random", "one_cell", "multisweep_f5"])
def test_pfn_kernel_matches_plain(dev, case):
    _, batch = _classic_batch(case, dev)
    B, P, N, D = batch.features.shape
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.normal(size=(D, 64)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    args = (batch.features.reshape(B * P, N, D), batch.mask.reshape(B * P, N),
            w.to(dev), b.to(dev))
    before = _build.LAUNCHES["pfn"]
    got = pfn.pfn_fused(*args)
    assert _build.LAUNCHES["pfn"] == before + 1
    want = pfn.pfn_fused_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[~batch.pillar_mask.reshape(-1)].any()


def test_pfn_kernel_skips_masked_rows(dev):
    """A mask with holes, and NaN in every masked slot: the kernel uses no
    masked row, so it still agrees with the plain version."""
    rng = np.random.default_rng(3)
    P, N, D, C = 1003, 32, 9, 64
    mask = rng.uniform(size=(P, N)) < 0.3
    mask[:17] = False
    feats = rng.normal(size=(P, N, D)).astype(np.float32)
    feats[~mask] = np.nan
    w = (rng.normal(size=(D, C)) * 0.3).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (feats, mask, w, b)]
    got = pfn.pfn_fused(*args)
    want = pfn.pfn_fused_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[:17].any()


@pytest.mark.parametrize("m", [1, 1536, 4096, 20000])
def test_bitonic_kernel_bit_equal(dev, m):
    """K10's radix kernel (csrc/radix_sort.cu) on 32-bit keys: negatives,
    INT32_MIN and INT32_MAX, and all-equal keys; M = 20,000 leaves a
    ragged last tile, M = 1 a tile of one key."""
    rng = np.random.default_rng(m)
    key = torch.from_numpy(rng.integers(-5, 50, (3, m)).astype(np.int32))
    key[0, :3] = 2**31 - 1
    key[1, -1] = -2**31
    key[2] = 7
    pay = torch.from_numpy(rng.normal(size=(3, m, 4)).astype(np.float32))
    key, pay = key.to(dev), pay.to(dev)
    before = _build.LAUNCHES["radix_sort"]
    got = sort.bitonic_sort(key, pay)
    assert _build.LAUNCHES["radix_sort"] == before + 1
    want = sort.bitonic_sort_plain(key, pay)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ref_k, ref_o = torch.sort(key, dim=1, stable=True)
    assert torch.equal(got[0], ref_k) and torch.equal(got[1].long(), ref_o)
    k2, o2, p2 = sort.bitonic_sort(key)
    assert p2 is None and torch.equal(k2, got[0]) and torch.equal(o2, got[1])


@pytest.mark.parametrize("b, m, key_bits", [
    (1, 5000, 18), (8, 131072, 18), (3, 20000, 1), (3, 20000, 9),
    (3, 20000, 10), (3, 20000, 27), (3, 20000, 32)])
def test_radix_kernel_key_bits(dev, b, m, key_bits):
    """Keys in [0, 2^key_bits), a third of them the largest value (the
    pillar sort's invalid sentinel), through 1, 2, 3 and 4 digit passes;
    F = 5 takes the payload's scalar route. Against the stable torch.sort
    and, below 2^17 keys, the plain network."""
    rng = np.random.default_rng(key_bits)
    hi = 2**key_bits - 1
    key = rng.integers(0, min(hi, 160_000) + 1, (b, m)).astype(np.int64)
    key[rng.uniform(size=(b, m)) < 1 / 3] = min(hi, 160_000)
    key = torch.from_numpy(key.astype(np.int32)).to(dev)
    for f in (4, 5):
        pay = torch.randn((b, m, f), device=dev,
                          generator=torch.Generator(dev).manual_seed(f))
        got = sort.bitonic_sort(key, pay, key_bits=key_bits)
        ref_k, ref_o = torch.sort(key, dim=1, stable=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref_k)
        assert torch.equal(got[1].long(), ref_o)
        assert torch.equal(got[2], torch.gather(
            pay, 1, ref_o[..., None].expand(-1, -1, f)))
        if m < 2**17:
            want = sort.bitonic_sort_plain(key, pay)
            assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("case", ["random", "one_cell", "budget", "empty"])
def test_binning_kernel_bit_equal(dev, case):
    cfg, make = CASES[case]
    pts, ns = make(np.random.default_rng(0))
    pts, ns = torch.from_numpy(pts).to(dev), torch.from_numpy(ns).to(dev)
    rows, cols = binning.cell_rows_cols(pts, ns, cfg)
    w_pad = binning.padded_width(cfg)
    before = _build.LAUNCHES["binning"]
    got = binning.rank_and_hist(rows, cols, cfg.grid_h, w_pad)
    assert _build.LAUNCHES["binning"] == before + 1
    want = binning.rank_and_hist_plain(rows, cols, cfg.grid_h, w_pad)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "one_cell":
        assert (want[0] == 64).any()
    got_b = binning.pillarize_batch_binned(pts, ns, cfg)
    want_b = pillarize_batch(pts, ns, cfg)
    for name in want_b._fields:
        assert torch.equal(getattr(got_b, name), getattr(want_b, name)), name


@pytest.mark.parametrize("case", ["random", "budget", "dense", "full_tile",
                                  "empty"])
def test_bev_gather_kernel_bit_equal(dev, case):
    """K9 against its plain version and K3; its sidecar's tile ranges
    against their plain version. "full_tile": sample 0 fills every cell of
    one tile and then holds cell HW - 1, sample 1 holds only HW - 1."""
    if case == "dense":
        cfg = CFG
        pid = torch.arange(cfg.max_pillars, dtype=torch.int32,
                           device=dev).expand(2, -1).contiguous()
        mask = torch.ones_like(pid, dtype=torch.bool)
    elif case == "full_tile":
        cfg = CFG
        hw, tile = cfg.grid_h * cfg.grid_w, bev.GATHER_TILE_CELLS
        pid = torch.zeros((2, tile + 9), dtype=torch.int32)
        mask = torch.zeros_like(pid, dtype=torch.bool)
        pid[0, :tile + 1] = torch.cat([torch.arange(5 * tile, 6 * tile),
                                       torch.tensor([hw - 1])])
        mask[0, :tile + 1] = True
        pid[1, 0] = hw - 1
        mask[1, 0] = True
        pid, mask = pid.to(dev), mask.to(dev)
    else:
        cfg, batch = _classic_batch(case, dev)
        pid = (batch.coords[..., 0] * cfg.grid_w
               + batch.coords[..., 1]).to(torch.int32)
        mask = batch.pillar_mask
    hw = cfg.grid_h * cfg.grid_w
    assert torch.equal(bev.block_row_ranges(pid, mask, hw),
                       bev.block_row_ranges_plain(pid, mask, hw))
    gen = torch.Generator(dev).manual_seed(2)
    for c in (64, 30):                      # 16-byte and scalar stores
        feats = torch.randn(pid.shape + (c,), device=dev, generator=gen)
        before = _build.LAUNCHES["bev_gather"]
        got = bev.scatter_to_bev_emit(feats, pid, mask, cfg)
        assert _build.LAUNCHES["bev_gather"] == before + 1
        want = bev.scatter_to_bev_emit_plain(feats, pid, mask, cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, bev.scatter_to_bev(feats, pid, mask, cfg))


def _random_state_dict(cfg, seed):
    """Random serving weights for PointPillars(cfg), drawn with numpy."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in PointPillars(cfg).state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            x = np.abs(rng.normal(1.0, 0.1, shape)) + 0.1
        elif name.endswith(".weight") and len(shape) == 1:
            x = rng.normal(1.0, 0.1, shape)
        elif len(shape) >= 2:
            fan_in = (shape[0] if name.startswith(("pfn", "head"))
                      else int(np.prod(shape[1:])))
            x = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        else:
            x = rng.normal(0.0, 0.1, shape)
        sd[name] = torch.from_numpy(x.astype(np.float32))
    return sd


def test_detector_on_card_matches_cpu(dev):
    sd = _random_state_dict(CFG, 5)
    pts, ns = _cloud(np.random.default_rng(2), [3000, 1500])
    _build.reset_launches()
    got = Detector(CFG, sd).predict_packed_batch(pts, ns).cpu().numpy()
    serving = ("emit", "fused_pfn", "bev_scatter", "nms_overlap")
    assert all(_build.LAUNCHES[n] == 1 for n in serving), _build.LAUNCHES
    want = Detector(CFG, sd, device="cpu").predict_packed_batch(
        pts, ns).numpy()
    np.testing.assert_array_equal(got[..., 9], want[..., 9])
    np.testing.assert_array_equal(got[..., 8], want[..., 8])
    np.testing.assert_allclose(got[..., 7], want[..., 7], atol=1e-4)
    np.testing.assert_allclose(got[..., :6], want[..., :6], atol=5e-3)
    dyaw = (got[..., 6] - want[..., 6] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(dyaw).max() < 5e-3


@pytest.mark.parametrize("use_pallas_pfn", [True, False])
def test_classic_detector_on_card_matches_cpu(dev, use_pallas_pfn):
    sd = _random_state_dict(CFG, 5)
    pts, ns = _cloud(np.random.default_rng(2), [3000, 1500])
    kw = dict(fused_frontend=False, use_pallas_pfn=use_pallas_pfn)
    _build.reset_launches()
    got = Detector(CFG, sd, **kw).predict_packed_batch(pts, ns).cpu().numpy()
    assert _build.LAUNCHES["pfn"] == int(use_pallas_pfn)
    assert _build.LAUNCHES["fused_pfn"] == 0
    assert all(_build.LAUNCHES[n] == 1
               for n in ("emit", "bev_scatter", "nms_overlap"))
    want = Detector(CFG, sd, device="cpu", **kw).predict_packed_batch(
        pts, ns).numpy()
    np.testing.assert_array_equal(got[..., 9], want[..., 9])
    np.testing.assert_array_equal(got[..., 8], want[..., 8])
    np.testing.assert_allclose(got[..., 7], want[..., 7], atol=1e-4)
    np.testing.assert_allclose(got[..., :6], want[..., :6], atol=5e-3)


def test_scatter_backward_bit_equal(dev):
    cfg, gid, pts = _sorted_centered("random", dev)
    table, meta = emit.emit_table(gid, pts, cfg.max_points_per_pillar,
                                  cfg.max_pillars, cfg.grid_h * cfg.grid_w)
    m = meta.reshape(-1, 8, cfg.max_pillars)
    pid, mask = m[:, 1].to(torch.int32), m[:, 0] > 0
    gen = torch.Generator(dev).manual_seed(1)
    feats = torch.randn((pid.shape[0], cfg.max_pillars, 64), device=dev,
                        generator=gen)
    cot = torch.randn((pid.shape[0], cfg.grid_h, cfg.grid_w, 64), device=dev,
                      generator=gen)
    f1 = feats.clone().requires_grad_(True)
    f2 = feats.clone().requires_grad_(True)
    before = _build.LAUNCHES["bev_scatter"]
    bev.scatter_to_bev_diff(f1, pid, mask, cfg).backward(cot)
    assert _build.LAUNCHES["bev_scatter"] == before + 1
    bev.scatter_to_bev_plain(f2, pid, mask, cfg).backward(cot)
    torch.cuda.synchronize()
    assert torch.equal(f1.grad, f2.grad)


def _gt_scene(rng, b, g, cfg=CFG, crowd=False):
    gt = np.zeros((b, g, 7), np.float32)
    cls = rng.integers(0, cfg.num_classes, (b, g))
    valid = rng.random((b, g)) < 0.8
    for i in range(b):
        for j in range(g):
            spec = cfg.classes[cls[i, j]]
            x, y = (rng.uniform(-3, 3, 2) if crowd else
                    (rng.uniform(cfg.x_min, cfg.x_max),
                     rng.uniform(cfg.y_min, cfg.y_max)))
            gt[i, j] = [x, y, spec.z_center,
                        spec.width * rng.uniform(0.8, 1.25),
                        spec.length * rng.uniform(0.8, 1.25), spec.height,
                        rng.uniform(-np.pi, np.pi)]
    if crowd:
        cls[:] = 0
        valid[:] = True
    return gt, cls, valid


@pytest.mark.parametrize("crowd", [False, True])
def test_assign_kernel_matches_plain(dev, crowd):
    gt, cls, valid = _gt_scene(np.random.default_rng(int(crowd)), 3, 40,
                               crowd=crowd)
    gt_c, gv_c = group_gt_by_class(torch.from_numpy(gt).to(dev),
                                   torch.from_numpy(cls).to(dev),
                                   torch.from_numpy(valid).to(dev),
                                   CFG.num_classes, 16)
    before = _build.LAUNCHES["assign"]
    got = assign.windowed_best_iou(gt_c, gv_c, CFG)
    assert _build.LAUNCHES["assign"] == before + 1
    want = assign.windowed_best_iou_plain(gt_c, gv_c, CFG)
    torch.cuda.synchronize()
    best, best_gt, gval, ganc = (x.cpu() for x in got)
    wbest, wbest_gt, wgval, wganc = (x.cpu() for x in want)
    torch.testing.assert_close(best, wbest, atol=2e-5, rtol=0)
    torch.testing.assert_close(gval, wgval, atol=2e-5, rtol=0)
    iou = torch.stack([assign.class_iou_plain(gt_c[b], gv_c[b], CFG).cpu()
                       for b in range(gt_c.shape[0])])    # (B, C, Gc, Ac)
    top2 = iou.topk(2, dim=2).values
    clear = (wbest > 0) & (top2[:, :, 0] - top2[:, :, 1] > 2e-5)
    assert torch.equal(best_gt[clear], wbest_gt[clear])
    # a GT's best anchor: the plain one, or one whose IoU ties it
    picked = torch.gather(iou, 3, ganc[..., None])[..., 0]
    claim = gv_c.cpu() & (wgval > 0)
    assert ((picked - wgval).abs()[claim] <= 2e-5).all()
    assert (ganc[~gv_c.cpu()] == 0).all() and (gval[~gv_c.cpu()] == -1).all()


def test_train_steps_on_card_match_cpu(dev):
    from tpu_pillars_torch.data.synthetic import (
        make_scene, scenes_to_train_batch,
    )
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import batch_to_device, make_train_step

    rng = np.random.default_rng(3)
    scenes = [make_scene(rng, CFG, num_objects=6, points_per_object=60,
                         clutter=400) for _ in range(2)]
    arrays = scenes_to_train_batch(scenes, CFG, 16)
    tcfg = TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    sd = _random_state_dict(CFG, 6)
    out = {}
    for where in ("cuda", "cpu"):
        state = create_train_state(CFG, tcfg, device=where, state_dict=sd)
        step = make_train_step(CFG)
        _build.reset_launches()
        out[where] = [step(state, batch_to_device(arrays, where))[1]
                      for _ in range(2)]
        if where == "cuda":
            for name in ("emit", "bev_scatter", "assign"):
                assert _build.LAUNCHES[name] == 2, _build.LAUNCHES
    for a, b in zip(out["cuda"], out["cpu"]):
        assert int(a.num_pos) == int(b.num_pos) > 0
        np.testing.assert_allclose(float(a.total), float(b.total), rtol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_kernel_matches_plain_and_fused(dev, case):
    cfg, gid, pts = _sorted_centered(case, dev)
    rng = np.random.default_rng(1)
    D, C = cfg.num_decorated_features, cfg.pfn_channels
    w = torch.from_numpy((rng.normal(size=(D, C)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32))
    w_eff, w_dec = fused_pfn.fold_decoration(w.to(dev), b.to(dev), cfg)
    before = _build.LAUNCHES["stream_pfn"]
    got = stream_pfn.stream_canvas_from_sorted(gid, pts, w_eff, w_dec, cfg)
    assert _build.LAUNCHES["stream_pfn"] == before + 1
    want = stream_pfn.stream_canvas_from_sorted_plain(gid, pts, w_eff,
                                                      w_dec, cfg)
    table, meta = emit.emit_table(gid, pts, cfg.max_points_per_pillar,
                                  cfg.max_pillars, cfg.grid_h * cfg.grid_w)
    feats, pid, cnt = fused_pfn.pfn_from_table(table, meta, w_eff, w_dec,
                                               cfg)
    fused = bev.scatter_to_bev(feats, pid, cnt > 0, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    occ = got.ne(0).any(-1)
    assert torch.equal(occ, want.ne(0).any(-1))
    assert torch.equal(occ, fused.ne(0).any(-1))
    torch.testing.assert_close(got, fused, atol=1e-4, rtol=1e-5)
    if case == "empty":
        assert not got.any()


@pytest.mark.parametrize("n,m,bi,bj", [(45, 19, 32, 16), (300, 200, 256, 64),
                                       (1024, 1024, 128, 128)])
def test_iou_tiled_kernel_matches_plain(dev, n, m, bi, bj):
    rng = np.random.default_rng(n)
    b1 = torch.from_numpy(_boxes(rng, 2, n, span=8.0)).to(dev)
    b2 = torch.from_numpy(_boxes(rng, 2, m, span=8.0)).to(dev)
    before = _build.LAUNCHES["iou_tiled"]
    got = iou_tiled.rotated_iou_bev_tiled(b1, b2, bi, bj)
    assert _build.LAUNCHES["iou_tiled"] == before + 1
    want = iou_tiled.rotated_iou_bev_tiled_plain(b1, b2, bi, bj)
    one = iou_tiled.rotated_iou_bev_tiled(b1[1], b2[1], bi, bj)
    dense = iou.rotated_iou_bev(b1[1], b2[1])
    torch.cuda.synchronize()
    assert got.shape == (2, n, m)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(one, got[1])
    torch.testing.assert_close(one, dense, atol=1e-3, rtol=0)
    assert (want > 0).any()


def test_iou_tiled_wrapper_refuses_wrong_inputs(dev):
    boxes = torch.zeros((300, 7), device=dev)
    with pytest.raises(ValueError):
        iou_tiled.rotated_iou_bev_tiled(boxes, boxes, 512, 128)
    with pytest.raises(TypeError):
        iou_tiled.rotated_iou_bev_tiled(boxes.double(), boxes.double())
    with pytest.raises(TypeError):
        stream_pfn.stream_canvas_from_sorted(
            torch.zeros((1, 8), dtype=torch.int64, device=dev),
            torch.zeros((1, 8, 4), device=dev), torch.zeros((4, 8),
                                                            device=dev),
            torch.zeros((8, 8), device=dev), CFG)
