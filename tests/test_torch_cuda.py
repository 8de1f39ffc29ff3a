"""tpu_pillars_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor the
JAX package, so it also runs on a machine that has neither:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

K1 emit and K3 scatter are held bit for bit, K3's backward too (K1 also on
the run cases of tests/emit_run_cases.py and a full-config batch with more
runs than the pillar budget, into memory that held NaN); K2 fused PFN bit
for bit, its ids and counts too, into memory that held NaN (also at F = 3,
4, 5, C = 32, 48, 64, 256, counts of 0, 1 and N interleaved and NaN in
every slot past a count); K6 PFN to atol 1e-5, rtol 1e-5 (both sides round
the same f32 operations in the same order; the kernels are built without
fused multiply-adds); K10 radix sort, K8 binning and K9 block gather bit
for bit (K10 also against the stable torch.sort, K9 against K3; K8 also on
full-config cells with a 1,500-point cell in each sample, a sample whose
131,072 points share one cell, M = 5,001, rows and cols out of range on
both sides and a 2,048 x 2,048 grid); K2 refuses F = 9 and K8 a scratch
one word short, and both raise; K11 stream
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
1e-3, equal positives). K3, K4 and K11 also write every element of memory
that held NaN / 0xFF before the call; K11 keeps exactly the runs of its
pillar budget (tests/stream_budget_cases.py, and a full-config batch); K5
is also held on a GT far from every anchor, GT on its tiles' edges and 64
GT per class, with every case that no positive IoU decides exact; K6 is
also held at C = 96 and 256, D = 1, N = 16 and 40, a ragged pillar count,
more pillars than the grid has warps and a pillar whose only valid slot is
the last, into memory that held NaN; K1, K2, K5, K6, K8 and K11 launch
once per call; with two cards, every kernel launches on
``cuda:1`` while ``cuda:0`` is current."""

import numpy as np
import pytest
import torch

import emit_run_cases
import stream_budget_cases
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


def _poison_all(specs, dev):
    """``_poison`` for the outputs and scratch of one wrapper call, given as
    (shape, dtype, value) in the order the wrapper allocates them: all
    filled at once, then all freed, so that the call's allocations get the
    same blocks back. Returns their addresses."""
    junk = [torch.full(shape, value, dtype=dtype, device=dev)
            for shape, dtype, value in specs]
    ptrs = [t.data_ptr() for t in junk]
    del junk
    return ptrs


def _emit_inputs(case, dev):
    """(cfg, gid, pts) on the card: a CASES cloud sorted and centred, the
    run cases (F = 4 or 5) at the tiny config, or two uniform sweeps of
    100,000 points at the full config (more runs than the budget)."""
    if case in CASES:
        return _sorted_centered(case, dev)
    if case.startswith("run_cases"):
        gid, pts, _ = emit_run_cases.run_batch(
            CFG, f=5 if case.endswith("f5") else 4,
            chunk=emit.EMIT_CHUNK_ROWS)
        return CFG, torch.from_numpy(gid).to(dev), torch.from_numpy(pts).to(
            dev)
    cfg, _, (gid, pts, _, _) = _stream_full_inputs(dev)
    return cfg, gid, pts


@pytest.mark.parametrize("case", sorted(CASES) + [
    "run_cases", "run_cases_f5", "full_config"])
def test_emit_kernel_bit_equal(dev, case):
    """K1, one launch a call, into memory that held NaN (table and meta;
    the scratch held 7s): bit-equal to its plain version and to the CPU
    path."""
    cfg, gid, pts = _emit_inputs(case, dev)
    B, M, F = pts.shape
    N, P, HW = cfg.max_points_per_pillar, cfg.max_pillars, \
        cfg.grid_h * cfg.grid_w
    args = (gid, pts, N, P, HW)
    n_chunk = -(-M // emit.EMIT_CHUNK_ROWS)
    nan = float("nan")
    ptrs = _poison_all([((B * P, N * F), torch.float32, nan),
                        ((B * 8, P), torch.float32, nan),
                        ((B * (n_chunk + P + 2),), torch.int32, 7)], dev)
    before = _build.LAUNCHES["emit"]
    table, meta = emit.emit_table(*args)
    assert _build.LAUNCHES["emit"] == before + 1
    assert [table.data_ptr(), meta.data_ptr()] == ptrs[:2]
    want_t, want_m = emit.emit_table_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(table, want_t)
    assert torch.equal(meta, want_m)
    cpu_t, cpu_m = emit.emit_table(gid.cpu(), pts.cpu(), *args[2:])
    assert torch.equal(table.cpu(), cpu_t) and torch.equal(meta.cpu(), cpu_m)
    if case == "full_config":  # every sample has more runs than the budget
        runs = ((gid[:, 1:] != gid[:, :-1]) & (gid[:, 1:] < HW)).sum(1) + 1
        assert (runs > P).all()
        assert (meta.reshape(B, 8, P)[:, 0] > 0).all()


def _fused_pfn_check(dev, cfg, table, meta, w_eff, w_dec):
    """K2 into memory that held NaN (features, ids, counts), one launch:
    bit-equal to its plain version."""
    B, P = meta.shape[0] // 8, meta.shape[1]
    C = w_eff.shape[1]
    nan = float("nan")
    ptrs = _poison_all([((B, P, C), torch.float32, nan),
                        ((B, P), torch.int32, -7),
                        ((B, P), torch.float32, nan)], dev)
    before = _build.LAUNCHES["fused_pfn"]
    got = fused_pfn.pfn_from_table(table, meta, w_eff, w_dec, cfg)
    assert _build.LAUNCHES["fused_pfn"] == before + 1
    assert [t.data_ptr() for t in got] == ptrs
    want = fused_pfn.pfn_from_table_plain(table, meta, w_eff, w_dec, cfg)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    return got


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
    _fused_pfn_check(dev, cfg, table, meta, w_eff, w_dec)


def _fused_pfn_table(rng, cfg, b, p, f, c):
    """A (b * p, N * f) table and (b * 8, p) meta whose counts run 0, 1, N
    and random values in turn, NaN in every slot at or past a pillar's
    count, ids anywhere on the grid, and folded weights (f, c), (8, c)."""
    n, hw = cfg.max_points_per_pillar, cfg.grid_h * cfg.grid_w
    cnt = rng.integers(1, n + 1, (b, p)).astype(np.float32)
    cnt.reshape(-1)[0::4] = 0
    cnt.reshape(-1)[1::4] = 1
    cnt.reshape(-1)[2::4] = n
    table = rng.normal(size=(b * p, n, f)).astype(np.float32) * 2.0
    table[np.arange(n)[None, :] >= cnt.reshape(-1, 1)] = np.nan
    meta = np.zeros((b, 8, p), np.float32)
    meta[:, 0] = cnt
    meta[:, 1] = rng.integers(0, hw, (b, p))
    meta[:, 2:5] = rng.normal(size=(b, 3, p)) * cnt[:, None]
    w_eff = (rng.normal(size=(f, c)) * 0.3).astype(np.float32)
    w_dec = rng.normal(size=(8, c)).astype(np.float32)
    w_dec[6:] = 0.0
    return [torch.from_numpy(a) for a in (table.reshape(b * p, n * f),
                                          meta.reshape(b * 8, p), w_eff,
                                          w_dec)]


# (F, C, N, pillars per sample): F = 3, 4, 5; C = 32, 64 and 48 (lanes with
# no channel, scalar stores) and 256; a pillar count that is no multiple of
# a warp's 32
FUSED_PFN_SHAPES = {
    "f3_c32": (3, 32, 32, 1000),
    "f4_c64": (4, 64, 32, 1003),
    "f5_c48": (5, 48, 16, 997),
    "f4_c256_n20": (4, 256, 20, 301),
}


@pytest.mark.parametrize("case", sorted(FUSED_PFN_SHAPES))
def test_fused_pfn_kernel_shapes_nan_tails(dev, case):
    """Counts of 0, 1 and N interleaved, NaN past every count (never read:
    the output is finite and bit-equal to the plain version, which masks
    those slots), into memory that held NaN."""
    f, c, n, p = FUSED_PFN_SHAPES[case]
    cfg = tconfig.tiny_config(max_points_per_pillar=n)
    args = [t.to(dev) for t in _fused_pfn_table(np.random.default_rng(f),
                                                cfg, 3, p, f, c)]
    feats, pid, cnt = _fused_pfn_check(dev, cfg, *args)
    assert torch.isfinite(feats).all()
    assert not feats[cnt == 0].any()
    assert (cnt == 0).any() and (cnt == n).any() and (cnt == 1).any()


def test_fused_pfn_entry_refuses_nine_features(dev):
    """F = 9 passes the wrapper's checks and is refused by the C entry, so
    the wrapper raises and counts no launch."""
    cfg = tconfig.tiny_config(max_points_per_pillar=8)
    args = [t.to(dev) for t in _fused_pfn_table(np.random.default_rng(9),
                                                cfg, 1, 64, 9, 32)]
    before = _build.LAUNCHES["fused_pfn"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_pfn.pfn_from_table(*args, cfg)
    assert _build.LAUNCHES["fused_pfn"] == before


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


def _poison(shape, dtype, value, dev):
    """Fill a block of ``shape`` and free it, so that the caching allocator
    hands the same memory to the next allocation of that size: an element
    the kernel leaves unwritten then reads ``value``."""
    junk = torch.full(shape, value, dtype=dtype, device=dev)
    del junk


def _ascending_ids(rng, b, p, hw, tile):
    """(b, p) int32 ids and bool mask, the effective ids ascending, junk in
    the masked rows: sample 1 holds no valid pillar; every other sample a
    full tile of consecutive cells (tile 5), cell hw - 1, and a random set
    of other cells whose count varies with the sample."""
    pid = rng.integers(-5, hw + 5, (b, p)).astype(np.int32)
    mask = np.zeros((b, p), bool)
    for s in range(b):
        if s == 1:
            continue
        rand = rng.choice(hw - 1, size=rng.integers(1, p - tile - 1),
                          replace=False)
        ids = np.unique(np.concatenate([rand, np.arange(5 * tile, 6 * tile),
                                        [hw - 1]]))[:p]
        pid[s, :len(ids)] = ids
        mask[s, :len(ids)] = True
    return pid, mask


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("c", [64, 30])             # 16-byte, scalar stores
def test_scatter_kernel_writes_every_element(dev, b, c):
    """K3 into memory that held NaN, one launch per call: bit-equal to its
    plain version, to K9 and to ``index_copy_`` into zeros, on samples with
    no pillar, a full tile of consecutive cells, cell HW - 1 and random
    ids (junk ids in the masked rows)."""
    cfg = CFG
    hw = cfg.grid_h * cfg.grid_w
    # 64: the cells of one K3 block (kTileCells in csrc/bev_scatter.cu)
    pid, mask = _ascending_ids(np.random.default_rng(b * 100 + c), b,
                               cfg.max_pillars, hw, 64)
    pid, mask = torch.from_numpy(pid).to(dev), torch.from_numpy(mask).to(dev)
    feats = torch.randn((b, cfg.max_pillars, c), device=dev,
                        generator=torch.Generator(dev).manual_seed(c))
    shape = (b, cfg.grid_h, cfg.grid_w, c)
    _poison(shape, torch.float32, float("nan"), dev)
    before = _build.LAUNCHES["bev_scatter"]
    got = bev.scatter_to_bev(feats, pid, mask, cfg)
    assert _build.LAUNCHES["bev_scatter"] == before + 1
    want = bev.scatter_to_bev_plain(feats, pid, mask, cfg)
    flat = (pid.long() + torch.arange(b, device=dev)[:, None] * hw)[mask]
    lib = torch.zeros((b * hw, c), device=dev).index_copy_(0, flat,
                                                           feats[mask])
    torch.cuda.synchronize()
    assert got.shape == shape and not got.isnan().any()
    assert torch.equal(got, want)
    assert torch.equal(got, lib.reshape(shape))
    assert torch.equal(got, bev.scatter_to_bev_emit(feats, pid, mask, cfg))
    if b > 1:
        assert not got[1].any()
    assert torch.equal(got.reshape(b, hw, c)[0, hw - 1],
                       feats[0, int(mask[0].sum()) - 1])


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


@pytest.mark.parametrize("b, k, layout", [
    (1, 1, "random"), (8, 17, "random"), (1, 1000, "random"),
    (8, 1024, "random"), (8, 1024, "far"), (1, 1000, "piled"),
    (8, 1024, "piled")])
def test_overlap_kernel_writes_every_byte(dev, b, k, layout):
    """K4 into memory that held 0xFF, one launch per call: every byte 0 or
    1, the diagonal and the lower triangle 0, and equal to the plain version
    except pairs whose IoU lies within 1e-4 of the threshold. "far": no two
    boxes within reach of each other (no pair passes the gate); "piled":
    every box on one spot (every pair passes it)."""
    rng = np.random.default_rng(k + b)
    boxes = _boxes(rng, b, k, span=8.0 + k / 64)
    if layout == "far":
        grid = np.arange(k)
        boxes[..., 0] = 20.0 * (grid % 64)
        boxes[..., 1] = 20.0 * (grid // 64)
    elif layout == "piled":
        boxes[..., 0:2] = rng.uniform(-0.01, 0.01, (b, k, 2))
    boxes = torch.from_numpy(boxes).to(dev)
    _poison((b, k, k), torch.uint8, 255, dev)
    before = _build.LAUNCHES["nms_overlap"]
    got = nms_overlap.overlap_matrix(boxes, 0.2)
    assert _build.LAUNCHES["nms_overlap"] == before + 1
    want = nms_overlap.overlap_matrix_plain(boxes, 0.2)
    torch.cuda.synchronize()
    assert got.shape == (b, k, k) and got.dtype == torch.bool
    assert (got.view(torch.uint8) <= 1).all()
    assert not got.tril().any()
    pay = nms_overlap.payloads(boxes)
    d = pay[:, :, None, 8:10] - pay[:, None, :, 8:10]
    rr = pay[:, :, None, 11] + pay[:, None, :, 11]
    gate = (d * d).sum(-1) - rr * rr <= 0.0
    if layout == "far":
        assert not gate.triu(1).any() and not want.any()
    if layout == "piled":
        assert gate.all() and (k == 1 or want.any())
    bad = (got != want).nonzero().cpu()
    if len(bad):
        b_, j, i = bad.unbind(1)
        pair = iou.rotated_iou_bev(boxes[b_, j].double().cpu(),
                                   boxes[b_, i].double().cpu()).diagonal()
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
    _poison((B * P, 64), torch.float32, float("nan"), dev)
    before = _build.LAUNCHES["pfn"]
    got = pfn.pfn_fused(*args)
    assert _build.LAUNCHES["pfn"] == before + 1
    want = pfn.pfn_fused_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[~batch.pillar_mask.reshape(-1)].any()


def _pfn_holes(rng, P, N, D, C):
    """A mask with holes (pillars 0-16 empty, pillar 17 valid only in its
    last slot), NaN in every masked slot, and weights."""
    mask = rng.uniform(size=(P, N)) < 0.3
    mask[:17] = False
    mask[17] = False
    mask[17, N - 1] = True
    feats = rng.normal(size=(P, N, D)).astype(np.float32)
    feats[~mask] = np.nan
    w = (rng.normal(size=(D, C)) * 0.3).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    return feats, mask, w, b


def _pfn_check(dev, arrays):
    """K6 into memory that held NaN, one launch: finite, within atol /
    rtol 1e-5 of its plain version, 0 for the pillars with no valid slot."""
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    P, C = arrays[0].shape[0], arrays[2].shape[1]
    (ptr,) = _poison_all([((P, C), torch.float32, float("nan"))], dev)
    before = _build.LAUNCHES["pfn"]
    got = pfn.pfn_fused(*args)
    assert _build.LAUNCHES["pfn"] == before + 1
    assert got.data_ptr() == ptr
    want = pfn.pfn_fused_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[:17].any()
    assert got[17].any()  # its last slot alone sets it


def test_pfn_kernel_skips_masked_rows(dev):
    """A mask with holes, and NaN in every masked slot: the kernel uses no
    masked row, so it still agrees with the plain version."""
    _pfn_check(dev, _pfn_holes(np.random.default_rng(3), 1003, 32, 9, 64))


# (P, N, D, C): a pillar count that is no multiple of a block's warps, more
# pillars than the grid has warps (each warp takes several, its loads ahead
# of its arithmetic), C = 96 and 256, D = 1, N = 16 and N = 40 (> 32)
PFN_SHAPES = {
    "ragged": (301, 32, 9, 64),
    "many_pillars": (40_003, 32, 9, 64),
    "c96": (1003, 32, 9, 96),
    "c256": (1003, 32, 9, 256),
    "d1": (1003, 32, 1, 64),
    "n16_d10": (2001, 16, 10, 64),
    "n40": (503, 40, 9, 64),
}


@pytest.mark.parametrize("case", sorted(PFN_SHAPES))
def test_pfn_kernel_shapes_into_poisoned_memory(dev, case):
    _pfn_check(dev, _pfn_holes(np.random.default_rng(4), *PFN_SHAPES[case]))


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


def _binning_check(rows, cols, h_bins, w_pad):
    """K8 into memory that held junk, one launch: rank and histogram
    bit-equal to the plain version."""
    B, M = rows.shape
    ptrs = _poison_all([((B, M), torch.int32, -5),
                        ((B, h_bins, w_pad), torch.float32, float("nan"))],
                       rows.device)
    before = _build.LAUNCHES["binning"]
    got = binning.rank_and_hist(rows, cols, h_bins, w_pad)
    assert _build.LAUNCHES["binning"] == before + 1
    assert [t.data_ptr() for t in got] == ptrs
    want = binning.rank_and_hist_plain(rows, cols, h_bins, w_pad)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return want


@pytest.mark.parametrize("case", ["random", "one_cell", "budget", "empty"])
def test_binning_kernel_bit_equal(dev, case):
    cfg, make = CASES[case]
    pts, ns = make(np.random.default_rng(0))
    pts, ns = torch.from_numpy(pts).to(dev), torch.from_numpy(ns).to(dev)
    rows, cols = binning.cell_rows_cols(pts, ns, cfg)
    want = _binning_check(rows, cols, cfg.grid_h, binning.padded_width(cfg))
    if case == "one_cell":
        assert (want[0] == 64).any()
    got_b = binning.pillarize_batch_binned(pts, ns, cfg)
    want_b = pillarize_batch(pts, ns, cfg)
    for name in want_b._fields:
        assert torch.equal(getattr(got_b, name), getattr(want_b, name)), name


def _full_dense(rng):
    """Full-config cells for 4 x 131,072 points, a sixth of them invalid;
    in each sample one cell holds 1,500 points scattered through it."""
    cfg = tconfig.PillarsConfig()
    b, m = 4, cfg.max_points
    rows = rng.integers(0, cfg.grid_h, (b, m))
    cols = rng.integers(0, cfg.grid_w, (b, m))
    for i in range(b):
        at = rng.choice(m, 1500, replace=False)
        rows[i, at], cols[i, at] = 150 + i, 201
    rows[rng.uniform(size=(b, m)) < 1 / 6] = cfg.grid_h
    return rows, cols, cfg.grid_h, binning.padded_width(cfg)


def _all_one_cell(rng):
    """Sample 0: all 131,072 points in one cell; sample 1 uniform."""
    cfg = tconfig.PillarsConfig()
    m = cfg.max_points
    rows = rng.integers(0, cfg.grid_h, (2, m))
    cols = rng.integers(0, cfg.grid_w, (2, m))
    rows[0], cols[0] = 123, 45
    return rows, cols, cfg.grid_h, binning.padded_width(cfg)


def _ragged(rng):
    """M = 5,001 (no multiple of a 1,024-point tile) on 40 x 128 cells, a
    few cells far past 64 points."""
    rows = np.minimum(rng.geometric(0.2, (3, 5001)) - 1, 39)
    cols = np.minimum(rng.geometric(0.3, (3, 5001)) - 1, 127)
    return rows, cols, 40, 128


def _out_of_range(rng):
    """Rows and cols out of range on both sides, negative ones included."""
    rows = rng.integers(-5, 13, (2, 4096))
    cols = rng.integers(-5, 133, (2, 4096))
    rows[:, :300] = rng.integers(-2**31, 0, 300)
    cols[:, 300:600] = rng.integers(128, 2**31 - 1, 300)
    return rows, cols, 8, 128


def _large_grid(rng):
    """2,048 x 2,048 cells (4,096 bands: more than 48 KB of shared memory a
    block) and a cell of 300 points."""
    rows = rng.integers(0, 2048, (2, 8192))
    cols = rng.integers(0, 2048, (2, 8192))
    rows[:, 100:400], cols[:, 100:400] = 1000, 77
    return rows, cols, 2048, 2048


BINNING_CASES = {"full_dense": _full_dense, "all_one_cell": _all_one_cell,
                 "ragged_m": _ragged, "out_of_range": _out_of_range,
                 "large_grid": _large_grid}


@pytest.mark.parametrize("case", sorted(BINNING_CASES))
def test_binning_kernel_cells_bit_equal(dev, case):
    rows, cols, h_bins, w_pad = BINNING_CASES[case](
        np.random.default_rng(7))
    rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
    cols = torch.from_numpy(cols.astype(np.int32)).to(dev)
    rank, hist = _binning_check(rows, cols, h_bins, w_pad)
    if case in ("full_dense", "all_one_cell", "ragged_m", "large_grid"):
        assert (rank == 64).any() and hist.max() == 64.0
    if case == "full_dense":
        assert (hist == 64).sum() >= 4
    if case == "out_of_range":
        valid = (rows >= 0) & (rows < h_bins) & (cols >= 0) & (cols < w_pad)
        assert (~valid).any() and not rank[~valid].any()


def test_binning_entry_refuses_small_scratch(dev):
    """The C entry checks its scratch size: one word short is refused, so
    the launch raises and counts nothing; the wrapper refuses a grid of
    more than 2^24 cells a sample, which the kernel does not take."""
    rows = torch.zeros((2, 3000), dtype=torch.int32, device=dev)
    rank = torch.empty_like(rows)
    hist = torch.empty((2, 8, 128), device=dev)
    words = binning.scratch_words(2, 3000, 8, 128)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["binning"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("binning", "rank_and_hist", "pppppiiiii", rows, rows,
                      rank, hist, scratch, words - 1, 2, 3000, 8, 128)
    assert _build.LAUNCHES["binning"] == before
    _build.launch("binning", "rank_and_hist", "pppppiiiii", rows, rows,
                  rank, hist, scratch, words, 2, 3000, 8, 128)
    torch.cuda.synchronize()
    assert torch.equal(rank, binning.rank_and_hist_plain(rows, rows, 8,
                                                         128)[0])
    with pytest.raises(ValueError, match="at most"):
        binning.rank_and_hist(rows, rows, 4097, 4096)
    assert _build.LAUNCHES["binning"] == before + 1


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


def _one_call_per_kernel(dev):
    """Every kernel's wrapper once, on inputs made from seeds on ``dev``:
    {kernel: its output tensors}."""
    cfg, gid, pts = _sorted_centered("random", dev)
    hw = cfg.grid_h * cfg.grid_w
    rng = np.random.default_rng(1)
    D, C = cfg.num_decorated_features, cfg.pfn_channels
    w = torch.from_numpy((rng.normal(size=(D, C)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32))
    w, b = w.to(dev), b.to(dev)
    w_eff, w_dec = fused_pfn.fold_decoration(w, b, cfg)
    out = {}
    table, meta = emit.emit_table(gid, pts, cfg.max_points_per_pillar,
                                  cfg.max_pillars, hw)
    out["emit"] = (table, meta)
    feats, pid, cnt = fused_pfn.pfn_from_table(table, meta, w_eff, w_dec,
                                               cfg)
    out["fused_pfn"] = (feats,)
    out["bev_scatter"] = (bev.scatter_to_bev(feats, pid, cnt > 0, cfg),)
    out["bev_gather"] = (bev.scatter_to_bev_emit(feats, pid, cnt > 0, cfg),)
    out["stream_pfn"] = (stream_pfn.stream_canvas_from_sorted(
        gid, pts, w_eff, w_dec, cfg),)
    boxes = torch.from_numpy(_boxes(np.random.default_rng(2), 2, 100,
                                    8.0)).to(dev)
    out["nms_overlap"] = (nms_overlap.overlap_matrix(boxes, 0.2),)
    out["iou_tiled"] = (iou_tiled.rotated_iou_bev_tiled(boxes, boxes),)
    pts_raw, ns = _cloud(np.random.default_rng(3), [3000, 1000])
    pts_raw, ns = torch.from_numpy(pts_raw).to(dev), torch.from_numpy(ns).to(
        dev)
    batch = emit.pillarize_batch_emit(pts_raw, ns, cfg)
    B, P, N, _ = batch.features.shape
    out["pfn"] = (pfn.pfn_fused(batch.features.reshape(B * P, N, D),
                                batch.mask.reshape(B * P, N), w, b),)
    key = torch.from_numpy(rng.integers(0, 5000, (3, 3000)).astype(
        np.int32)).to(dev)
    out["radix_sort"] = sort.bitonic_sort(key)[:2]
    rows, cols = binning.cell_rows_cols(pts_raw, ns, cfg)
    out["binning"] = binning.rank_and_hist(rows, cols, cfg.grid_h,
                                           binning.padded_width(cfg))
    gt, cls, valid = _gt_scene(np.random.default_rng(0), 2, 20)
    gt_c, gv_c = group_gt_by_class(torch.from_numpy(gt).to(dev),
                                   torch.from_numpy(cls).to(dev),
                                   torch.from_numpy(valid).to(dev),
                                   cfg.num_classes, 16)
    out["assign"] = assign.windowed_best_iou(gt_c, gv_c, cfg)
    return out


def test_kernels_launch_on_their_inputs_device(dev):
    """Every kernel on ``cuda:1`` while ``cuda:0`` is the current device:
    each launches on its inputs' card (``_build.launch``) and gives what it
    gives on ``cuda:0``, and the current device stays ``cuda:0``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: launches on cuda:1")
    torch.cuda.set_device(0)
    _build.reset_launches()
    want = _one_call_per_kernel(torch.device("cuda:0"))
    got = _one_call_per_kernel(torch.device("cuda:1"))
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert torch.cuda.current_device() == 0
    assert sorted(got) == sorted(_build.KERNELS)
    assert all(_build.LAUNCHES[n] == 2 for n in _build.KERNELS), \
        _build.LAUNCHES
    for name in _build.KERNELS:
        for a, b in zip(got[name], want[name]):
            assert a.device == torch.device("cuda:1"), name
            assert torch.equal(a.cpu(), b.cpu()), name


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


def _gt_far(rng):
    """A random scene plus, in every sample, a valid GT of class 0 500 m
    beyond the grid: it passes no gate, so it reads (0, 0)."""
    gt, cls, valid = _gt_scene(rng, 3, 40)
    gt[:, 0] = [CFG.x_max + 500, 0.0, -1.0, 1.9, 4.7, 1.7, 0.4]
    cls[:, 0], valid[:, 0] = 0, True
    return gt, cls, valid


def _gt_tile_edges(rng):
    """GT of every class centred on the corners and edges of K5's tiles
    (every 16 anchor columns of 2 yaws and 8 feature rows, 1 m apart at
    the tiny config), jittered by 1 mm, at any yaw."""
    stride = CFG.voxel_x * CFG.head_stride
    xs = CFG.x_min + stride * np.arange(0, CFG.feature_w + 1, 16)
    ys = CFG.y_min + stride * np.arange(0, CFG.feature_h + 1, 8)
    pts = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    n = len(pts)
    gt, cls, valid = _gt_scene(rng, 2, n)
    gt[:, :, :2] = pts + rng.uniform(-1e-3, 1e-3, (2, n, 2))
    valid[:] = True
    return gt, cls, valid


def _gt_full_slots(rng):
    """64 GT of class 0 per sample around a few spots: Gc = 64, the
    kernel's limit (4 samples to a block)."""
    gt, cls, valid = _gt_scene(rng, 2, 64, crowd=True)
    gt[:, 32:, :2] += 6.0
    return gt, cls, valid


ASSIGN_CASES = {
    "random": (lambda rng: _gt_scene(rng, 3, 40), 16),
    "crowd": (lambda rng: _gt_scene(rng, 3, 40, crowd=True), 16),
    "far": (_gt_far, 16),
    "tile_edges": (_gt_tile_edges, 16),
    "gc64": (_gt_full_slots, 64),
}


@pytest.mark.parametrize("case", sorted(ASSIGN_CASES))
def test_assign_kernel_matches_plain(dev, case):
    """K5, one launch a call, against its plain version: IoUs within 2e-5,
    the best GT equal wherever the best is positive and clear, each GT's
    anchor the plain one or one tied within 2e-5, and every case where no
    positive IoU decides exact (best -1 / 0 and its slot, a GT's (-1, 0)
    or (0, 0))."""
    make, gc = ASSIGN_CASES[case]
    gt, cls, valid = make(np.random.default_rng(sorted(ASSIGN_CASES).index(
        case)))
    gt_c, gv_c = group_gt_by_class(torch.from_numpy(gt).to(dev),
                                   torch.from_numpy(cls).to(dev),
                                   torch.from_numpy(valid).to(dev),
                                   CFG.num_classes, gc)
    before = _build.LAUNCHES["assign"]
    got = assign.windowed_best_iou(gt_c, gv_c, CFG)
    assert _build.LAUNCHES["assign"] == before + 1
    want = assign.windowed_best_iou_plain(gt_c, gv_c, CFG)
    torch.cuda.synchronize()
    best, best_gt, gval, ganc = (x.cpu() for x in got)
    wbest, wbest_gt, wgval, wganc = (x.cpu() for x in want)
    assert best_gt.dtype == ganc.dtype == torch.int64
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
    # no positive IoU: exact
    zero = wbest <= 0
    assert torch.equal(best[zero], wbest[zero])
    assert torch.equal(best_gt[zero], wbest_gt[zero])
    assert (ganc[~claim] == 0).all() and torch.equal(gval[~claim],
                                                     wgval[~claim])
    assert (gval[~gv_c.cpu()] == -1).all()
    if case == "far":
        assert (gval[:, 0, 0] == 0).all() and gv_c[:, 0, 0].all()


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
    _poison((gid.shape[0], cfg.grid_h, cfg.grid_w, C), torch.float32,
            float("nan"), dev)
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


def _stream_budget_inputs(dev):
    """tests/stream_budget_cases.py's batch at the tiny config with N = 32
    (fewer than P runs, exactly P, a cut inside a tile, an empty sample, a
    run at cell H*W - 1, runs of exactly 32 and of 45 points)."""
    cfg = tconfig.tiny_config(max_points_per_pillar=32)
    gid, runs = stream_budget_cases.budget_batch(cfg)
    pts, w_eff, w_dec = stream_budget_cases.budget_inputs(cfg, gid.shape)
    return cfg, runs, [torch.from_numpy(x).to(dev)
                       for x in (gid, pts, w_eff, w_dec)]


def _stream_full_inputs(dev):
    """Two uniform sweeps of 100,000 points at the full config: more runs
    than the budget of 12,000, 64 channels, sorted and centred."""
    cfg = tconfig.PillarsConfig()
    pts, ns = _cloud(np.random.default_rng(5), [100_000, 100_000], cfg=cfg)
    gid, p = sort_points_by_pillar(torch.from_numpy(pts).to(dev),
                                   torch.from_numpy(ns).to(dev), cfg)
    rng = np.random.default_rng(6)
    D, C = cfg.num_decorated_features, cfg.pfn_channels
    w = torch.from_numpy((rng.normal(size=(D, C)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32))
    w_eff, w_dec = fused_pfn.fold_decoration(w.to(dev), b.to(dev), cfg)
    return cfg, None, [gid, fused_pfn.center_points(gid, p, cfg), w_eff,
                       w_dec]


@pytest.mark.parametrize("case", ["budget_cases", "full_config"])
def test_stream_kernel_budget_into_poisoned_memory(dev, case):
    """K11, one launch a call, into memory that held NaN: within atol /
    rtol 1e-5 of its plain version with the occupancy equal cell for cell;
    on the budget cases the occupied cells are exactly the runs at or
    below the P-th run's id, and the plain cutoff is the kernel's rule."""
    make = _stream_budget_inputs if case == "budget_cases" else \
        _stream_full_inputs
    cfg, runs, (gid, pts, w_eff, w_dec) = make(dev)
    B, HW, C = gid.shape[0], cfg.grid_h * cfg.grid_w, w_eff.shape[1]
    _poison((B, cfg.grid_h, cfg.grid_w, C), torch.float32, float("nan"), dev)
    before = _build.LAUNCHES["stream_pfn"]
    got = stream_pfn.stream_canvas_from_sorted(gid, pts, w_eff, w_dec, cfg)
    assert _build.LAUNCHES["stream_pfn"] == before + 1
    want = stream_pfn.stream_canvas_from_sorted_plain(gid, pts, w_eff,
                                                      w_dec, cfg)
    cut = stream_pfn.stream_budget_cutoff_plain(gid, cfg).cpu()
    torch.cuda.synchronize()
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    occ = got.ne(0).any(-1).reshape(B, HW).cpu()
    assert torch.equal(occ, want.ne(0).any(-1).reshape(B, HW).cpu())
    cells = torch.arange(HW)
    assert not (occ & (cells[None] > cut[:, None])).any()
    if runs is None:     # the budget cut: exactly P runs at or below it
        g = gid.cpu()
        starts = (g < HW) & torch.cat([torch.ones(B, 1, dtype=torch.bool),
                                       g[:, 1:] != g[:, :-1]], 1)
        assert (starts.sum(1) > cfg.max_pillars).all()
        assert ((starts & (g <= cut[:, None])).sum(1)
                == cfg.max_pillars).all()
        return
    for s, run_cells in enumerate(runs):
        want_cut = stream_budget_cases.expected_cutoff(run_cells, cfg)
        assert int(cut[s]) == want_cut
        expect = torch.zeros(HW, dtype=torch.bool)
        expect[torch.from_numpy(run_cells[run_cells <= want_cut])] = True
        assert torch.equal(occ[s], expect), stream_budget_cases.CASES[s]


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
