"""How tpu_pillars_torch launches its kernels, checked on the CPU.

* The device guard: every wrapper of the kernels in ``_build.KERNELS``
  (K1-K11, the NMS keep ``nms_scan``, and K9's sidecar) launches through
  ``_build.launch``, which
  enters ``torch.cuda.device`` of its input's device and passes that
  device's current stream. The card is stood in for by the ``meta`` device,
  a fake ``torch.cuda.device`` and ``current_stream``, and a fake kernel
  library that records where each entry point was called: any device but
  the CPU takes the kernel's path, so the wrappers run to their launches
  without a card. ``tests/test_torch_cuda.py`` launches on ``cuda:1``
  where a machine has two cards. K3's bf16 instances launch their own
  entry points and count under their own names. K1, K2, K5, K6, K7, K8,
  K11 and the NMS keep, one launch each and no other torch op than their
  ``torch.empty`` allocations (a dispatch mode records every op), return
  their documented outputs there; K7 passes views of other layouts to its
  kernel as they are, with their strides. The wrappers of K1, K2, K3, K4
  and K6 (and the NMS keep) are thin calls of their ``tpu_pillars``
  ops, whose fake (``meta``) implementation launches nothing: for those
  the launch checks call the op's CUDA implementation, and one more test
  checks that each such wrapper dispatches its op and nothing else. The
  NMS keep passes a global scratch exactly when a row's packed bits
  outgrow a block's shared memory, and its counters ``nms.scan_rows`` and
  ``nms.loop_rows`` count the rows by the path that served them.
* K3's precondition: the ids that each caller of the BEV scatter passes
  (the fused and the classic serving front end, a training step) satisfy
  ``where(mask, pid, H*W)`` ascending, valid ids unique and in [0, H*W),
  the contract of ``scatter_to_bev`` (and of the reference's
  ``scatter_to_bev_ring``) that its kernel relies on.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_pillars.config import tiny_config as jax_tiny_config
from torch_port_util import cloud_batch, random_variables
from tpu_pillars_torch import _build
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import detector as tdet
from tpu_pillars_torch.ops import (
    assign, bev, binning, emit, fused_pfn, iou_tiled, nms, nms_overlap, pfn,
    sort, stream_pfn,
)
from tpu_pillars_torch.train.loop import synthetic_batches
from tpu_pillars_torch.train.state import TrainConfig, create_train_state
from tpu_pillars_torch.train.step import batch_to_device, make_train_step
from tpu_pillars_torch.utils import profiling
from tpu_pillars_torch.weights import params_from_flax

CFG = tconfig.tiny_config()
META = torch.device("meta")


class _FakeCard:
    """``torch.cuda.device`` and ``current_stream`` stand-ins, and a kernel
    library whose entry points record (kernel, symbol, current device,
    stream argument) and return success."""

    def __init__(self):
        self.current = []
        self.calls = []
        self.args = []

    def device(self, device):
        card = self

        class Guard:
            def __enter__(self):
                card.current.append(torch.device(device))

            def __exit__(self, *exc):
                card.current.pop()

        return Guard()

    @staticmethod
    def stream_of(device):
        return 1000 + len(str(torch.device(device)))

    def current_stream(self, device):
        return type("Stream", (), {"cuda_stream": self.stream_of(device)})()

    def library(self, kernel):
        card = self

        class Entry:
            argtypes = None

            def __init__(self, symbol):
                self.symbol = symbol

            def __call__(self, *args):
                if self.symbol == "radix_sort_scratch_bytes":
                    return 0                    # a host query, no launch
                where = card.current[-1] if card.current else None
                card.calls.append((kernel, self.symbol, where, args[-1]))
                card.args.append(args)
                return 0

        class Lib:
            def __getattr__(self, symbol):
                entry = Entry(symbol)
                setattr(self, symbol, entry)
                return entry

        return Lib()


@pytest.fixture
def card(monkeypatch):
    fake = _FakeCard()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(_build, "library", fake.library)
    # the shared memory a block may opt into on an H100
    monkeypatch.setattr(nms, "_smem_bytes", lambda index: 232448)
    return fake


def _m(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


B, P, C, HW = 2, 16, 8, CFG.grid_h * CFG.grid_w
A_C = CFG.feature_h * CFG.feature_w * len(CFG.anchor_yaws)  # K5's anchors

# each kernel's wrapper on meta inputs of the shapes it takes
# (for the kernels behind a ``tpu_pillars`` op: its CUDA implementation)
CALLS = {
    "emit": lambda: emit.emit_table_cuda(_m((B, 64), torch.int32),
                                         _m((B, 64, 4)), 4, P, HW),
    "fused_pfn": lambda: fused_pfn.pfn_from_table_cuda(
        _m((B * P, CFG.max_points_per_pillar * 4)), _m((B * 8, P)),
        _m((4, C)), _m((8, C)), *fused_pfn.geometry(CFG)),
    "bev_scatter": lambda: bev.scatter_to_bev_cuda(
        _m((B, P, C)), _m((B, P), torch.int32), _m((B, P), torch.bool),
        CFG.grid_h, CFG.grid_w, torch.float32),
    "nms_overlap": lambda: nms_overlap.overlap_matrix_cuda(_m((B, 40, 7)),
                                                           0.2),
    "assign": lambda: assign.windowed_best_iou(
        _m((B, CFG.num_classes, 4, 7)),
        _m((B, CFG.num_classes, 4), torch.bool), CFG),
    "pfn": lambda: pfn.pfn_fused_cuda(_m((P, 4, 9)), _m((P, 4), torch.bool),
                                      _m((9, C)), _m((C,))),
    "radix_sort": lambda: sort.bitonic_sort(_m((B, 64), torch.int32),
                                            _m((B, 64, 4))),
    "binning": lambda: binning.rank_and_hist(
        _m((B, 64), torch.int32), _m((B, 64), torch.int32), CFG.grid_h,
        binning.padded_width(CFG)),
    "bev_gather": lambda: bev.scatter_to_bev_emit(
        _m((B, P, C)), _m((B, P), torch.int32), _m((B, P), torch.bool), CFG),
    "stream_pfn": lambda: stream_pfn.stream_canvas_from_sorted(
        _m((B, 64), torch.int32), _m((B, 64, 4)), _m((4, C)), _m((8, C)),
        CFG),
    "iou_tiled": lambda: iou_tiled.rotated_iou_bev_tiled(_m((B, 40, 7)),
                                                         _m((B, 30, 7))),
    "nms_scan": lambda: nms.nms_scan_cuda(_m((B, 40, 40), torch.bool),
                                          _m((B, 40), torch.bool)),
}
# entry points each wrapper launches, the counted one last
SYMBOLS = {"bev_gather": ["bev_row_ranges", "bev_gather"]}


def test_every_kernel_has_a_guarded_call():
    assert sorted(CALLS) == sorted(_build.KERNELS)


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_wrapper_launches_under_its_inputs_device(card, kernel):
    before = dict(_build.LAUNCHES)
    CALLS[kernel]()
    assert card.calls, f"{kernel}: the wrapper launched nothing"
    assert all(k == kernel for k, *_ in card.calls), card.calls
    if kernel in SYMBOLS:
        assert [s for _, s, _, _ in card.calls] == SYMBOLS[kernel]
    else:
        assert len(card.calls) == 1
    for _, symbol, where, stream in card.calls:
        assert where == META, f"{symbol} launched under {where}"
        assert stream == _FakeCard.stream_of(META), symbol
    # one count per call, for the kernel alone (a sidecar adds none)
    after = dict(_build.LAUNCHES)
    assert after[kernel] == before[kernel] + 1
    assert {k: v for k, v in after.items() if k != kernel} == \
        {k: v for k, v in before.items() if k != kernel}
    assert not card.current


@pytest.mark.parametrize("rows,symbol", [
    (torch.float32, "bev_scatter_f32_bf16"),
    (torch.bfloat16, "bev_scatter_bf16")])
def test_scatter_bf16_instances_launch_under_their_inputs_device(
        card, rows, symbol):
    """K3's bf16 canvases: one guarded launch of the instance's own entry
    point, counted under its own name and no other, returning a bf16
    canvas."""
    before = dict(_build.LAUNCHES)
    out = bev.scatter_to_bev_cuda(
        _m((B, P, C), rows), _m((B, P), torch.int32), _m((B, P), torch.bool),
        CFG.grid_h, CFG.grid_w, torch.bfloat16)
    assert [c[:3] for c in card.calls] == [("bev_scatter", symbol, META)]
    assert card.calls[0][3] == _FakeCard.stream_of(META)
    after = dict(_build.LAUNCHES)
    assert after[symbol] == before[symbol] + 1
    assert {k: v for k, v in after.items() if k != symbol} == \
        {k: v for k, v in before.items() if k != symbol}
    assert out.dtype == torch.bfloat16
    assert tuple(out.shape) == (B, CFG.grid_h, CFG.grid_w, C)


# the outputs each one-launch wrapper documents: (shape, dtype) per output
OUTPUTS = {
    "emit": [((B * P, 4 * 4), torch.float32), ((B * 8, P), torch.float32)],
    "fused_pfn": [((B, P, C), torch.float32), ((B, P), torch.int32),
                  ((B, P), torch.float32)],
    "binning": [((B, 64), torch.int32),
                ((B, CFG.grid_h, binning.padded_width(CFG)), torch.float32)],
    "pfn": [((P, C), torch.float32)],
    "assign": [((B, CFG.num_classes, A_C), torch.float32),
               ((B, CFG.num_classes, A_C), torch.int64),
               ((B, CFG.num_classes, 4), torch.float32),
               ((B, CFG.num_classes, 4), torch.int64)],
    "stream_pfn": [((B, CFG.grid_h, CFG.grid_w, C), torch.float32)],
    "iou_tiled": [((B, 40, 30), torch.float32)],
    "nms_scan": [((B, 40), torch.bool)],
}


@pytest.mark.parametrize("kernel", sorted(OUTPUTS))
def test_one_launch_wrappers_return_their_outputs(card, kernel):
    """K1, K2, K5, K6, K7, K8, K11 and the NMS keep (``nms_fixpoint``'s
    CUDA implementation, ``nms_scan``) make one guarded call and run no
    other torch op than their allocations, so on ``meta`` they return their
    documented outputs (K1's table and meta, K2's features, int32 ids and
    f32 counts, K5's best_gt and gt_best_anchor int64, K7's IoU, K8's rank
    and histogram, the bool keep mask)."""
    out = CALLS[kernel]()
    out = out if isinstance(out, tuple) else (out,)
    assert len(card.calls) == 1
    assert [(tuple(t.shape), t.dtype) for t in out] == OUTPUTS[kernel]
    assert all(t.device == META for t in out)


class _Ops(TorchDispatchMode):
    """Records the name of every torch op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kernel", sorted(OUTPUTS))
def test_one_launch_wrappers_run_no_other_torch_op(card, kernel):
    """Past a first call (K5 caches its constants on the device), a call
    of a one-launch wrapper dispatches no torch op but ``empty``: its
    inputs' allocations and its outputs' and scratch's."""
    CALLS[kernel]()
    with _Ops() as ops:
        CALLS[kernel]()
    assert set(ops.names) == {"aten.empty.memory_format"}, ops.names
    assert len(card.calls) == 2


# the wrappers that are thin calls of a ``tpu_pillars`` op: (wrapper, its
# meta inputs)
OP_WRAPPERS = {
    "emit_table": (emit.emit_table, lambda: (
        _m((B, 64), torch.int32), _m((B, 64, 4)), 4, P, HW)),
    "pfn_from_table": (fused_pfn.pfn_from_table, lambda: (
        _m((B * P, CFG.max_points_per_pillar * 4)), _m((B * 8, P)),
        _m((4, C)), _m((8, C)), CFG)),
    "scatter_to_bev": (bev.scatter_to_bev, lambda: (
        _m((B, P, C)), _m((B, P), torch.int32), _m((B, P), torch.bool),
        CFG)),
    "overlap_matrix": (nms_overlap.overlap_matrix, lambda: (
        _m((B, 40, 7)), 0.2)),
    "pfn_fused": (pfn.pfn_fused, lambda: (
        _m((P, 4, 9)), _m((P, 4), torch.bool), _m((9, C)), _m((C,)))),
    "nms_fixpoint": (nms.nms_fixpoint, lambda: (
        _m((B, 40, 40), torch.bool), _m((B, 40), torch.bool))),
}


@pytest.mark.parametrize("op", sorted(OP_WRAPPERS))
def test_op_wrappers_dispatch_their_op_alone(card, op):
    """Each such wrapper dispatches its ``tpu_pillars`` op and no other
    torch op (an exported graph records that op); on ``meta`` the op's fake
    runs, which launches nothing."""
    wrapper, inputs = OP_WRAPPERS[op]
    args = inputs()
    with _Ops() as ops:
        wrapper(*args)
    assert ops.names == [f"tpu_pillars.{op}.default"], ops.names
    assert not card.calls


# K7's inputs in layouts other than contiguous (B, n, 7): (boxes1, boxes2)
IOU_VIEWS = {
    "slices of wider rows": lambda: (_m((B, 40, 9))[..., :7],
                                     _m((B, 30, 8))[..., 1:]),
    "two-dimensional": lambda: (_m((40, 7)), _m((30, 7))),
    "fields first": lambda: (_m((B, 7, 40)).transpose(1, 2),
                             _m((7, B, 30)).permute(1, 2, 0)),
}


@pytest.mark.parametrize("layout", sorted(IOU_VIEWS))
def test_iou_tiled_reads_views_without_a_copy(card, layout):
    """K7's kernel reads the boxes through the strides its wrapper passes:
    a view reaches it as it is, and the call dispatches no copy, no view
    and no other op than the output's ``empty``."""
    b1, b2 = IOU_VIEWS[layout]()
    with _Ops() as ops:
        out = iou_tiled.rotated_iou_bev_tiled(b1, b2)
    assert ops.names == ["aten.empty.memory_format"], ops.names
    assert tuple(out.shape) == tuple(b1.shape[:-1]) + (b2.shape[-2],)
    (args,) = card.args
    p1, p2, _, batch, n, m, bi, bj, *strides, _ = args
    lead = () if b1.dim() == 3 else (0,)
    assert tuple(strides) == lead + b1.stride() + lead + b2.stride()
    assert (p1, p2) == (b1.data_ptr(), b2.data_ptr())
    assert (batch, n, m, bi, bj) == (B if b1.dim() == 3 else 1, 40, 30, 40,
                                     30)


@pytest.mark.parametrize("k,scratch", [(40, False), (1350, False),
                                        (1351, True), (2048, True)])
def test_nms_scan_stages_in_global_memory_past_shared(card, k, scratch):
    """The NMS keep packs a row's K * ceil(K / 32) words (and the row's
    suppressed set) in a block's shared memory up to Hopper's 227 KB, and
    past it passes the kernel a (B, K, ceil(K / 32)) int32 scratch; one
    launch either way, with (B, K) last."""
    keep = nms.nms_scan_cuda(_m((B, k, k), torch.bool), _m((B, k),
                                                            torch.bool))
    (args,) = card.args
    assert (args[3] is not None) == scratch
    assert args[4:6] == (B, k)
    assert tuple(keep.shape) == (B, k) and keep.dtype == torch.bool


@pytest.mark.parametrize("over,valid", [
    ((B, 40, 41), (B, 40)), ((B, 40), (B, 40)), ((1, 40, 40), (B, 40)),
    ((B, 40, 40, 1), (B, 40))], ids=["wide", "flat", "short", "deep"])
def test_nms_scan_refuses_wrong_shapes(card, over, valid):
    """The NMS keep refuses an ``over`` that is not (B, K, K) for a
    (B, K) ``valid`` before it launches: its kernel would read out of
    bounds."""
    with pytest.raises(ValueError, match="nms_fixpoint wants"):
        nms.nms_scan_cuda(_m(over, torch.bool), _m(valid, torch.bool))
    assert not card.calls


@pytest.mark.parametrize("dtypes", [(torch.uint8, torch.bool),
                                    (torch.float32, torch.bool),
                                    (torch.bool, torch.uint8)],
                         ids=["uint8 over", "float over", "uint8 valid"])
def test_nms_scan_refuses_other_dtypes(card, dtypes):
    """The NMS keep reads bool bytes: another dtype of ``over`` or
    ``valid`` is refused before the launch."""
    with pytest.raises(ValueError, match="nms_fixpoint wants"):
        nms.nms_scan_cuda(_m((B, 40, 40), dtypes[0]), _m((B, 40), dtypes[1]))
    assert not card.calls


def test_nms_counters_count_the_path_taken(card):
    """``nms.scan_rows`` counts the rows through the card's kernel,
    ``nms.loop_rows`` the rows through the CPU's fixpoint loop, while
    tracing is on and at no other time."""
    over = torch.zeros((3, 8, 8), dtype=torch.bool)
    over[:, 0, 1] = True
    valid = torch.ones((3, 8), dtype=torch.bool)
    profiling.disable()
    profiling.reset()
    try:
        nms.nms_fixpoint(over, valid)
        nms.nms_scan_cuda(_m((2, 8, 8), torch.bool), _m((2, 8), torch.bool))
        assert profiling.summary()["counters"] == {}
        profiling.enable()
        keep = nms.nms_fixpoint(over, valid)
        assert keep[:, 1].logical_not().all() and keep[:, 2:].all()
        assert profiling.summary()["counters"] == {"nms.loop_rows": 3}
        nms.nms_scan_cuda(_m((2, 8, 8), torch.bool), _m((2, 8), torch.bool))
        nms.nms_scan_cuda(_m((5, 8, 8), torch.bool), _m((5, 8), torch.bool))
        assert profiling.summary()["counters"] == {"nms.loop_rows": 3,
                                                  "nms.scan_rows": 7}
        assert len(card.calls) == 3
    finally:
        profiling.disable()
        profiling.reset()


def test_launch_refuses_tensors_on_two_devices(card):
    with pytest.raises(ValueError, match="not on one device"):
        _build.launch("bev_scatter", "bev_scatter", "ppppiiii",
                      _m((1, 2, 4)), torch.zeros((1, 2), dtype=torch.int32),
                      _m((1, 2), torch.bool), _m((1, 4, 4)), 1, 2, 4, 16)
    assert not card.calls


# ---- K3's precondition on every caller -------------------------------------

def _assert_ascending(pid, mask, hw):
    eff = torch.where(mask, pid, hw).long()
    assert mask.any()
    valid = pid[mask]
    assert (valid >= 0).all() and (valid < hw).all()
    step = eff[:, 1:] - eff[:, :-1]
    assert (step >= 0).all(), "effective ids descend"
    assert (step[mask[:, 1:]] > 0).all(), "a valid id repeats"


@pytest.fixture
def recorded_scatters(monkeypatch):
    """Every (pid, mask) that reaches ``scatter_to_bev``, whichever name
    the caller bound."""
    seen = []
    plain = bev.scatter_to_bev

    def recording(feats, pid, mask, config, *out_dtype):
        seen.append((pid.clone(), mask.clone(), config))
        return plain(feats, pid, mask, config, *out_dtype)

    monkeypatch.setattr(bev, "scatter_to_bev", recording)
    monkeypatch.setattr(tdet, "scatter_to_bev", recording)
    return seen


@pytest.mark.parametrize("fused", [True, False])
def test_serving_front_ends_pass_ascending_ids(recorded_scatters, fused):
    sd = params_from_flax(random_variables(jax_tiny_config(), seed=3), CFG)
    det = tdet.Detector(CFG, sd, device="cpu", fused_frontend=fused)
    pts, ns = cloud_batch(np.random.default_rng(4), [3000, 4096, 1, 0], CFG)
    det.predict_packed_batch(pts, ns)
    assert len(recorded_scatters) == 1
    pid, mask, cfg = recorded_scatters[0]
    assert pid.shape == (4, CFG.max_pillars)
    _assert_ascending(pid, mask, cfg.grid_h * cfg.grid_w)


def test_training_step_passes_ascending_ids(recorded_scatters):
    tcfg = TrainConfig(batch_size=2, total_steps=1)
    state = create_train_state(CFG, tcfg, seed=0, device="cpu")
    batch = next(synthetic_batches(CFG, tcfg, seed=5))
    make_train_step(CFG)(state, batch_to_device(batch, "cpu"))
    assert len(recorded_scatters) == 1
    pid, mask, cfg = recorded_scatters[0]
    _assert_ascending(pid, mask, cfg.grid_h * cfg.grid_w)


def test_classic_training_step_passes_ascending_ids(recorded_scatters):
    """The classic step's K3 (``scatter_to_bev_auto`` from the PillarBatch
    coords, masked pillars at zero coords) keeps the contract too."""
    tcfg = TrainConfig(batch_size=2, total_steps=1)
    state = create_train_state(CFG, tcfg, seed=0, device="cpu")
    pts, n, *gt = next(synthetic_batches(CFG, tcfg, seed=5))
    n = np.minimum(n, [400, 50])         # leave pillars unfilled
    make_train_step(CFG, fused_frontend=False)(
        state, batch_to_device((pts, n, *gt), "cpu"))
    assert len(recorded_scatters) == 1
    pid, mask, cfg = recorded_scatters[0]
    assert not mask.all()
    _assert_ascending(pid, mask, cfg.grid_h * cfg.grid_w)
