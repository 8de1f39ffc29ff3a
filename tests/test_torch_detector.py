"""tpu_pillars_torch ``Detector`` — the whole slice — vs the JAX package on
the CPU, and the port's ground rules.

* The port's batch path against the JAX ``Detector`` with the fused front
  end and the Pallas NMS (interpret mode), at the tolerance of
  tests/test_detector_e2e.py::test_jitted_pipeline_matches_cpu_reference.
* The port on the committed trained checkpoint at the full
  ``PillarsConfig()`` against the JAX golden detections
  (tests/data/torch_golden_synth4k.npz, scripts/make_torch_golden.py), at
  the trained-weights tolerance of tests/test_detector_e2e.py.
* The device rule (the card unless the CPU is asked for) and the import
  rule (no JAX, flax, msgpack or tpu_pillars in the port)."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene
from tpu_pillars.detector import Detector as JaxDetector
from torch_port_util import assert_packed_close, random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import detector as tdet
from tpu_pillars_torch.weights import params_from_flax

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth4k.npz")
ARTIFACT = os.path.join(ROOT, "artifacts", "pointpillars_synth4k.msgpack")


def test_whole_slice_matches_jax_fused_pallas(rng):
    cfg, tcfg = tiny_config(), tconfig.tiny_config()
    variables = random_variables(cfg, seed=5)
    jdet = JaxDetector(cfg, variables, fused_frontend=True,
                       nms_impl="pallas")
    tdet_ = tdet.Detector(tcfg, params_from_flax(variables, tcfg),
                          device="cpu")
    clouds = [make_scene(rng, cfg, num_objects=6, clutter=1000).points
              for _ in range(2)]
    padded = [tdet_.pad_points(c) for c in clouds]
    pts = np.stack([p for p, _ in padded])
    ns = np.asarray([n for _, n in padded], np.int32)
    want = np.asarray(jdet.predict_packed_batch(jnp.asarray(pts),
                                                jnp.asarray(ns)))
    got = tdet_.predict_packed_batch(pts, ns).numpy()
    assert got.shape == want.shape == (2, cfg.max_detections, 10)
    total = sum(assert_packed_close(got[b], want[b], 1e-4, 5e-3)
                for b in range(2))
    assert total > 0


def test_pad_points_matches_jax(rng):
    cfg, tcfg = tiny_config(), tconfig.tiny_config()
    variables = random_variables(cfg, seed=5)
    sd = params_from_flax(variables, tcfg)
    cloud = make_scene(rng, cfg, num_objects=4, clutter=600).points
    far = rng.uniform(500, 900, (300, 4)).astype(np.float32)
    cloud = np.concatenate([cloud, far] + [cloud] * 4)   # over the budget
    assert len(cloud) > cfg.max_points + len(far)
    for kw in ({}, {"host_crop": False},
               {"wire_buckets": (1024, cfg.max_points)}):
        jp, jn = JaxDetector(cfg, variables, **kw).pad_points(cloud)
        port = tdet.Detector(tcfg, sd, device="cpu", **kw)
        tp, tn = port.pad_points(cloud)
        np.testing.assert_array_equal(tp, jp)
        assert tn == jn
        assert port.truncation.dropped_points > 0
    small = tdet.Detector(tcfg, sd, device="cpu",
                          wire_buckets=(1024, cfg.max_points))
    assert small.pad_points(cloud[:700])[0].shape == (1024, 4)


def test_predict_returns_boxes(rng):
    cfg, tcfg = tiny_config(), tconfig.tiny_config()
    variables = random_variables(cfg, seed=5)
    port = tdet.Detector(tcfg, params_from_flax(variables, tcfg),
                         device="cpu")
    cloud = make_scene(rng, cfg, num_objects=6, clutter=1000).points
    packed = port.predict_packed(cloud).numpy()
    boxes = port.predict(cloud, token="t0")
    assert len(boxes) == int(packed[:, 9].sum()) > 0
    assert all(b.token == "t0" and b.label in tcfg.class_names
               for b in boxes)
    np.testing.assert_allclose(boxes[0].center, packed[0, :3], atol=1e-6)


def test_golden_trained_checkpoint_cpu():
    """The port on the trained artifact at the full config reproduces the
    JAX package's detections (classic front end, fixpoint NMS)."""
    golden = np.load(GOLDEN)
    cfg = tconfig.PillarsConfig()
    port = tdet.Detector.from_checkpoint(cfg, ARTIFACT, device="cpu")
    offs = golden["offsets"]
    for s in (0, 1):
        got = port.predict_packed(golden["points"][offs[s]:offs[s + 1]])
        n = assert_packed_close(got.numpy(), golden["packed"][s], 1e-3,
                                 1e-2)
        assert n > 0


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    cfg = tconfig.tiny_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdet.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdet.resolve_device("cuda")
    sd = params_from_flax(random_variables(tiny_config(), seed=5), cfg)
    with pytest.raises(RuntimeError):
        tdet.Detector(cfg, sd)
    assert tdet.Detector(cfg, sd, device="cpu").device.type == "cpu"
    from tpu_pillars_torch.reference_cpu.convert import flax_to_torch

    ref_sd = flax_to_torch(random_variables(tiny_config(), seed=5), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdet.Detector.from_torch(cfg, ref_sd)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdet.Detector(cfg, sd, wire_dtype=torch.int16)
    assert tdet.Detector.from_torch(cfg, ref_sd,
                                    device="cpu").device.type == "cpu"


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "tpu_pillars"}


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tpu_pillars_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 15
    rel = {os.path.relpath(f, ROOT) for f in files}
    for module in ("data/synthetic.py", "train/loop.py", "train/step.py",
                   "train/state.py", "train/checkpoint.py", "ops/assign.py",
                   "ops/pfn.py", "ops/sort.py", "ops/binning.py",
                   "ops/stream_pfn.py", "ops/iou_tiled.py",
                   "evaluation/pipeline.py", "evaluation/tta.py",
                   "evaluation/cli.py", "evaluation/map_eval.py",
                   "evaluation/map_eval_alt.py", "train/prefetch.py",
                   "data/lyft.py", "data/fixture.py", "data/submission.py",
                   "reference_cpu/postprocess.py", "train/elastic.py",
                   "train/ema.py", "utils/logging.py",
                   "utils/tensorboard.py", "train/data.py",
                   "data/augment.py", "data/gt_sampler.py",
                   "models/pfn.py", "models/head.py",
                   "ops/target_assigner.py", "ops/postprocess.py",
                   "serve.py", "data/stream.py", "reference_cpu/__init__.py",
                   "reference_cpu/pillarizer.py", "reference_cpu/model.py",
                   "reference_cpu/convert.py", "reference_cpu/pipeline.py"):
        assert os.path.join("tpu_pillars_torch", module) in rel, module
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, f"{path}: {mod}"
