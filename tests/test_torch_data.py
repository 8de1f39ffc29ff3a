"""tpu_pillars_torch's training data path on the CPU: ``data/augment.py``,
``data/gt_sampler.py``, ``train/data.py`` and ``train.loop.main --data``,
at ``tiny_config()``.

* The checks of tests/test_augment.py, tests/test_gt_sampler.py and
  tests/test_train_data.py, run on the port's modules (the one step on a
  dataset batch is the port's step).
* Parity with the JAX package on ``data/fixture.py`` directories and seeded
  scenes, bit for bit: ``augment_scene``, ``noise_per_object`` and
  ``points_in_boxes`` on the same ``default_rng`` seeds,
  ``GTDatabase.from_dataset``, ``class_balanced_tokens``, and the
  ``dataset_batches`` stream with every augmentation on for 0 and 4
  workers, single-sweep and multi-sweep (3 sweeps through the native
  loader and its numpy path).
* ``main --data``: 2 steps with GT sampling, object noise and CBGS log
  finite losses and an mAP on the held-out samples; ``--resume`` continues
  the same stream; ``--cbgs`` without ``--data`` warns and is ignored.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_pillars_torch.config import tiny_config
from tpu_pillars_torch.data.augment import (
    AugmentConfig, ObjectNoiseConfig, augment_scene, noise_per_object,
)
from tpu_pillars_torch.data.fixture import build_fixture
from tpu_pillars_torch.data.gt_sampler import (
    GTDatabase, GTSampleConfig, GTSampler, points_in_box, points_in_boxes,
)
from tpu_pillars_torch.data.lyft import LyftDataset
from tpu_pillars_torch.data.synthetic import make_scene
from tpu_pillars_torch.geometry.boxes import box_corners_bev
from tpu_pillars_torch.ops.losses import LossBreakdown
from tpu_pillars_torch.reference_cpu.postprocess import rotated_iou_bev_np
from tpu_pillars_torch.train import loop
from tpu_pillars_torch.train.data import (
    class_balanced_tokens, dataset_batches, sample_to_arrays,
)

CFG = tiny_config()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("lyft_train_fixture")
    return LyftDataset(build_fixture(str(root), CFG, num_scenes=2,
                                     samples_per_scene=2,
                                     sweeps_per_sample=1))


@pytest.fixture(scope="module")
def big_fixture(tmp_path_factory):
    """6 samples, the default fixture density: the json table dir."""
    root = tmp_path_factory.mktemp("lyft_parity_fixture")
    return build_fixture(str(root), CFG, num_scenes=2, samples_per_scene=3,
                         sweeps_per_sample=1, seed=4)


# ---- augment (tests/test_augment.py) --------------------------------------

def _points_in_box_mask(points, box):
    """BEV membership with a small tolerance + z extent check."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    cx, cy, cz, w, l, h, yaw = box
    dx, dy = x - cx, y - cy
    lx = dx * np.cos(-yaw) - dy * np.sin(-yaw)
    ly = dx * np.sin(-yaw) + dy * np.cos(-yaw)
    return (
        (np.abs(lx) <= l / 2 + 1e-4) & (np.abs(ly) <= w / 2 + 1e-4)
        & (np.abs(z - cz) <= h / 2 + 1e-4)
    )


def test_membership_preserved(rng):
    scene = make_scene(rng, CFG, num_objects=6, points_per_object=150,
                       clutter=500)
    before = [_points_in_box_mask(scene.points, b).sum()
              for b in scene.gt_boxes]
    pts, boxes = augment_scene(rng, scene.points, scene.gt_boxes)
    after = [_points_in_box_mask(pts, b).sum() for b in boxes]
    for nb, na in zip(before, after):
        assert abs(int(nb) - int(na)) <= 2


def test_feature_columns_untouched(rng):
    scene = make_scene(rng, CFG, num_objects=3, clutter=200)
    pts, _ = augment_scene(rng, scene.points, scene.gt_boxes)
    np.testing.assert_array_equal(pts[:, 3], scene.points[:, 3])


def test_yaw_wrapped_and_shapes(rng):
    scene = make_scene(rng, CFG, num_objects=5, clutter=100)
    cfg = AugmentConfig(rotation_range=np.pi)  # stress the wrap
    pts, boxes = augment_scene(rng, scene.points, scene.gt_boxes, cfg)
    assert pts.shape == scene.points.shape
    assert boxes.shape == scene.gt_boxes.shape
    assert np.all(boxes[:, 6] >= -np.pi) and np.all(boxes[:, 6] < np.pi)
    assert not np.shares_memory(pts, scene.points)


def test_flip_only_mirrors(rng):
    scene = make_scene(rng, CFG, num_objects=4, clutter=100)
    cfg = AugmentConfig(flip_y_prob=1.0, rotation_range=0.0,
                        scale_range=(1.0, 1.0), translate_std=0.0)
    pts, boxes = augment_scene(rng, scene.points, scene.gt_boxes, cfg)
    np.testing.assert_allclose(pts[:, 1], -scene.points[:, 1])
    np.testing.assert_allclose(boxes[:, 1], -scene.gt_boxes[:, 1])
    orig = box_corners_bev(scene.gt_boxes)
    flipped = box_corners_bev(boxes)
    mirrored = orig * np.array([1.0, -1.0])
    for g in range(len(boxes)):
        got = set(map(tuple, np.round(flipped[g], 4)))
        want = set(map(tuple, np.round(mirrored[g], 4)))
        assert got == want


class TestNoisePerObject:
    def _scene(self, rng, n_boxes=4):
        s = make_scene(rng, CFG, num_objects=n_boxes, points_per_object=80,
                       clutter=300)
        return s.points, s.gt_boxes

    def test_points_move_with_boxes(self, rng):
        pts, boxes = self._scene(rng)
        before = [int(points_in_box(pts, b).sum()) for b in boxes]
        pts2, boxes2 = noise_per_object(
            rng, pts, boxes, ObjectNoiseConfig(translate_std=0.5))
        # surface points may land epsilon outside after the f32 rotation
        after = [int(points_in_box(pts2, b, margin=1e-3).sum())
                 for b in boxes2]
        for b4, a4 in zip(before, after):
            assert a4 >= b4
        assert not np.allclose(boxes2[:, :2], boxes[:, :2])
        assert pts2.shape == pts.shape
        np.testing.assert_array_equal(pts2[:, 3], pts[:, 3])

    def test_no_collisions_after_noise(self, rng):
        pts, boxes = self._scene(rng, n_boxes=6)
        _, boxes2 = noise_per_object(
            rng, pts, boxes, ObjectNoiseConfig(translate_std=1.0))
        iou = rotated_iou_bev_np(boxes2, boxes2)
        np.fill_diagonal(iou, 0.0)
        assert (iou == 0.0).all(), iou.max()

    def test_deterministic_under_seed(self, rng):
        pts, boxes = self._scene(rng)
        p1, b1 = noise_per_object(np.random.default_rng(5), pts, boxes)
        p2, b2 = noise_per_object(np.random.default_rng(5), pts, boxes)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(b1, b2)

    def test_prob_zero_is_identity(self, rng):
        pts, boxes = self._scene(rng)
        p2, b2 = noise_per_object(rng, pts, boxes,
                                  ObjectNoiseConfig(prob=0.0))
        np.testing.assert_array_equal(p2, pts)
        np.testing.assert_array_equal(b2, boxes)


# ---- GT sampling (tests/test_gt_sampler.py) -------------------------------

def _db_from_scenes(rng, n=6):
    scenes = [make_scene(rng, CFG, num_objects=6, points_per_object=80,
                         clutter=500) for _ in range(n)]
    return GTDatabase.from_scenes(scenes, CFG.num_classes), scenes


def test_extraction_counts_and_local_frame(rng):
    db, _ = _db_from_scenes(rng)
    assert db.counts().sum() > 0
    for ci in range(db.num_classes):
        for b, p in zip(db.boxes[ci], db.points[ci]):
            assert len(p) >= 5
            assert (np.abs(p[:, 0]) <= b[4] / 2 + 0.06).all()  # l on local x
            assert (np.abs(p[:, 1]) <= b[3] / 2 + 0.06).all()
            assert (np.abs(p[:, 2]) <= b[5] / 2 + 0.06).all()


def test_points_in_box_respects_yaw():
    box = np.array([10.0, 0.0, 0.0, 1.0, 4.0, 2.0, np.pi / 2])
    pts = np.array([[10.0, 1.8, 0.0],    # inside (along length)
                    [11.8, 0.0, 0.0],    # outside (width is only 1)
                    [10.4, 0.0, 0.0]])   # inside (within half-width)
    assert points_in_box(pts, box).tolist() == [True, False, True]


def test_injection_reaches_targets_without_collisions(rng):
    db, _ = _db_from_scenes(rng)
    scene = make_scene(rng, CFG, num_objects=2, points_per_object=80,
                       clutter=800)
    target = 3
    sampler = GTSampler(db, GTSampleConfig(target_per_class=target))
    pts, boxes, classes = sampler(rng, scene.points, scene.gt_boxes,
                                  scene.gt_classes)
    np.testing.assert_array_equal(boxes[: len(scene.gt_boxes)],
                                  scene.gt_boxes)
    for ci in range(CFG.num_classes):
        have = int((classes == ci).sum())
        pool = len(db.boxes[ci]) + int((scene.gt_classes == ci).sum())
        assert have >= min(target, pool) or have >= int(
            (scene.gt_classes == ci).sum())
    iou = rotated_iou_bev_np(boxes, boxes)
    np.fill_diagonal(iou, 0.0)
    assert iou.max() == 0.0
    for b in boxes[len(scene.gt_boxes):]:
        assert points_in_box(pts, b, 0.06).sum() >= 5


def test_background_points_removed_under_injected_boxes(rng):
    db, _ = _db_from_scenes(rng)
    scene = make_scene(rng, CFG, num_objects=1, points_per_object=60,
                       clutter=2000)
    sampler = GTSampler(db, GTSampleConfig(target_per_class=2, margin=0.1))
    pts, boxes, classes = sampler(rng, scene.points, scene.gt_boxes,
                                  scene.gt_classes)
    assert len(boxes) > len(scene.gt_boxes)
    for b in boxes[len(scene.gt_boxes):]:
        inside = pts[points_in_box(pts, b, 0.0)]
        orig_inside = scene.points[points_in_box(scene.points, b, 0.0)]
        assert len(inside) > 0
        if len(orig_inside):
            surv = {tuple(np.round(r, 4)) for r in inside[:, :3]}
            for r in orig_inside[:, :3]:
                assert tuple(np.round(r, 4)) not in surv


def test_injection_noop_when_scene_already_full(rng):
    db, _ = _db_from_scenes(rng)
    scene = make_scene(rng, CFG, num_objects=8, points_per_object=60,
                       clutter=500)
    sampler = GTSampler(db, GTSampleConfig(target_per_class=0))
    pts, boxes, _ = sampler(rng, scene.points, scene.gt_boxes,
                            scene.gt_classes)
    np.testing.assert_array_equal(pts, scene.points)
    np.testing.assert_array_equal(boxes, scene.gt_boxes)


def test_inject_padded_respects_capacity(rng):
    db, _ = _db_from_scenes(rng)
    scene = make_scene(rng, CFG, num_objects=2, points_per_object=60,
                       clutter=500)
    cap = 4
    gb = np.zeros((cap, 7), np.float32)
    gc = np.zeros((cap,), np.int32)
    gv = np.zeros((cap,), bool)
    g = len(scene.gt_boxes)
    gb[:g], gc[:g], gv[:g] = scene.gt_boxes, scene.gt_classes, True
    sampler = GTSampler(db, GTSampleConfig(target_per_class=10))
    _, ob, oc, ov = sampler.inject_padded(rng, scene.points, gb, gc, gv)
    assert g < ov.sum() <= cap
    assert ob.shape == gb.shape and oc.shape == gc.shape


def test_database_save_load_roundtrip(tmp_path, rng):
    db, _ = _db_from_scenes(rng)
    path = str(tmp_path / "gtdb.npz")
    db.save(path)
    db2 = GTDatabase.load(path)
    np.testing.assert_array_equal(db.counts(), db2.counts())
    for ci in range(db.num_classes):
        for b1, b2 in zip(db.boxes[ci], db2.boxes[ci]):
            np.testing.assert_array_equal(b1, b2)
        for p1, p2 in zip(db.points[ci], db2.points[ci]):
            np.testing.assert_array_equal(p1, p2)


def test_from_dataset_and_batches_wiring(tmp_path):
    json_dir = build_fixture(str(tmp_path / "ds"), CFG, num_scenes=1,
                             samples_per_scene=2, sweeps_per_sample=1,
                             seed=3)
    ds = LyftDataset(json_dir)
    db = GTDatabase.from_dataset(ds, CFG)
    assert db.counts().sum() > 0
    sampler = GTSampler(db, GTSampleConfig(target_per_class=2))
    batch = next(iter(dataset_batches(ds, CFG, 2, 16, gt_sampler=sampler,
                                      seed=1, epochs=1)))
    plain = next(iter(dataset_batches(ds, CFG, 2, 16, seed=1, epochs=1)))
    assert batch[4].sum() >= plain[4].sum()
    assert batch[0].shape == plain[0].shape


def test_points_in_boxes_bit_equals_per_box(rng):
    pts = rng.uniform(-50, 50, (5000, 4)).astype(np.float32)
    boxes = np.stack([
        np.array([*rng.uniform(-50, 50, 2), rng.uniform(-2, 1),
                  rng.uniform(0.5, 3), rng.uniform(0.5, 6),
                  rng.uniform(0.8, 3), rng.uniform(-np.pi, np.pi)],
                 np.float32)
        for _ in range(60)])
    for margin in (0.0, 0.05, 0.1):
        want = np.stack([points_in_box(pts, b, margin) for b in boxes])
        np.testing.assert_array_equal(points_in_boxes(pts, boxes, margin),
                                      want)
    assert points_in_boxes(pts, np.zeros((0, 7), np.float32)).shape == \
        (0, 5000)
    assert points_in_boxes(pts[:0], boxes).shape == (60, 0)


def test_collision_prefilter_matches_exact_iou(rng):
    """Every pair the circumradius pre-filter skips has exact IoU 0."""
    boxes = np.stack([
        np.array([*rng.uniform(-20, 20, 2), 0.0,
                  rng.uniform(0.5, 3), rng.uniform(0.5, 6),
                  rng.uniform(0.8, 3), rng.uniform(-np.pi, np.pi)],
                 np.float32)
        for _ in range(80)])
    rad = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4])
    iou = rotated_iou_bev_np(boxes, boxes)
    dx = boxes[:, None, 0] - boxes[None, :, 0]
    dy = boxes[:, None, 1] - boxes[None, :, 1]
    far = dx * dx + dy * dy >= (rad[:, None] + rad[None, :] + 1e-3) ** 2
    assert (iou[far] == 0.0).all()
    assert far.sum() > 0 and (~far).sum() > len(boxes)


# ---- dataset batches (tests/test_train_data.py) ---------------------------

def test_sample_to_arrays(dataset):
    tok = dataset.sample_tokens()[0]
    pts, gb, gc, gv = sample_to_arrays(dataset, tok, CFG, max_gt_boxes=8)
    assert pts.shape[1] == CFG.num_raw_features
    assert gv.sum() == len(dataset.get_boxes_lidar(tok))
    assert (gc[gv] >= 0).all() and (gc[gv] < CFG.num_classes).all()
    assert np.abs(gb[gv][:, :2]).max() < CFG.x_max


def test_dataset_batches_epoch(dataset):
    batches = list(dataset_batches(dataset, CFG, batch_size=2,
                                   max_gt_boxes=8, epochs=1, seed=1))
    assert len(batches) == 2  # 4 samples / batch 2
    points, num_points, _, _, gt_valid = batches[0]
    assert points.shape == (2, CFG.max_points, 4)
    assert (num_points > 0).all()
    assert gt_valid.any()


def test_train_step_on_dataset_batch(dataset):
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import batch_to_device, make_train_step

    tcfg = TrainConfig(batch_size=2, max_gt_boxes=8, total_steps=10)
    state = create_train_state(CFG, tcfg, device="cpu")
    it = dataset_batches(dataset, CFG, batch_size=2, max_gt_boxes=8,
                         augment=AugmentConfig(), epochs=1)
    state, losses = make_train_step(CFG)(state,
                                         batch_to_device(next(it), "cpu"))
    assert np.isfinite(float(losses.total))
    assert float(losses.num_pos) > 0
    assert state.step == 1


def test_dataset_batches_too_few_samples_raises(dataset):
    with pytest.raises(ValueError, match="batch_size"):
        next(iter(dataset_batches(dataset, CFG, batch_size=64,
                                  max_gt_boxes=8)))


def test_lyft_dataset_wrong_root_raises(tmp_path):
    root = str(tmp_path / "fxroot")
    json_dir = build_fixture(root, CFG, num_scenes=1, samples_per_scene=2,
                             sweeps_per_sample=1)
    assert json_dir != root
    with pytest.raises(FileNotFoundError, match="json TABLE dir"):
        LyftDataset(root)
    with pytest.raises(FileNotFoundError):
        LyftDataset(str(tmp_path / "nowhere"))


def test_class_balanced_tokens_equal_share_and_determinism(dataset):
    tokens = dataset.sample_tokens()
    name_to_id = {c.name: i for i, c in enumerate(CFG.classes)}
    present = set()
    for tok in tokens:
        present |= {name_to_id[b.label] for b in dataset.get_boxes_lidar(tok)
                    if b.label in name_to_id}
    assert present

    out = class_balanced_tokens(dataset, CFG, seed=3)
    share = max(1, round(len(tokens) / len(present)))
    assert len(out) == share * len(present)
    assert set(out) <= set(tokens)
    for ci in present:
        holders = {t for t in tokens
                   if any(name_to_id.get(b.label) == ci
                          for b in dataset.get_boxes_lidar(t))}
        assert sum(1 for t in out if t in holders) >= share
    assert class_balanced_tokens(dataset, CFG, seed=3) == out
    out2 = class_balanced_tokens(dataset, CFG, seed=3, ratio=2.0)
    assert len(out2) == max(1, round(2.0 * len(tokens) / len(present))) \
        * len(present)


def test_class_balanced_tokens_feeds_dataset_batches(dataset):
    toks = class_balanced_tokens(dataset, CFG, seed=0, ratio=1.0)
    batches = list(dataset_batches(dataset, CFG, batch_size=2,
                                   max_gt_boxes=8, tokens=toks, epochs=1,
                                   seed=1))
    assert len(batches) == len(toks) // 2
    assert all((b[1] > 0).all() for b in batches)


def test_class_balanced_tokens_no_known_classes_raises():
    class Empty:
        def sample_tokens(self):
            return ["a", "b"]

        def get_boxes_lidar(self, tok):
            return []

    with pytest.raises(ValueError, match="no sample contains"):
        class_balanced_tokens(Empty(), CFG)


# ---- parity with the JAX package ------------------------------------------

def test_augmentations_match_jax_bit_for_bit():
    from tpu_pillars.data import augment as jaug
    from tpu_pillars.data import gt_sampler as jgts

    for seed in range(4):
        scene = make_scene(np.random.default_rng(seed), CFG, num_objects=6,
                           points_per_object=80, clutter=500)
        args = (scene.points, scene.gt_boxes)
        for port_fn, jax_fn, cfg in (
                (augment_scene, jaug.augment_scene, AugmentConfig()),
                (noise_per_object, jaug.noise_per_object,
                 ObjectNoiseConfig(translate_std=1.0))):
            jcfg = type(cfg).__name__
            got = port_fn(np.random.default_rng(seed + 10), *args, cfg)
            want = jax_fn(np.random.default_rng(seed + 10), *args,
                          getattr(jaug, jcfg)(**vars(cfg)))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        for margin in (0.0, 0.05):
            np.testing.assert_array_equal(
                points_in_boxes(scene.points, scene.gt_boxes, margin),
                jgts.points_in_boxes(scene.points, scene.gt_boxes, margin))


def test_gt_database_and_cbgs_match_jax(big_fixture):
    from tpu_pillars.config import tiny_config as jax_tiny_config
    from tpu_pillars.data.gt_sampler import GTDatabase as JaxGTDatabase
    from tpu_pillars.data.lyft import LyftDataset as JaxLyftDataset
    from tpu_pillars.train.data import \
        class_balanced_tokens as jax_balanced

    jcfg = jax_tiny_config()
    ds, jds = LyftDataset(big_fixture), JaxLyftDataset(big_fixture)
    tokens = ds.sample_tokens()[:5]
    got = GTDatabase.from_dataset(ds, CFG, tokens=tokens)
    want = JaxGTDatabase.from_dataset(jds, jcfg, tokens=tokens)
    np.testing.assert_array_equal(got.counts(), want.counts())
    assert got.counts().sum() > 0
    for ci in range(CFG.num_classes):
        for a, b in zip(got.boxes[ci] + got.points[ci],
                        want.boxes[ci] + want.points[ci]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for seed, ratio in ((0, 1.0), (3, 2.0)):
        assert class_balanced_tokens(ds, CFG, seed=seed, ratio=ratio) == \
            jax_balanced(jds, jcfg, seed=seed, ratio=ratio)


@pytest.mark.parametrize("workers", [0, 4])
def test_dataset_batches_match_jax_stream(big_fixture, workers):
    """Every augmentation on (GT sampling, object noise, the global
    transforms) over a CBGS token list: the port's stream equals the JAX
    package's bit for bit, with 0 or 4 workers on the port's side (the JAX
    side runs serially)."""
    from tpu_pillars.config import tiny_config as jax_tiny_config
    from tpu_pillars.data import augment as jaug
    from tpu_pillars.data import gt_sampler as jgts
    from tpu_pillars.data.lyft import LyftDataset as JaxLyftDataset
    from tpu_pillars.train import data as jdata

    jcfg = jax_tiny_config()
    ds, jds = LyftDataset(big_fixture), JaxLyftDataset(big_fixture)
    tokens = ds.sample_tokens()
    toks = class_balanced_tokens(ds, CFG, tokens=tokens, seed=2)
    sampler = GTSampler(GTDatabase.from_dataset(ds, CFG, tokens=tokens),
                        GTSampleConfig(target_per_class=2))
    jsampler = jgts.GTSampler(
        jgts.GTDatabase.from_dataset(jds, jcfg, tokens=tokens),
        jgts.GTSampleConfig(target_per_class=2))
    got = list(dataset_batches(
        ds, CFG, 2, 16, tokens=toks, augment=AugmentConfig(),
        object_noise=ObjectNoiseConfig(), gt_sampler=sampler, seed=5,
        epochs=2, num_workers=workers))
    want = list(jdata.dataset_batches(
        jds, jcfg, 2, 16, tokens=toks, augment=jaug.AugmentConfig(),
        object_noise=jaug.ObjectNoiseConfig(), gt_sampler=jsampler, seed=5,
        epochs=2, num_workers=0))
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        assert len(g) == len(w) == 5
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # the augmentations moved something: not the plain stream
    plain = next(iter(dataset_batches(ds, CFG, 2, 16, tokens=toks, seed=5)))
    assert not np.array_equal(plain[0], got[0][0])


@pytest.fixture(scope="module")
def sweep_fixture(tmp_path_factory):
    """6 samples of 3 sweeps each: the json table dir."""
    root = tmp_path_factory.mktemp("lyft_sweep_fixture")
    return build_fixture(str(root), CFG_MS, num_scenes=2,
                         samples_per_scene=3, sweeps_per_sample=3, seed=6)


CFG_MS = tiny_config(num_sweeps=3, max_points=8192)


@pytest.mark.parametrize("workers,use_native", [(0, True), (4, True),
                                                (4, False)])
def test_multi_sweep_batches_match_jax_stream(sweep_fixture, workers,
                                              use_native):
    """The multi-sweep stream (3 sweeps a sample, the dt column) with
    object noise and the global transforms: the port's equals the JAX
    package's bit for bit (both on the native loader), with 0 or 4 workers
    on the port's side; the port's numpy path gives the same stream."""
    from tpu_pillars.config import tiny_config as jax_tiny_config
    from tpu_pillars.data import augment as jaug
    from tpu_pillars.data.lyft import LyftDataset as JaxLyftDataset
    from tpu_pillars.train import data as jdata

    jcfg = jax_tiny_config(num_sweeps=3, max_points=8192)
    ds, jds = LyftDataset(sweep_fixture), JaxLyftDataset(sweep_fixture)
    got = list(dataset_batches(
        ds, CFG_MS, 2, 16, augment=AugmentConfig(),
        object_noise=ObjectNoiseConfig(), seed=5, epochs=2,
        use_native=use_native, num_workers=workers))
    want = list(jdata.dataset_batches(
        jds, jcfg, 2, 16, augment=jaug.AugmentConfig(),
        object_noise=jaug.ObjectNoiseConfig(), seed=5, epochs=2,
        use_native=True, num_workers=0))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    points, num_points = got[0][0], got[0][1]
    assert points.shape == (2, CFG_MS.max_points, 5)
    # every sample holds all three sweeps: three distinct dt values
    for i in range(2):
        dts = np.unique(points[i, : num_points[i], 4])
        assert len(dts) == 3 and dts[0] == 0.0


def test_sample_to_arrays_multi_sweep(sweep_fixture):
    """A multi-sweep sample: the padded load's real rows, the native and
    numpy loaders bit-equal, and the same GT as the single-sweep path."""
    ds = LyftDataset(sweep_fixture)
    tok = ds.sample_tokens()[2]
    pts, gb, gc, gv = sample_to_arrays(ds, tok, CFG_MS, 8, use_native=True)
    pts_np, gb_np, _, _ = sample_to_arrays(ds, tok, CFG_MS, 8,
                                           use_native=False)
    np.testing.assert_array_equal(pts, pts_np)
    np.testing.assert_array_equal(gb, gb_np)
    assert pts.shape[1] == CFG_MS.num_input_features == 5
    assert 0 < len(pts) <= CFG_MS.max_points
    _, gb1, gc1, gv1 = sample_to_arrays(ds, tok, CFG, 8)
    np.testing.assert_array_equal(gb, gb1)
    np.testing.assert_array_equal(gc, gc1)
    np.testing.assert_array_equal(gv, gv1)


def test_multi_sweep_train_steps_match_jax(sweep_fixture):
    """Two fused-front-end steps at ``tiny_config(num_sweeps=3)`` on one
    batch of the multi-sweep stream, against ``jax.jit(make_train_step)``
    on the same batch and weights: the losses at test_torch_train's
    tolerance, and every parameter's update. The dt column (row 4 of the
    PFN kernel, which ``fold_decoration`` folds into K2's differentiable
    twin) moves, by the same amount on both sides."""
    import jax
    import jax.numpy as jnp

    from torch_port_util import random_variables
    from tpu_pillars.config import tiny_config as jax_tiny_config
    from tpu_pillars.train import (
        TrainBatch, TrainConfig as JaxTrainConfig,
        create_train_state as jax_state, make_train_step as jax_step,
    )
    from tpu_pillars_torch import weights
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import batch_to_device, make_train_step

    jcfg = jax_tiny_config(num_sweeps=3, max_points=8192)
    arrays = next(iter(dataset_batches(LyftDataset(sweep_fixture), CFG_MS, 2,
                                       16, seed=5, use_native=True)))
    variables = random_variables(jcfg, seed=4)
    jst = jax_state(jcfg, JaxTrainConfig(batch_size=2, max_gt_boxes=16,
                                         total_steps=10))
    params = jax.tree.map(jnp.asarray, variables["params"])
    jst = jst.replace(params=params,
                      batch_stats=jax.tree.map(jnp.asarray,
                                               variables["batch_stats"]),
                      opt_state=jst.tx.init(params))
    jstep = jax.jit(jax_step(jcfg, fused_frontend=True))
    jbatch = TrainBatch(*(jnp.asarray(x) for x in arrays))
    st = create_train_state(
        CFG_MS, TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10),
        device="cpu", state_dict=weights.params_from_flax(variables, CFG_MS))
    step = make_train_step(CFG_MS)
    for i in range(2):
        jst, jl = jstep(jst, jbatch)
        st, tl = step(st, batch_to_device(arrays, "cpu"))
        np.testing.assert_allclose(float(tl.total), float(jl.total),
                                   rtol=2e-3, err_msg=f"step {i}")
        assert int(tl.num_pos) == int(jl.num_pos) > 0
    # each leaf's update (AdamW moves every weight by about the step size,
    # 2e-4 here, whatever its gradient's scale): the worst leaf's
    # difference within 5% of its largest move (0.012 at this seed; a dt
    # column cut from the graph gives 1.0 on the PFN kernel)
    got = weights.flax_from_params(st.model.state_dict(), CFG_MS)["params"]
    assert jax.tree.structure(got) == jax.tree.structure(jst.params)
    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(jst.params),
                       jax.tree.leaves(variables["params"])):
        moved_t, moved_j = np.asarray(a) - c, np.asarray(b) - c
        assert np.abs(moved_t - moved_j).max() <= 0.05 * np.abs(moved_j).max()
    dt_row = (np.asarray(jst.params["pfn"]["linear"]["kernel"])[4]
              - variables["params"]["pfn"]["linear"]["kernel"][4])
    assert np.abs(dt_row).min() > 0.0


def test_synthetic_batches_augment_match_jax():
    from tpu_pillars.config import tiny_config as jax_tiny_config
    from tpu_pillars.train.loop import synthetic_batches as jax_batches
    from tpu_pillars.train.state import TrainConfig as JaxTrainConfig
    from tpu_pillars_torch.train.state import TrainConfig

    got = next(loop.synthetic_batches(CFG, TrainConfig(batch_size=2),
                                      seed=3, augment=True))
    want = next(jax_batches(jax_tiny_config(), JaxTrainConfig(batch_size=2),
                            seed=3, augment=True))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---- main --data -----------------------------------------------------------

def _events(out):
    return [json.loads(x) for x in open(os.path.join(out, "train.jsonl"))]


def test_main_on_a_dataset_logs_losses_and_map(big_fixture, tmp_path):
    out = str(tmp_path / "run")
    loop.main(["--data", big_fixture, "--device", "cpu", "--gt-sample", "2",
               "--object-noise", "--cbgs", "1.0", "--eval-every", "2",
               "--val-samples", "2", "--steps", "2", "--batch", "2",
               "--workers", "2", "--out", out])
    events = _events(out)
    steps = [e for e in events if e["event"] == "train_step"]
    assert [e["step"] for e in steps] == [2]
    assert all(np.isfinite(e[k]) for e in steps
               for k in ("loss", "cls", "loc", "dir"))
    evals = [e for e in events if e["event"] == "eval"]
    assert len(evals) == 1 and np.isfinite(evals[0]["mAP"])
    assert 0.0 <= evals[0]["mAP"] <= 1.0


def _recording_step(seen):
    """make_train_step stand-in: records each batch's points and GT and
    advances the step without touching the model (the stream is under
    test, not the step)."""
    def make(config, **kw):
        def step(state, batch, split=None):
            seen.append((batch.points.numpy().copy(),
                         batch.gt_boxes.numpy().copy()))
            state.step += 1
            z = torch.zeros(())
            return state, LossBreakdown(z, z, z, z, z)

        return step

    return make


def test_main_resume_on_a_dataset_continues_the_stream(big_fixture,
                                                       tmp_path,
                                                       monkeypatch):
    args = ["--data", big_fixture, "--device", "cpu", "--gt-sample", "2",
            "--object-noise", "--cbgs", "1.0", "--batch", "2"]
    whole, broken = [], []
    monkeypatch.setattr(loop, "make_train_step", _recording_step(whole))
    loop.main(args + ["--steps", "4", "--out", str(tmp_path / "whole")])
    out = str(tmp_path / "broken")
    monkeypatch.setattr(loop, "make_train_step", _recording_step(broken))
    loop.main(args + ["--steps", "2", "--out", out])
    loop.main(args + ["--steps", "4", "--out", out, "--resume",
                      "--workers", "0"])
    assert [e["resumed_at"] for e in _events(out)
            if e["event"] == "start"] == [0, 2]
    assert len(whole) == len(broken) == 4
    for (p1, g1), (p2, g2) in zip(whole, broken):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(g1, g2)
    assert not np.array_equal(whole[1][0], whole[2][0])


def test_main_cbgs_without_data_warns_and_is_ignored(tmp_path, capsys):
    out = str(tmp_path / "run")
    loop.main(["--cbgs", "1.0", "--steps", "0", "--device", "cpu",
               "--batch", "1", "--prefetch", "0", "--out", out])
    assert "--cbgs needs --data; ignored" in capsys.readouterr().err
    assert [e["data"] for e in _events(out) if e["event"] == "start"] == \
        [None]
