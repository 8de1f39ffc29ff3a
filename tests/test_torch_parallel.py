"""tpu_pillars_torch's data parallelism (``parallel/``) on the CPU: two
ranks over gloo, one process each (``parallel.launch``), at
``tiny_config()``, inputs drawn with numpy from seeds and the weights of
``torch_port_util.random_variables`` through ``params_from_flax``.

One launch (``torch_parallel_ranks.all_checks``) runs every rank-side
check; the tests below read its result:

* The mesh: size, rank, device, gloo; each rank's slice of the global batch
  (``shard_train_batch``) gathers back to the batch bit for bit; the
  differentiable ``psum`` sums the cotangents over the ranks.
* The data-parallel step (``make_dp_train_step``, the dense assigner, as
  the JAX step picks it on the CPU) against JAX's
  ``make_shardmap_train_step`` on ``make_mesh(jax.devices()[:2])``, fused
  and classic, at the tolerances by which the port's one-process step
  holds against JAX (tests/test_torch_train.py, test_torch_classic_train.py:
  loss rtol 2e-3 a step, num_pos equal, parameters atol 5e-4, running
  statistics rtol 1e-2 / atol 1e-4).
* The same step against the port's own one-process step on the global
  batch, at the JAX DP tests' tolerances (tests/test_fused_train.py:
  losses rtol 1e-4, num_pos equal, running statistics rtol 1e-3 / atol
  1e-5, parameters atol 1e-3): fused (remat "all", the default) and with
  remat off, classic, and fused with ``accum_steps=2``. With accumulation
  a rank's microbatch i holds its i-th sample(s), so the one-process
  reference runs on the batch interleaved to the same microbatches.
* ``split_points_by_slab`` equal to JAX's bit for bit, with overflow; the
  spatial canvas and packed boxes bit-identical to one device's, the canvas
  within 1e-5 of JAX's ``make_spatial_frontend`` on 2 devices; a cloud
  over one device's pillar budget kept whole by the bands
  (tests/test_spatial.py:115 at 2 ranks).
* ``make_dp_packed_detector`` and ``make_dp_detector_fn`` equal to the
  ``Detector`` on the same batch (tests/test_parallel.py:31);
  ``evaluate_dataset(mesh=)`` equal to ``mesh=None``
  (tests/test_eval_pipeline.py:84).
* A rank that raises makes ``launch`` raise its exception at once;
  ``make_mesh`` outside a launched group raises; ``make_mesh_n(2)`` with
  no card exits with the JAX package's message.
"""

import numpy as np
import pytest
import torch

from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.data import fixture
from tpu_pillars_torch.data.synthetic import make_scene, scenes_to_train_batch
from tpu_pillars_torch.parallel import (
    launch, make_mesh, make_mesh_n, mesh_devices,
)
from tpu_pillars_torch.parallel.spatial import split_points_by_slab
from tpu_pillars_torch.train import state as tstate
from tpu_pillars_torch.train.step import batch_to_device, make_train_step
from tpu_pillars_torch.weights import params_from_flax

import torch_parallel_ranks as ranks

TCFG = tconfig.tiny_config()
RANKS = ["cpu", "cpu"]
DEADLINE_S = 240.0
BUDGET_PILLARS = 48

# (name, batch, step kwargs, steps): the dense assigner throughout
VARIANTS = [
    ("fused", "b2", dict(assigner="dense"), 2),
    ("fused_remat_off", "b2", dict(assigner="dense", remat=False), 2),
    ("classic", "b2", dict(assigner="dense", fused_frontend=False), 2),
    ("accum2", "b4", dict(assigner="dense", accum_steps=2), 2),
]
# the interleave that gives the one-process step the ranks' microbatches
ACCUM_ORDER = [0, 2, 1, 3]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes_batch(seed, batch):
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, TCFG, num_objects=6, points_per_object=60,
                         clutter=400) for _ in range(batch)]
    return scenes_to_train_batch(scenes, TCFG, 16)


def _budget_cloud(rng):
    """~2 points in each cell of 12 rows x 6 columns: 72 occupied pillars,
    over a 48-pillar budget; rows 0-36 (42 pillars) in band 0, 42-66 (30)
    in band 1, each under it."""
    rows = np.repeat(np.arange(0, 72, 6), 6 * 2)
    cols = np.tile(np.repeat(np.arange(0, 72, 12), 2), 12)
    x = TCFG.x_min + (cols + 0.5) * TCFG.voxel_x
    y = TCFG.y_min + (rows + 0.5) * TCFG.voxel_y
    z = np.zeros_like(x)
    i = rng.random(len(x))
    return np.stack([x, y, z, i], 1).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    variables = random_variables(tconfig.tiny_config(), seed=9)
    rng = np.random.default_rng(21)
    cloud = make_scene(rng, TCFG, num_objects=5, clutter=200).points
    eval_scenes = [make_scene(rng, TCFG, num_objects=4, clutter=300)
                   for _ in range(4)]
    det = ranks.Detector(TCFG, params_from_flax(variables, TCFG),
                         device="cpu")
    pads = [det.pad_points(s.points) for s in eval_scenes]
    data_dir = fixture.build_fixture(
        str(tmp_path_factory.mktemp("dp_fixture")), TCFG, num_scenes=1,
        samples_per_scene=3, sweeps_per_sample=1, seed=6)
    return dict(
        variables=variables, sd=params_from_flax(variables, TCFG),
        arrays={"b2": _scenes_batch(12, 2), "b4": _scenes_batch(13, 4)},
        cloud=cloud, budget_cloud=_budget_cloud(rng),
        points=np.stack([p for p, _ in pads]),
        counts=np.asarray([n for _, n in pads], np.int32),
        data_dir=data_dir)


@pytest.fixture(scope="module")
def ranked(inputs):
    return launch(ranks.all_checks, RANKS, args=(
        inputs["sd"], inputs["arrays"], VARIANTS, inputs["cloud"],
        inputs["budget_cloud"], BUDGET_PILLARS, inputs["points"],
        inputs["counts"], inputs["data_dir"]), timeout=DEADLINE_S)


# ---- the mesh ---------------------------------------------------------------

def test_mesh_slices_and_psum(ranked):
    assert ranked["mesh"] == (2, 2, 0, "cpu", "gloo", False)
    assert ranked["slices_ok"] and ranked["shard_rows"] == 1
    # rank r weighs psum(x) by r + 1: each x gets 1 + 2 summed over ranks
    np.testing.assert_array_equal(ranked["psum_grad"], np.full(3, 3.0))


def test_mesh_outside_a_group_raises():
    for devices in (None, ["cpu"], RANKS):
        with pytest.raises(RuntimeError, match="launch"):
            make_mesh(devices)


def test_make_mesh_n_without_cards_exits():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit, match="requested 2 devices, only 0 "
                       "visible"):
        make_mesh_n(2)
    with pytest.raises(SystemExit, match="requested 2 devices"):
        mesh_devices(2, "cuda")
    assert mesh_devices(3, "cpu") == ["cpu"] * 3


def test_launch_raises_a_failed_ranks_exception_at_once():
    import time

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 failed on purpose"):
        launch(ranks.fail_on_rank_1, RANKS, timeout=DEADLINE_S)
    # rank 0 was blocked in a collective: killed, not waited for
    assert time.monotonic() - t0 < 60.0


# ---- training ---------------------------------------------------------------

def _port_tree(sd):
    from tpu_pillars_torch.weights import flax_from_params

    v = flax_from_params({k: torch.from_numpy(a) for k, a in sd.items()},
                         TCFG)
    return v["params"], v["batch_stats"]


def _one_process(inputs, which, kw, steps, order=None):
    arrays = inputs["arrays"][which]
    if order is not None:
        arrays = tuple(x[order] for x in arrays)
    tcfg = tstate.TrainConfig(batch_size=len(arrays[0]), max_gt_boxes=16,
                              total_steps=10)
    st = tstate.create_train_state(TCFG, tcfg, device="cpu",
                                   state_dict=inputs["sd"])
    grads = ranks.record_first_grads(st)
    step = make_train_step(TCFG, **kw)
    losses = []
    for _ in range(steps):
        st, loss = step(st, batch_to_device(arrays, "cpu"))
        losses.append([float(x) for x in loss])
    return losses, ranks.numpy_state(st.model), grads


@pytest.mark.parametrize("name", [v[0] for v in VARIANTS])
def test_dp_step_matches_one_process_step(ranked, inputs, name):
    _, which, kw, steps = next(v for v in VARIANTS if v[0] == name)
    want_l, want_sd, want_g = _one_process(
        inputs, which, kw, steps, ACCUM_ORDER if name == "accum2" else None)
    got_l, got_states, got_g = ranked["train"][name]
    got_sd = got_states[-1]
    # the first update's gradients themselves (AdamW's first step moves
    # each parameter by about lr * sign(g), whatever |g|)
    for key, want in want_g.items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(got_g[key], want, rtol=0,
                                   atol=1e-4 * scale, err_msg=key)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g[:4], w[:4], rtol=1e-4,
                                   err_msg=f"step {i}")
        assert g[4] == w[4] > 0
    for key, want in want_sd.items():
        if "running" in key:
            np.testing.assert_allclose(got_sd[key], want, rtol=1e-3,
                                       atol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(got_sd[key], want, atol=1e-3,
                                       err_msg=key)
    assert not np.allclose(got_sd["pfn.bn.running_mean"],
                           inputs["sd"]["pfn.bn.running_mean"].numpy())


@pytest.mark.parametrize("name", ["fused", "classic"])
def test_dp_step_matches_jax_shardmap_step(ranked, inputs, name):
    import jax
    import jax.numpy as jnp

    from tpu_pillars.config import tiny_config
    from tpu_pillars.parallel import (
        make_mesh as jax_mesh, make_shardmap_train_step, shard_train_batch,
    )
    from tpu_pillars.train import (
        TrainBatch, TrainConfig, create_train_state,
    )

    cfg = tiny_config()
    which = next(v[1] for v in VARIANTS if v[0] == name)
    steps = 1    # a JAX shard_map step takes 10-15 s on the CPU
    mesh = jax_mesh(jax.devices()[:2])
    st = create_train_state(cfg, TrainConfig(batch_size=2, max_gt_boxes=16,
                                             total_steps=10))
    variables = inputs["variables"]
    params = jax.tree.map(jnp.asarray, variables["params"])
    st = st.replace(params=params,
                    batch_stats=jax.tree.map(jnp.asarray,
                                             variables["batch_stats"]),
                    opt_state=st.tx.init(params))
    step = make_shardmap_train_step(cfg, mesh,
                                    fused_frontend=name == "fused")
    batch = shard_train_batch(
        TrainBatch(*(jnp.asarray(x) for x in inputs["arrays"][which])), mesh)
    got_l, got_states, _ = ranked["train"][name]
    got_sd = got_states[steps - 1]
    for i in range(steps):
        st, jl = step(st, batch)
        np.testing.assert_allclose(got_l[i][0], float(jl.total), rtol=2e-3,
                                   err_msg=f"step {i}")
        assert got_l[i][4] == int(jl.num_pos) > 0
    params, stats = _port_tree(got_sd)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(st.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4)
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(st.batch_stats)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2,
                                   atol=1e-4)


# ---- the spatial front end -------------------------------------------------

def test_split_points_by_slab_matches_jax(inputs):
    from tpu_pillars.config import tiny_config
    from tpu_pillars.parallel import split_points_by_slab as jax_split

    cloud = inputs["cloud"]
    for n, cap in ((2, None), (4, None), (2, 16)):
        got = split_points_by_slab(cloud, TCFG, n, capacity=cap)
        want = jax_split(cloud, tiny_config(), n, capacity=cap)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == want[0].dtype and got[2] == want[2]
    assert got[2]["dropped_capacity"] > 0
    with pytest.raises(ValueError, match="not divisible"):
        split_points_by_slab(cloud, TCFG, 3)


def test_spatial_canvas_and_boxes_equal_one_device(ranked):
    sp = ranked["spatial"]
    assert sp["info"]["dropped_capacity"] == 0
    assert np.array_equal(sp["canvas"], sp["one_canvas"])
    assert np.any(sp["canvas"] != 0, axis=-1).sum() > 50
    assert np.array_equal(sp["packed"], sp["one_packed"])
    assert sp["packed"][:, 9].sum() > 0


def test_spatial_canvas_matches_jax(ranked, inputs):
    import jax

    from tpu_pillars.config import tiny_config
    from tpu_pillars.parallel import (
        make_mesh as jax_mesh, make_spatial_frontend as jax_frontend,
        split_points_by_slab as jax_split,
    )

    cfg = tiny_config()
    mesh = jax_mesh(jax.devices()[:2])
    bands, counts, _ = jax_split(inputs["cloud"], cfg, 2)
    want = np.asarray(jax_frontend(cfg, mesh, fused_frontend=True)(
        inputs["variables"], bands, counts))
    got = ranked["spatial"]["canvas"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.any(got != 0, -1), np.any(want != 0, -1))


def test_spatial_budget_exceeds_one_device(ranked):
    """A cloud over one device's pillar budget: the bands keep all 72
    pillars, exactly the canvas of one device with room for them; one
    device at the budget keeps 48."""
    sp = ranked["spatial"]
    occ = np.any(sp["budget_canvas"] != 0, axis=-1)
    assert np.array_equal(sp["budget_canvas"], sp["one_full"])
    assert np.any(sp["one_small"] != 0, axis=-1).sum() <= BUDGET_PILLARS
    assert occ.sum() > BUDGET_PILLARS
    band = TCFG.grid_h // 2
    assert {int(r) // band for r in np.nonzero(occ)[0]} == {0, 1}


# ---- evaluation -----------------------------------------------------------

def test_dp_detectors_match_detector(ranked):
    ev = ranked["eval"]
    assert ev["packed"].shape == (4, TCFG.max_detections, 10)
    assert np.array_equal(ev["packed"], ev["one_packed"])
    assert ev["packed"][..., 9].sum() > 0
    for got, want in zip(ev["dets"], ev["one_dets"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_evaluate_dataset_on_mesh_matches_one_device(ranked):
    (m_mesh, p_mesh), (m_one, p_one) = ranked["eval"]["eval_mesh"], \
        ranked["eval"]["eval_one"]
    # tests/test_eval_pipeline.py:84's tolerances: the ranks' batch of one
    # runs the convs at another batch size than one device's batch of two
    assert m_mesh == pytest.approx(m_one, abs=1e-9)
    assert sorted(p_mesh) == sorted(p_one) and len(p_one) == 3
    assert sum(len(b) for b in p_one.values()) > 0
    for tok, want in p_one.items():
        got = p_mesh[tok]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.label == b.label
            assert a.score == pytest.approx(b.score, abs=1e-5)
            np.testing.assert_allclose(a.center, b.center, atol=1e-5)
            np.testing.assert_allclose(a.wlh, b.wlh, atol=1e-5)
