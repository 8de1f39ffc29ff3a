"""What tests/test_torch_parallel.py runs in each rank of
``tpu_pillars_torch.parallel.launch``. The spawned ranks import this
module, so it imports no jax and nothing of ``tpu_pillars``; each rank
runs one torch thread."""

import numpy as np
import torch
import torch.distributed as dist

from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch.data.lyft import LyftDataset
from tpu_pillars_torch.detector import Detector
from tpu_pillars_torch.evaluation.pipeline import evaluate_dataset
from tpu_pillars_torch.parallel import (
    make_dp_detector_fn, make_dp_packed_detector, make_dp_train_step,
    make_mesh, make_spatial_detector_fn, make_spatial_frontend,
    shard_train_batch, split_points_by_slab,
)
from tpu_pillars_torch.train.state import TrainConfig, create_train_state

TCFG = tconfig.tiny_config()


def numpy_state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def record_first_grads(state) -> dict:
    """Make ``state.optimizer`` record the gradients of its first update
    (as given, or each parameter's ``.grad``) into the returned dict, by
    parameter name."""
    names = [n for n, _ in state.model.named_parameters()]
    seen = {}
    opt = state.optimizer
    update = opt.step

    def recording(grads=None):
        if not seen:
            gs = grads if grads is not None else [p.grad
                                                  for p in opt.params]
            seen.update((n, g.detach().cpu().numpy().copy())
                        for n, g in zip(names, gs))
        return update(grads)

    opt.step = recording
    return seen


def train_runs(state_dict, arrays_by_batch, variants):
    """For each (name, batch name, step kwargs, steps): a fresh state from
    ``state_dict`` takes ``steps`` data-parallel steps on the global batch
    -> {name: (losses per step, numpy state dicts after each step, the
    first step's averaged gradients)}."""
    mesh = make_mesh()
    out = {}
    for name, which, kw, steps in variants:
        arrays = arrays_by_batch[which]
        tcfg = TrainConfig(batch_size=len(arrays[0]), max_gt_boxes=16,
                           total_steps=10)
        st = create_train_state(TCFG, tcfg, device=mesh.device,
                                state_dict=state_dict)
        grads = record_first_grads(st)
        step = make_dp_train_step(TCFG, mesh, **kw)
        losses, states = [], []
        for _ in range(steps):
            st, loss = step(st, arrays)
            losses.append([float(x) for x in loss])
            states.append(numpy_state(st.model))
        out[name] = (losses, states, grads)
    return out


def spatial_runs(state_dict, cloud, budget_cloud, budget_pillars):
    """The spatial front end and detector over the ranks' row bands, and
    in this rank the one-device canvas and boxes of the same cloud; the
    budget case on ``tiny_config(max_pillars=budget_pillars)``."""
    mesh = make_mesh()
    det = Detector(TCFG, state_dict, device=mesh.device)
    bands, counts, info = split_points_by_slab(cloud, TCFG, mesh.size)
    canvas = make_spatial_frontend(TCFG, mesh)(det.model, bands, counts)
    packed = make_spatial_detector_fn(TCFG, mesh)(det.model, bands, counts)
    pad, n = det.pad_points(cloud)
    one = det.canvas(torch.from_numpy(pad[None]), torch.tensor([int(n)]))[0]

    small = tconfig.tiny_config(max_pillars=budget_pillars)
    det_small = Detector(small, state_dict, device=mesh.device)
    b_bands, b_counts, _ = split_points_by_slab(budget_cloud, small,
                                                mesh.size)
    b_canvas = make_spatial_frontend(small, mesh)(det_small.model, b_bands,
                                                  b_counts)
    canvases = {}
    for name, d in (("one_small", det_small), ("one_full", det)):
        p, k = d.pad_points(budget_cloud)
        canvases[name] = d.canvas(torch.from_numpy(p[None]),
                                  torch.tensor([int(k)]))[0].numpy()
    return dict(canvas=canvas.numpy(), one_canvas=one.numpy(),
                packed=packed.numpy(),
                one_packed=det.predict_packed(cloud).numpy(), info=info,
                budget_canvas=b_canvas.numpy(), **canvases)


def eval_runs(state_dict, points, counts, data_dir):
    """make_dp_packed_detector and make_dp_detector_fn on a global batch
    beside the Detector in this rank; evaluate_dataset with the mesh and
    without it."""
    mesh = make_mesh()
    det = Detector(TCFG, state_dict, device=mesh.device)
    packed = make_dp_packed_detector(TCFG, mesh)(det.model, points, counts)
    dets = make_dp_detector_fn(TCFG, mesh)(det.model, points, counts)
    ds = LyftDataset(data_dir)
    on_mesh = evaluate_dataset(det, ds, batch_size=1, mesh=mesh)
    one = evaluate_dataset(det, ds, batch_size=2)
    return dict(
        packed=packed.numpy(),
        dets=[t.numpy() for t in dets],
        one_packed=det.predict_packed_batch(points, counts).numpy(),
        one_dets=[t.numpy() for t in det.predict_raw_batch(points, counts)],
        eval_mesh=(on_mesh[0], on_mesh[2]), eval_one=(one[0], one[2]))


def all_checks(state_dict, arrays_by_batch, variants, cloud, budget_cloud,
               budget_pillars, points, counts, data_dir):
    """One launch for every check of the test module (a launch costs each
    rank a process start): the mesh, the batch slices, the steps, the
    spatial front end and the evaluation. Rank 0's result is returned."""
    torch.set_num_threads(1)
    mesh = make_mesh()
    glob = arrays_by_batch["b2"]
    shard = shard_train_batch(glob, mesh)
    gathered = [mesh.all_gather(torch.as_tensor(x)).numpy()
                for x in shard]
    # psum's backward sums the cotangents: d/dx of sum_r (r + 1) psum(x)
    x = torch.ones(3, requires_grad=True)
    (mesh.psum(x) * (mesh.rank + 1)).sum().backward()
    return dict(
        mesh=(mesh.size, int(mesh.devices.size), mesh.rank,
              str(mesh.device), dist.get_backend(), mesh.host_staged),
        slices_ok=all(np.array_equal(g, a) for g, a in zip(gathered, glob)),
        shard_rows=len(shard.points), psum_grad=x.grad.numpy(),
        train=train_runs(state_dict, arrays_by_batch, variants),
        spatial=spatial_runs(state_dict, cloud, budget_cloud,
                             budget_pillars),
        eval=eval_runs(state_dict, points, counts, data_dir))


def fail_on_rank_1():
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    mesh = make_mesh()
    if mesh.rank == 1:
        raise ValueError("rank 1 failed on purpose")
    mesh.all_reduce_(torch.ones(1))
    return "unreachable"


def train_with_slow_eval(args, timeout_s, sleep_s):
    """``train.loop.train(args)`` in a rank whose mesh's collectives give
    up after ``timeout_s`` seconds and whose eval hook first sleeps
    ``sleep_s`` seconds, once: an eval longer than the collective timeout,
    as a large held-out split at full size can be."""
    import dataclasses
    import time
    from datetime import timedelta

    import tpu_pillars_torch.parallel as par
    from tpu_pillars_torch.train import loop

    torch.set_num_threads(1)
    group = dist.new_group(timeout=timedelta(seconds=timeout_s))
    make_mesh_n = par.make_mesh_n
    par.make_mesh_n = lambda *a, **kw: dataclasses.replace(
        make_mesh_n(*a, **kw), group=group)
    make_eval_fn = loop.make_synthetic_eval_fn

    def slow_eval_fn(*a, **kw):
        eval_fn = make_eval_fn(*a, **kw)
        calls = []

        def slow(state):
            if not calls:
                time.sleep(sleep_s)
            calls.append(state.step)
            return eval_fn(state)

        return slow

    loop.make_synthetic_eval_fn = slow_eval_fn
    loop.train(args)
