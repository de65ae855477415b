"""Multi-process helpers for the port's torch.distributed tests (no tests of
its own).

``start_ranks(fn, n, *args)`` spawns ``n`` processes joined in one gloo
process group, each running ``fn(rank, n, *args)``; ``.results()`` returns
their results in rank order. Each group meets at its own ``FileStore``
file, so groups of concurrent test workers never meet. A child that fails
or hangs fails the test: the children are joined with a time limit, then
killed. The children import this module, torch, numpy and the port, never
JAX: each reports the JAX and gs2d_tpu modules it holds, and ``results``
fails unless that list is empty.

The worker functions below build their inputs from NumPy arrays the test
passes, so the test can give the same arrays to the JAX package in the
parent while the children run.
"""

import dataclasses
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback

TIMEOUT_S = 120


def _entry(fn, rank, n, store, queue, args):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n)
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "gs2d_tpu"))
        queue.put((rank, "ok", out, foreign))
    except BaseException:                      # noqa: BLE001 - reported
        queue.put((rank, "error", traceback.format_exc(), []))
        raise


class Ranks:
    """``n`` spawned ranks of one gloo group (``start_ranks``)."""

    def __init__(self, fn, n, args, timeout):
        ctx = multiprocessing.get_context("spawn")
        self.tmp = tempfile.mkdtemp(prefix="gs2d_ranks_")
        self.queue = ctx.Queue()
        self.n, self.deadline = n, time.monotonic() + timeout
        self.procs = [ctx.Process(
            target=_entry, args=(fn, r, n, os.path.join(self.tmp, "store"),
                                 self.queue, args), daemon=True)
            for r in range(n)]
        for p in self.procs:
            p.start()

    def results(self) -> list:
        got, errors = {}, []
        try:
            while len(got) + len(errors) < self.n:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    raise AssertionError(
                        f"ranks {sorted(set(range(self.n)) - set(got))} did "
                        "not finish in time")
                try:
                    rank, status, out, foreign = self.queue.get(
                        timeout=min(left, 1.0))
                except Exception:              # noqa: BLE001 - queue.Empty
                    if any(p.exitcode not in (None, 0) for p in self.procs) \
                            and self.queue.empty():
                        raise AssertionError(
                            "a rank died: exit codes "
                            f"{[p.exitcode for p in self.procs]}")
                    continue
                if status != "ok":
                    errors.append(f"rank {rank}:\n{out}")
                    break
                assert foreign == [], (rank, foreign)
                got[rank] = out
            assert not errors, "\n".join(errors)
            for p in self.procs:
                p.join(timeout=max(self.deadline - time.monotonic(), 1.0))
            assert all(p.exitcode == 0 for p in self.procs), \
                [p.exitcode for p in self.procs]
            return [got[r] for r in range(self.n)]
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            shutil.rmtree(self.tmp, ignore_errors=True)


def start_ranks(fn, n, *args, timeout=TIMEOUT_S) -> Ranks:
    return Ranks(fn, n, args, timeout)


# --- workers (run in the children) -------------------------------------------

def port_camera_of(width, height):
    from .test_torch_common import port_camera
    return port_camera(width, height)


def preprocessed(cloud, width, height):
    """The port's preprocess of a random_cloud tuple (colors given)."""
    import torch

    from gs2d_torch.ops.rasterize.preprocess import preprocess
    means, scales, quats, opac, rgb, noise = (torch.as_tensor(x)
                                              for x in cloud)
    cam = port_camera_of(width, height)
    return preprocess(means, scales, quats, opac, cam.world_view,
                      cam.full_proj, cam.campos, width, height, colors=rgb,
                      noise=noise)


def state_of(fields):
    """A port GaussianState from the NumPy fields of a JAX state."""
    from gs2d_torch.models.gaussians import state_from_numpy
    return state_from_numpy(**fields, device="cpu")


def step_arrays(ts, metrics) -> dict:
    """What the parallel tests compare of a step's result, as NumPy."""
    g = ts.gaussians
    out = {f: getattr(g.params, f).numpy().copy()
           for f in ("xyz", "features_dc", "features_rest", "scaling",
                     "rotation", "opacity")}
    out.update(mu_xyz=ts.opt.mu.xyz.numpy().copy(),
               nu_xyz=ts.opt.nu.xyz.numpy().copy(),
               grad_accum=g.grad_accum.numpy().copy(),
               denom=g.denom.numpy().copy(),
               max_radii2d=g.max_radii2d.numpy().copy(),
               loss=float(metrics["total_loss"]))
    return out


def one_step(fields, gt, iteration, group=None, grid=None, shard=False):
    """One port train step (default OptimizationParams, zero background) on
    the whole state, or on this rank's shard of it (``shard``), gathered
    back whole afterwards."""
    import torch

    from gs2d_torch.config import OptimizationParams
    from gs2d_torch.parallel import gaussian_parallel as gp
    from gs2d_torch.train.optim import init_adam
    from gs2d_torch.train.step import TrainState, make_train_step
    state = state_of(fields)
    opt = init_adam(state.params)
    if shard:
        state, opt = gp.shard_state(state, opt, grid)
    step = make_train_step(OptimizationParams(), device="cpu", group=group,
                           grid=grid)
    ts, m = step(TrainState(state, opt), port_camera_of(gt.shape[2],
                                                        gt.shape[1]),
                 torch.as_tensor(gt), iteration, torch.zeros(3))
    if shard:
        state, opt = gp.unshard_state(ts.gaussians, ts.opt, grid)
        ts = dataclasses.replace(ts, gaussians=state, opt=opt)
    return step_arrays(ts, m)


def band_worker(rank, n, cloud):
    """A 64x32 sharded render and its backward → (image sum, this rank's
    sum of the gradient of A)."""
    import torch.distributed as dist

    from gs2d_torch.parallel.data_parallel import rasterize_sharded
    pre = preprocessed(cloud, 64, 32)
    A = pre.A.detach().requires_grad_()
    out, _ = rasterize_sharded(pre._replace(A=A), 64, 32, dist.group.WORLD)
    out.sum().backward()
    return float(out.detach().sum()), float(A.grad.sum())


def parallel_worker(rank, n, cloud, odd_cloud, fields, gt):
    """tests/test_torch_parallel.py's ranks: the sharded render at 128x128
    and at 120 rows, the data-parallel step and the (gauss=2, data=2)
    step."""
    import torch.distributed as dist

    from gs2d_torch.parallel import gaussian_parallel as gp
    from gs2d_torch.parallel.data_parallel import rasterize_sharded
    from gs2d_torch.train.optim import init_adam
    out = {}
    for key, cl, h in (("render", cloud, 128), ("odd", odd_cloud, 120)):
        img, aux = rasterize_sharded(preprocessed(cl, 128, h), 128, h,
                                     dist.group.WORLD)
        out[key] = img.detach().numpy()
        out[key + "_pairs"] = (aux["num_pairs"], aux["max_band_pairs"])
    out["dp"] = one_step(fields, gt, 4000, group=dist.group.WORLD)
    grid = gp.make_grid(2, n // 2)
    out["gauss"] = one_step(fields, gt, 4000, grid=grid, shard=True)
    out["coords"] = grid.coords()
    state = state_of(fields)
    out["shard_rows"] = gp.shard_state(state, init_adam(state.params),
                                       grid)[0].params.xyz.shape[0]
    return out


def multihost_worker(rank, n, gt, fields, step_gt):
    """tests/test_torch_multihost.py's ranks: this rank's rows, the view
    assembled from every rank's band, and one data-parallel step fed the
    band-assembled view against the same step fed the whole view."""
    import torch
    import torch.distributed as dist

    from gs2d_torch.parallel import multihost as mh
    h = gt.shape[1]
    r0, r1 = mh.local_row_range(h)
    whole = mh.global_gt_from_local_rows(torch.as_tensor(gt[:, r0:r1]), h)
    g = dist.group.WORLD
    hs = step_gt.shape[1]
    s0, s1 = mh.local_row_range(hs, g)
    banded = mh.global_gt_from_local_rows(
        torch.as_tensor(step_gt[:, s0:s1]), hs, g).numpy()
    return {"rows": (r0, r1), "gt": whole.numpy(),
            "main": mh.is_main_process(),
            "shard": mh.local_camera_shard(list(range(11))),
            "whole": one_step(fields, step_gt, 1, group=g),
            "banded": one_step(fields, banded, 1, group=g)}


def ckpt_state_of(fields):
    """A port (GaussianState, AdamState) from the NumPy fields of a JAX
    state and its moments: ``p.*``, ``mu.*``, ``nu.*``, ``active``,
    ``active_sh_degree``, the three statistics and ``opt_step``; only the
    active rows are kept."""
    import numpy as np
    import torch

    from gs2d_torch.models.gaussians import GaussianParams, state_from_numpy
    from gs2d_torch.train.optim import FIELDS, AdamState
    act = fields["active"]
    state = state_from_numpy(
        **{f: fields[f"p.{f}"] for f in FIELDS}, active=act,
        active_sh_degree=fields["active_sh_degree"],
        **{f: fields[f] for f in ("max_radii2d", "grad_accum", "denom")},
        device="cpu")

    def tree(prefix):
        return GaussianParams(**{f: torch.as_tensor(np.ascontiguousarray(
            fields[f"{prefix}.{f}"][act])) for f in FIELDS})

    return state, AdamState(mu=tree("mu"), nu=tree("nu"),
                            step=int(fields["opt_step"]))


def ckpt_arrays(state, opt, iteration, spatial_lr_scale) -> dict:
    """A loaded checkpoint as NumPy arrays under the npz keys."""
    from gs2d_torch.train.optim import FIELDS
    out = {f"{name}.{f}": getattr(tree, f).numpy().copy()
           for name, tree in (("p", state.params), ("mu", opt.mu),
                              ("nu", opt.nu)) for f in FIELDS}
    out.update({f: getattr(state, f).numpy().copy()
                for f in ("max_radii2d", "grad_accum", "denom")})
    out.update(active_sh_degree=state.active_sh_degree, opt_step=opt.step,
               iteration=iteration, spatial_lr_scale=spatial_lr_scale)
    return out


def ckpt_worker(rank, n, fields, path, save_grid, load_grid, iterations):
    """tests/test_torch_checkpoint_sharded.py's ranks: this rank's shard
    of the state on a ``save_grid`` (gauss, data) grid saved at each of
    ``iterations`` in turn (none when ``save_grid`` is None), then the
    checkpoint loaded onto a ``load_grid`` grid → this rank's coordinates
    on it and its rows as NumPy arrays."""
    from gs2d_torch.models.io import (load_checkpoint_sharded,
                                      save_checkpoint_sharded)
    from gs2d_torch.parallel import gaussian_parallel as gp
    if save_grid is not None:
        grid = gp.make_grid(*save_grid)
        state, opt = gp.shard_state(*ckpt_state_of(fields), grid)
        for it in iterations:
            save_checkpoint_sharded(path, state, opt, it, 2.5, grid=grid)
    grid = gp.make_grid(*load_grid)
    loaded = load_checkpoint_sharded(path, grid=grid, device="cpu")
    return {"coords": grid.coords(), "rows": ckpt_arrays(*loaded)}
