"""Model IO (``gs2d_tpu/models/io.py``).

(a) PLY snapshots with the exact 3DGS attribute schema (reference
    ``scene/gaussian_model.py:176-255``), so a model ``train.py`` writes
    renders here;
(b) the full training state — parameters, Adam moments, densification
    statistics, step — as an npz in the JAX package's key schema, so a
    JAX checkpoint resumes in the port and a port checkpoint in the JAX
    package;
(c) the same content written per shard, without a gather, on
    ``torch.distributed.checkpoint`` (``save_checkpoint_sharded`` /
    ``load_checkpoint_sharded``: the counterparts of the JAX package's
    orbax checkpoint, for state sharded over a (gauss, data) grid).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.gaussian_parallel import Grid, _shard_sizes, shard_bounds
from ..parallel.multihost import rank_and_size
from ..scene.ply import read_ply, write_ply
from ..train.optim import FIELDS, AdamState
from .gaussians import GaussianParams, GaussianState, state_from_numpy


def save_ply(state: GaussianState, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    p = {f: getattr(state.params, f).detach().cpu().numpy()
         for f in ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity")}
    n = p["xyz"].shape[0]
    cols = {"x": p["xyz"][:, 0], "y": p["xyz"][:, 1], "z": p["xyz"][:, 2],
            "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n)}
    # features are stored channel-major flattened like the reference
    # (transpose(1,2).flatten → channel varies slower than coefficient)
    fdc = p["features_dc"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(fdc.shape[1]):
        cols[f"f_dc_{i}"] = fdc[:, i]
    frest = p["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(frest.shape[1]):
        cols[f"f_rest_{i}"] = frest[:, i]
    cols["opacity"] = p["opacity"][:, 0]
    for i in range(p["scaling"].shape[1]):
        cols[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(p["rotation"].shape[1]):
        cols[f"rot_{i}"] = p["rotation"][:, i]
    write_ply(path, cols)


def load_ply(path: str, max_sh_degree: int = 3,
             device="cuda") -> GaussianState:
    cols = read_ply(path)
    n = len(cols["x"])
    K = (max_sh_degree + 1) ** 2

    def grab(prefix, count):
        names = sorted((k for k in cols if k.startswith(prefix)),
                       key=lambda s: int(s.rsplit("_", 1)[1]))
        if len(names) != count:
            raise ValueError(f"{path}: {len(names)} '{prefix}*' columns, "
                             f"expected {count} for SH degree "
                             f"{max_sh_degree}")
        return np.stack([cols[k] for k in names], -1)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    fdc = grab("f_dc_", 3).reshape(n, 3, 1).transpose(0, 2, 1)
    frest = grab("f_rest_", 3 * (K - 1)).reshape(n, 3, K - 1) \
        .transpose(0, 2, 1)
    params = GaussianParams(
        xyz=dev(np.stack([cols["x"], cols["y"], cols["z"]], -1)),
        features_dc=dev(fdc), features_rest=dev(frest),
        scaling=dev(grab("scale_", 2)), rotation=dev(grab("rot_", 4)),
        opacity=dev(cols["opacity"][:, None]))
    # a loaded model renders at its full degree (reference load_ply:255)
    return GaussianState(params=params, active_sh_degree=max_sh_degree)


def save_checkpoint(path: str, state: GaussianState, opt: AdamState,
                    iteration: int, spatial_lr_scale: float = 1.0) -> None:
    """Write the training state in the JAX npz schema
    (``gs2d_tpu/models/io.py:94-110``): ``p.*``, ``mu.*``, ``nu.*`` per
    parameter field, ``active`` (all true: the port holds only live
    rows), ``active_sh_degree``, the three statistics, ``opt_step``,
    ``iteration`` and ``spatial_lr_scale``. The arrays are stored
    uncompressed; ``np.load`` reads both forms."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def host(x):
        return x.detach().cpu().numpy()

    flat = {f"{name}.{f}": host(getattr(tree, f))
            for name, tree in (("p", state.params), ("mu", opt.mu),
                               ("nu", opt.nu)) for f in FIELDS}
    n = state.params.xyz.shape[0]
    np.savez(path, **flat,
             active=np.ones(n, bool),
             active_sh_degree=np.int32(state.active_sh_degree),
             max_radii2d=host(state.max_radii2d),
             grad_accum=host(state.grad_accum),
             denom=host(state.denom),
             opt_step=np.int32(opt.step),
             iteration=np.int64(iteration),
             spatial_lr_scale=np.float64(spatial_lr_scale))


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[GaussianState, AdamState, int, float]:
    """Read a checkpoint of either package → (state, Adam state,
    iteration, spatial_lr_scale) on ``device``. Only the rows marked
    ``active`` are kept (a JAX checkpoint holds capacity padding)."""
    with np.load(path) as z:
        act = z["active"]
        state = state_from_numpy(
            **{f: z[f"p.{f}"] for f in FIELDS}, active=act,
            active_sh_degree=z["active_sh_degree"],
            max_radii2d=z["max_radii2d"], grad_accum=z["grad_accum"],
            denom=z["denom"], device=device)

        def tree(prefix):
            return GaussianParams(**{
                f: torch.as_tensor(np.ascontiguousarray(
                    z[f"{prefix}.{f}"][act], np.float32), device=device)
                for f in FIELDS})

        opt = AdamState(mu=tree("mu"), nu=tree("nu"),
                        step=int(z["opt_step"]))
        return state, opt, int(z["iteration"]), float(z["spatial_lr_scale"])


# the per-Gaussian arrays of a sharded checkpoint are stored one key per
# source shard, "<npz key>@<r0>:<r1>" for its rows [r0, r1)
_ROWS_SEP = "@"
_STATS = ("max_radii2d", "grad_accum", "denom")


def _row_arrays(state: GaussianState, opt: AdamState) -> dict:
    """npz key → (rows, ...) tensor of every per-Gaussian array."""
    rows = {f"{name}.{f}": getattr(tree, f)
            for name, tree in (("p", state.params), ("mu", opt.mu),
                               ("nu", opt.nu)) for f in FIELDS}
    rows.update({f: getattr(state, f) for f in _STATS})
    return rows


def save_checkpoint_sharded(path: str, state: GaussianState, opt: AdamState,
                            iteration: int, spatial_lr_scale: float = 1.0,
                            grid: Optional[Grid] = None) -> None:
    """Write the training state per shard, with no gather to one rank: the
    counterpart of ``save_checkpoint_orbax`` (``gs2d_tpu/models/io.py:113``)
    on ``torch.distributed.checkpoint`` (a directory at ``path``).

    With a (gauss, data) ``grid`` every rank of ``grid.group`` calls it
    with its shard (``gaussian_parallel.shard_state``, or one densified
    since): the ranks at d = 0 each write their rows, at their offset
    among the shards in gauss order, of the parameters, both Adam moments
    and the three densification statistics; the ranks at d > 0 hold the
    same shards and write nothing. The first rank writes the scalars
    (``active_sh_degree``, ``opt_step``, ``iteration``,
    ``spatial_lr_scale``). With ``grid=None`` the state is whole on this
    process, which writes it alone. The content is ``save_checkpoint``'s,
    key for key and dtype for dtype, but for ``active`` (the port holds
    only live rows). A checkpoint already at ``path`` is replaced, as the
    JAX save's ``force=True``; a directory there that is not a checkpoint
    raises."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    rows = state.params.xyz.shape[0]
    if grid is None:
        r0, writes_rows, first = 0, True, True
    else:
        g, d = grid.coords()
        sizes = _shard_sizes(rows, state.params.xyz.device, grid.gauss_group)
        r0, writes_rows = sum(sizes[:g]), d == 0
        first = rank_and_size(grid.group)[0] == 0
    sd = {}
    if writes_rows:
        sd.update({f"{k}{_ROWS_SEP}{r0}:{r0 + rows}": v.detach()
                   for k, v in _row_arrays(state, opt).items()})
    if first:
        sd.update(active_sh_degree=torch.tensor(state.active_sh_degree,
                                                dtype=torch.int32),
                  opt_step=torch.tensor(opt.step, dtype=torch.int32),
                  iteration=torch.tensor(iteration, dtype=torch.int64),
                  spatial_lr_scale=torch.tensor(spatial_lr_scale,
                                                dtype=torch.float64))
        if os.path.isdir(path) and os.listdir(path):
            if not os.path.isfile(os.path.join(path, ".metadata")):
                raise ValueError(f"{path} holds files that are not a "
                                 "checkpoint; not replacing it")
            shutil.rmtree(path)
    if grid is not None:
        dist.barrier(group=grid.group)     # nobody writes before the rmtree
    dcp.save(sd, storage_writer=dcp.FileSystemWriter(path),
             process_group=None if grid is None else grid.group,
             no_dist=grid is None)


def load_checkpoint_sharded(path: str, grid: Optional[Grid] = None,
                            device="cuda"
                            ) -> Tuple[GaussianState, AdamState, int, float]:
    """Read a ``save_checkpoint_sharded`` directory → (state, Adam state,
    iteration, spatial_lr_scale) on ``device``: the counterpart of
    ``load_checkpoint_orbax`` (``gs2d_tpu/models/io.py:144``).

    With a (gauss, data) ``grid`` every rank of ``grid.group`` calls it
    and gets exactly its rows ``shard_bounds(N, grid.gauss)[g]``, reading
    only the written pieces that overlap them; the grid need not be the
    one that wrote the checkpoint. With ``grid=None`` this process reads
    the whole state alone. Tensors written from the card load onto the
    CPU and the other way round."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    pieces = {}                            # npz key → [(r0, r1, stored key)]
    for key in meta:
        if _ROWS_SEP in key:
            name, span = key.split(_ROWS_SEP)
            r0, r1 = (int(x) for x in span.split(":"))
            pieces.setdefault(name, []).append((r0, r1, key))
    n = max(r1 for _, r1, _ in pieces["p.xyz"])
    a, b = (0, n) if grid is None else \
        shard_bounds(n, grid.gauss)[grid.coords()[0]]
    wanted = {name: sorted(p for p in ps if p[0] < b and p[1] > a)
              for name, ps in pieces.items()}
    sd = {key: torch.empty(tuple(meta[key].size),
                           dtype=meta[key].properties.dtype, device=device)
          for ps in wanted.values() for _, _, key in ps}
    sd.update({key: torch.empty((), dtype=meta[key].properties.dtype)
               for key in ("active_sh_degree", "opt_step", "iteration",
                           "spatial_lr_scale")})
    dcp.load(sd, storage_reader=reader,
             process_group=None if grid is None else grid.group,
             no_dist=grid is None)
    arr = {name: torch.cat([sd[key][max(a, r0) - r0:min(b, r1) - r0]
                            for r0, r1, key in ps])
           for name, ps in wanted.items()}

    def tree(prefix):
        return GaussianParams(**{f: arr[f"{prefix}.{f}"] for f in FIELDS})

    state = GaussianState(params=tree("p"),
                          active_sh_degree=int(sd["active_sh_degree"]),
                          **{f: arr[f] for f in _STATS})
    opt = AdamState(mu=tree("mu"), nu=tree("nu"), step=int(sd["opt_step"]))
    return (state, opt, int(sd["iteration"]),
            float(sd["spatial_lr_scale"]))
