"""The port's per-shard checkpoint (``gs2d_torch.models.io.
save_checkpoint_sharded`` / ``load_checkpoint_sharded``, on
``torch.distributed.checkpoint``) on 4, 2 and 1 gloo ranks, against the
npz checkpoint of the port and the JAX package's orbax checkpoint of the
same state.

The state is a seeded JAX ``init_from_pcd`` state with capacity padding
(42 live rows of 64, as tests/test_resume.py:74-78 builds one), non-zero
Adam moments and densification statistics, carried into the port through
``state_from_numpy``. 42 rows split 11/11/10/10 over 4 shards
(``shard_bounds``), where DTensor's ``Shard(0)`` (``torch.chunk``) would
place 11/11/11/9, so the row offsets are checked against ``shard_bounds``
directly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from gs2d_torch.models.io import (load_checkpoint, load_checkpoint_sharded,
                                  save_checkpoint, save_checkpoint_sharded)
from gs2d_torch.parallel.gaussian_parallel import shard_bounds
from gs2d_torch.train.optim import FIELDS
from gs2d_tpu.models.gaussians import init_from_pcd
from gs2d_tpu.train.optim import AdamState as JAdamState

from .test_torch_dist_common import (ckpt_arrays, ckpt_state_of, ckpt_worker,
                                     start_ranks)

N_LIVE, CAPACITY = 42, 64
STATS = ("max_radii2d", "grad_accum", "denom")
ITERATION, SLR = 123, 2.5


def _jax_state():
    """The seeded JAX (GaussianState, AdamState) with non-zero moments and
    statistics."""
    rng = np.random.default_rng(0)
    state = init_from_pcd(rng.random((N_LIVE, 3)).astype(np.float32),
                          rng.random((N_LIVE, 3)).astype(np.float32),
                          CAPACITY)
    state = dataclasses.replace(
        state, active_sh_degree=jnp.int32(2),
        **{f: jnp.asarray(rng.random(CAPACITY).astype(np.float32))
           for f in STATS})

    def moments():
        return jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), state.params)

    return state, JAdamState(mu=moments(), nu=moments(), step=jnp.int32(17))


def _fields(js, jo) -> dict:
    fields = {f"{name}.{f}": np.asarray(getattr(tree, f))
              for name, tree in (("p", js.params), ("mu", jo.mu),
                                 ("nu", jo.nu)) for f in FIELDS}
    fields.update({f: np.asarray(getattr(js, f)) for f in STATS})
    fields.update(active=np.asarray(js.active),
                  active_sh_degree=np.asarray(js.active_sh_degree),
                  opt_step=np.asarray(jo.step))
    return fields


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The state saved by 4 ranks on a (4, 1) grid and loaded back on the
    same grid."""
    fields = _fields(*_jax_state())
    path = str(tmp_path_factory.mktemp("ckpt") / "grid4")
    ranks = start_ranks(ckpt_worker, 4, fields, path, (4, 1), (4, 1),
                        [ITERATION]).results()
    whole = ckpt_arrays(*ckpt_state_of(fields), ITERATION, SLR)
    return fields, path, ranks, whole


def _assert_rows(got, whole, r0, r1):
    """``got`` holds exactly rows [r0, r1) of ``whole``, bit for bit, and
    its scalars."""
    for k, v in whole.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v[r0:r1], err_msg=k)
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def _files_by_key(path) -> dict:
    """Stored key → the data file that holds it."""
    meta = dcp.FileSystemReader(path).read_metadata()
    return {idx.fqn: info.relative_path
            for idx, info in meta.storage_data.items()}


def test_sharded_checkpoint_on_the_writing_grid(saved):
    """Each of 4 ranks writes its own rows, and only those, to its own
    file (no gather), at the offsets of shard_bounds; loading on the same
    grid gives each rank exactly its rows, bit for bit."""
    _, path, ranks, whole = saved
    bounds = shard_bounds(N_LIVE, 4)
    assert [r["coords"] for r in ranks] == [(g, 0) for g in range(4)]
    for g, r in enumerate(ranks):
        _assert_rows(r["rows"], whole, *bounds[g])
    files = _files_by_key(path)
    row_keys = [k for k in files if "@" in k]
    assert len(row_keys) == 4 * (3 * len(FIELDS) + len(STATS))
    for g, (r0, r1) in enumerate(bounds):
        mine = {k for k in row_keys if k.endswith(f"@{r0}:{r1}")}
        assert len(mine) == 3 * len(FIELDS) + len(STATS)
        assert {files[k] for k in mine} == {f"__{g}_0.distcp"}
    for k in ("active_sh_degree", "opt_step", "iteration",
              "spatial_lr_scale"):
        assert files[k] == "__0_0.distcp"


def test_sharded_checkpoint_loads_onto_two_ranks(saved):
    """A checkpoint written by 4 shards restores onto a (2, 1) grid: each
    rank gets exactly its rows of the 2-shard split."""
    fields, path, _, whole = saved
    ranks = start_ranks(ckpt_worker, 2, fields, path, None, (2, 1),
                        []).results()
    for g, r in enumerate(ranks):
        assert r["coords"] == (g, 0)
        _assert_rows(r["rows"], whole, *shard_bounds(N_LIVE, 2)[g])


def test_sharded_checkpoint_loads_onto_one_process(saved):
    """With grid=None the whole state comes back in one process."""
    _, path, _, whole = saved
    got = ckpt_arrays(*load_checkpoint_sharded(path, device="cpu"))
    _assert_rows(got, whole, 0, N_LIVE)


def test_sharded_checkpoint_2x2_grid_writes_each_shard_once(tmp_path):
    """On a (2, 2) grid the ranks at d = 0 write the two shards and the
    ranks at d = 1, which hold the same rows, write nothing; every rank
    loads its shard back."""
    fields = _fields(*_jax_state())
    path = str(tmp_path / "grid2x2")
    ranks = start_ranks(ckpt_worker, 4, fields, path, (2, 2), (2, 2),
                        [ITERATION]).results()
    whole = ckpt_arrays(*ckpt_state_of(fields), ITERATION, SLR)
    bounds = shard_bounds(N_LIVE, 2)
    for rank, r in enumerate(ranks):
        assert r["coords"] == (rank // 2, rank % 2)
        _assert_rows(r["rows"], whole, *bounds[rank // 2])
    files = _files_by_key(path)
    row_keys = [k for k in files if "@" in k]
    assert len(row_keys) == 2 * (3 * len(FIELDS) + len(STATS))
    for g, (r0, r1) in enumerate(bounds):
        mine = {k for k in row_keys if k.endswith(f"@{r0}:{r1}")}
        assert {files[k] for k in mine} == {f"__{2 * g}_0.distcp"}


def test_sharded_checkpoint_overwrites(tmp_path):
    """A second save at the same path replaces the first (iteration 123 →
    124), from the 4 ranks and from one process; a load returns the
    second. A directory there that is not a checkpoint is not replaced."""
    fields = _fields(*_jax_state())
    path = str(tmp_path / "again")
    ranks = start_ranks(ckpt_worker, 4, fields, path, (4, 1), (4, 1),
                        [ITERATION, ITERATION + 1]).results()
    assert [r["rows"]["iteration"] for r in ranks] == [ITERATION + 1] * 4
    state, opt = ckpt_state_of(fields)
    save_checkpoint_sharded(path, state, opt, ITERATION + 2, SLR)
    got = ckpt_arrays(*load_checkpoint_sharded(path, device="cpu"))
    _assert_rows(got, ckpt_arrays(state, opt, ITERATION + 2, SLR), 0,
                 N_LIVE)
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "keep.txt").write_text("x")
    with pytest.raises(ValueError, match="not a checkpoint"):
        save_checkpoint_sharded(str(tmp_path / "other"), state, opt, 1)
    assert (tmp_path / "other" / "keep.txt").read_text() == "x"


def test_sharded_checkpoint_equals_the_npz(saved, tmp_path):
    """Key for key and dtype for dtype, the sharded checkpoint holds what
    save_checkpoint's npz holds for the same state, but for ``active``;
    both load into the same state."""
    fields, path, _, _ = saved
    state, opt = ckpt_state_of(fields)
    npz = str(tmp_path / "ck.npz")
    save_checkpoint(npz, state, opt, ITERATION, SLR)
    got = ckpt_arrays(*load_checkpoint_sharded(path, device="cpu"))
    stored = {k.split("@")[0] for k in _files_by_key(path)}
    with np.load(npz) as z:
        assert stored == set(z.files) - {"active"}
        for k in stored:
            np.testing.assert_array_equal(np.asarray(got[k]), z[k],
                                          err_msg=k)
            assert np.asarray(got[k]).dtype == z[k].dtype or \
                np.ndim(z[k]) == 0, k
        for k, dtype in (("active_sh_degree", np.int32),
                         ("opt_step", np.int32), ("iteration", np.int64),
                         ("spatial_lr_scale", np.float64)):
            assert z[k].dtype == dtype, k
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    assert (meta["active_sh_degree"].properties.dtype,
            meta["opt_step"].properties.dtype,
            meta["iteration"].properties.dtype,
            meta["spatial_lr_scale"].properties.dtype) == (
        torch.int32, torch.int32, torch.int64, torch.float64)
    _assert_rows(got, ckpt_arrays(*load_checkpoint(npz, device="cpu")), 0,
                 N_LIVE)


def test_sharded_checkpoint_equals_the_jax_orbax_checkpoint(saved,
                                                            tmp_path):
    """The JAX package's orbax checkpoint of the same state, restored and
    cut to its active rows, holds what the port's sharded one holds."""
    pytest.importorskip("orbax.checkpoint")
    from gs2d_tpu.models.io import (load_checkpoint_orbax,
                                    save_checkpoint_orbax)
    _, path, _, _ = saved
    js, jo = _jax_state()
    opath = str(tmp_path / "orbax")
    save_checkpoint_orbax(opath, js, jo, ITERATION, SLR)
    rs, ro, it, slr = load_checkpoint_orbax(opath)
    act = np.asarray(rs.active)
    assert int(act.sum()) == N_LIVE
    ref = {f"{name}.{f}": np.asarray(getattr(tree, f))[act]
           for name, tree in (("p", rs.params), ("mu", ro.mu),
                              ("nu", ro.nu)) for f in FIELDS}
    ref.update({f: np.asarray(getattr(rs, f))[act] for f in STATS})
    ref.update(active_sh_degree=int(rs.active_sh_degree),
               opt_step=int(ro.step), iteration=it, spatial_lr_scale=slr)
    _assert_rows(ckpt_arrays(*load_checkpoint_sharded(path, device="cpu")),
                 ref, 0, N_LIVE)
