"""Multi-process bring-up and rank-local data placement.

Counterpart of ``gs2d_tpu/parallel/multihost.py`` on ``torch.distributed``:

* ``initialize_distributed`` calls ``init_process_group`` (NCCL for ranks
  on the card, gloo on the CPU). With no arguments it runs only where a
  launcher marked the process as one of several (torchrun's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), so single-process
  CLIs may call it unconditionally; explicit arguments force it, and a
  failure propagates: a mis-launched job fails, it does not train alone.
* every rank is one process and one device, ``cuda:LOCAL_RANK``;
* ground truth: a rank may load only its own row band of a view
  (``local_row_range``, its band of ``band_rows``), and
  ``global_gt_from_local_rows`` assembles the view on every rank, since
  each rank computes the whole image's loss (``train/step.py``);
* SPMD rule: every rank runs the same steps on the same seeded camera
  order; only side effects (files, the viewer, stdout, TensorBoard) are
  gated by ``is_main_process``;
* ``local_camera_shard``: a round-robin split of cameras or scenes for
  sweeps of one scene per process; the training path shards pixels.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Tuple

import torch
import torch.distributed as dist

from ..ops.rasterize.common import TILE_H, cdiv

# environment variables a launcher sets for one process of several
# (torchrun and torch.distributed's env:// rendezvous)
_LAUNCHER_ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a rank that stops answering a collective fails the others after this
TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` on the card, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank())
    return torch.device(device_type)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None) -> bool:
    """Join the process group. Returns True when running multi-process.

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://``);
    without it the rendezvous is ``env://`` (the launcher's variables).
    ``backend`` defaults to NCCL where CUDA is available, else gloo; with
    NCCL the rank's device is set to ``cuda:LOCAL_RANK`` first. A second
    call returns without joining again."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if not explicit and not any(v in os.environ for v in _LAUNCHER_ENV_VARS):
        return False
    if backend is None:
        backend = default_backend(
            "cuda" if torch.cuda.is_available() else "cpu")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    # -1: the rendezvous (env://) names them
    dist.init_process_group(
        backend=backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=TIMEOUT)
    return dist.get_world_size() > 1


def rank_and_size(group=None):
    """(rank, world size) in ``group``; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_main_process() -> bool:
    return rank_and_size()[0] == 0


def band_rows(height: int, n: int) -> List[Tuple[int, int]]:
    """[y0, y1) of each of ``n`` row bands: cdiv(cdiv(height, n), TILE_H)
    tiles each, the last one shorter (1080 rows over 4 ranks are
    272/272/272/264). Every band must hold a row."""
    hb = cdiv(cdiv(height, n), TILE_H) * TILE_H
    bands = [(i * hb, min(height, (i + 1) * hb)) for i in range(n)]
    if bands[-1][0] >= height:
        raise ValueError(f"an image of {height} rows gives no band to some "
                         f"of {n} ranks ({hb}-row bands)")
    return bands


def gather_bands(band: torch.Tensor, bands, group=None) -> torch.Tensor:
    """Each rank's (C, rows, W) band → the (C, height, W) image on every
    rank: one all-gather of the bands, padded to the tallest."""
    hb = bands[0][1] - bands[0][0]
    padded = band.new_zeros((band.shape[0], hb, band.shape[2]))
    padded[:, :band.shape[1]] = band
    parts = [torch.empty_like(padded) for _ in bands]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:, :y1 - y0] for p, (y0, y1) in zip(parts, bands)],
                     dim=1)


def local_row_range(height: int, group=None) -> Tuple[int, int]:
    """[row0, row1) of a (C, height, W) view that this rank renders and
    may load: its band of ``band_rows``."""
    rank, n = rank_and_size(group)
    return band_rows(height, n)[rank]


def global_gt_from_local_rows(local_band: torch.Tensor, height: int,
                              group=None) -> torch.Tensor:
    """The whole (C, height, W) view on every rank from each rank's band
    ((C, rows, W), rows per ``local_row_range``)."""
    rank, n = rank_and_size(group)
    bands = band_rows(height, n)
    if local_band.shape[1] != bands[rank][1] - bands[rank][0]:
        raise ValueError(f"rank {rank} holds {local_band.shape[1]} rows, "
                         f"its band is {bands[rank]}")
    if not dist.is_initialized():
        return local_band.contiguous()
    return gather_bands(local_band, bands, group)


def local_camera_shard(cameras, num_shards=None, shard_id=None):
    """Round-robin split for scene-level sweeps (one scene per process, the
    reference's ``run_all.sh`` pattern). Defaults to the process group."""
    rank, n = rank_and_size()
    n = n if num_shards is None else num_shards
    i = rank if shard_id is None else shard_id
    return [c for k, c in enumerate(cameras) if k % n == i]
