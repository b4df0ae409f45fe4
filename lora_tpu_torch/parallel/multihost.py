"""Process-group set-up and per-rank data placement (port of
lora_tpu/parallel/multihost.py).

lora_tpu wires its hosts into one global device set with
jax.distributed; here every rank is one process with one device, wired by
torch.distributed.init_process_group.  Each rank feeds its own time shard
(`local_time_range`), so capture data never crosses between ranks in raw
form: only the halo edges, the corner turn and the reduced metrics do.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import cplx
from .mesh import DIMS, Mesh, make_mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None) -> None:
    """dist.init_process_group: NCCL for the card (device=None), gloo for
    device="cpu" or when asked.  coordinator is a "tcp://host:port" or
    "file://path" store, or "host:port"; without it the environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) is read.  A no-op when the
    group is already up.  On the card the rank takes device
    rank % device_count: ranks beyond the cards share them (gloo only)."""
    if dist.is_initialized():
        return
    dev = cplx.resolve_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    kw = {}
    if coordinator is not None:
        if "://" not in coordinator:
            coordinator = "tcp://" + coordinator
        kw = dict(init_method=coordinator, world_size=num_processes,
                  rank=process_id)
    if dev.type == "cuda":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)


def global_mesh(time: int | None = None, device=None) -> Mesh:
    """The ('time', 'channel') mesh over every rank.  By default one time
    shard per host: LOCAL_WORLD_SIZE ranks a host (torchrun sets it; 1
    when unset), each host ingesting a contiguous capture slice whose
    channel work its ranks split."""
    if time is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        time = world // int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return make_mesh(time=time, device=device)


def local_time_range(mesh: Mesh, T_global: int) -> tuple[int, int]:
    """[start, end) of the capture slice this rank must provide: its time
    shard."""
    n_time = mesh.shape["time"]
    if T_global % n_time:
        raise ValueError(f"T={T_global} not divisible by time axis {n_time}")
    t_local = T_global // n_time
    t = mesh.coord["time"]
    return t * t_local, (t + 1) * t_local


def host_array(global_shape, local_np, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of a global array, from host data on this rank, put
    on the mesh's device (the counterpart of
    jax.make_array_from_process_local_data).

    spec names, for each leading axis, the mesh dims it is split over (None,
    a dim name or a tuple of names, the first major; e.g. ("channel",
    "time") for a stream bank, (("time", "channel"),) for a channel bank).
    Along a split axis local_np holds either the whole global extent (the
    rank takes its block) or the rank's block already; along any other axis
    the whole extent."""
    a = np.asarray(local_np)
    idx = []
    for ax, dims in enumerate(spec):
        dims = (dims,) if isinstance(dims, str) else tuple(dims or ())
        n, i = 1, 0
        for d in dims:
            if d not in DIMS:
                raise ValueError(f"unknown mesh dim {d!r}")
            n, i = n * mesh.shape[d], i * mesh.shape[d] + mesh.coord[d]
        g = global_shape[ax]
        if g % n:
            raise ValueError(f"axis {ax} of length {g} not divisible by {n}")
        b = g // n
        if a.shape[ax] == g:
            idx.append(slice(i * b, (i + 1) * b))
        elif a.shape[ax] == b:
            idx.append(slice(None))
        else:
            raise ValueError(f"axis {ax}: local extent {a.shape[ax]} is "
                             f"neither the global {g} nor the block {b}")
    return cplx.as_tensor(a[tuple(idx)], mesh.device)
