"""The ('time', 'channel') mesh of ranks and the channel-bank sharding
(port of lora_tpu/parallel/mesh.py).

lora_tpu is single-controller: it takes a global array with a
NamedSharding and runs one program over the mesh.  torch.distributed is
multi-controller, so the port keeps one rule: every function takes the
rank's local shard and returns the rank's local result, and
`gather_result` builds the global view that lora_tpu returns.

Two mesh dims, as in lora_tpu:

  channel  the channel bank, embarrassingly parallel (DP analogue)
  time     overlap-save time shards of one capture (SP analogue, halo.py)

With a process group the mesh is a torch DeviceMesh over the whole world,
rank r at (time r // channel, channel r % channel).  Without one it is the
one-rank mesh on one device, and every collective is the identity
(comm.py).  `aggregate_metrics` reduces with one all_reduce, the port's
counterpart of the reference's async error/power/snr/dropped signals.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import LoRaConfig
from ..models.demodulator import DemodResult, demodulate
from ..models.decoder import OK
from ..ops import cplx
from . import comm

DIMS = ("time", "channel")


class Mesh:
    """The ranks' ('time', 'channel') layout, this rank's place in it and
    its device.  `dm` is the torch DeviceMesh, None for the one-rank mesh
    without a process group."""

    def __init__(self, time: int, channel: int, device, dm=None):
        self.shape = {"time": time, "channel": channel}
        self.device = torch.device(device)
        self.dm = dm
        coord = dm.get_coordinate() if dm is not None else (0, 0)
        self.coord = dict(zip(DIMS, coord))
        self.rank = self.coord["time"] * channel + self.coord["channel"]

    @property
    def size(self) -> int:
        return self.shape["time"] * self.shape["channel"]

    def group(self, dim: str | None = None):
        """The process group of `dim` through this rank (the whole mesh for
        None), or None without a process group."""
        if self.dm is None:
            return None
        return dist.group.WORLD if dim is None else self.dm.get_group(dim)


def _device(device) -> torch.device:
    dev = cplx.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(channel: int = 0, time: int = 1, device=None) -> Mesh:
    """Build the ('time', 'channel') mesh over every rank of the process
    group, or the one-rank mesh without one.  channel=0 means all remaining
    ranks on the channel dim.  device=None means the card."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if channel == 0:
        if n % time:
            raise ValueError(f"{n} devices not divisible by time={time}")
        channel = n // time
    if time * channel != n:
        raise ValueError(f"mesh {time}x{channel} != {n} devices")
    dev = _device(device)
    if not dist.is_initialized():
        return Mesh(1, 1, dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (time, channel), mesh_dim_names=DIMS)
    return Mesh(time, channel, dev, dm)


def channel_sharding(mesh: Mesh, B: int) -> slice:
    """This rank's rows of a [B, ...] channel bank split over every rank of
    the mesh, the time dim folded in (a pure channel bank uses all
    devices)."""
    if B % mesh.size:
        raise ValueError(f"B={B} not divisible by the {mesh.size} devices")
    b = B // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_demodulate(x_local, cfg: LoRaConfig, mesh: Mesh,
                     debug: bool = False, max_frames: int = 1,
                     spectra: bool = False) -> DemodResult:
    """Demodulate this rank's rows of a channel bank (channel_sharding).
    Every channel is independent, so no collective runs; gather_result
    gives the whole bank's result.  spectra=True carries the payload
    |FFT|^2 windows for decode_soft."""
    return demodulate(x_local, cfg, debug=debug, max_frames=max_frames,
                      spectra=spectra, device=mesh.device)


def _spec(axis) -> tuple:
    if axis == "channel":
        return (DIMS,)
    if axis == "time":
        return DIMS
    return tuple(axis)


def gather(tensors: list[torch.Tensor], mesh: Mesh, spec) -> list:
    """The global tensors of every rank's local blocks, in one all_gather.

    spec gives, for each leading axis of a block, the mesh dims it is split
    over: None (not split), a dim name, or a tuple of names (the first
    major).  Blocks of ranks that differ only in dims the spec does not name
    are copies; one of them is taken."""
    group = mesh.group()
    if group is None:
        return list(tensors)
    spec = [(d,) if isinstance(d, str) else tuple(d or ()) for d in spec]
    packed = torch.cat([comm.as_bytes(t) for t in tensors])
    blocks = comm.all_gather(packed, group)
    C = mesh.shape["channel"]
    out = [t.new_empty(tuple(n * _count(mesh, s) for n, s in
                             zip(t.shape, spec)) + tuple(t.shape[len(spec):]))
           for t in tensors]
    for r, blk in enumerate(blocks):
        coord = {"time": r // C, "channel": r % C}
        at = 0
        for t, o in zip(tensors, out):
            nb = t.numel() * t.element_size()
            part = comm.from_bytes(blk[at : at + nb], t.dtype, t.shape)
            at += nb
            idx = tuple(slice(_index(mesh, coord, s) * n,
                              (_index(mesh, coord, s) + 1) * n)
                        for n, s in zip(t.shape, spec))
            o[idx] = part
    return out


def _count(mesh: Mesh, dims) -> int:
    n = 1
    for d in dims:
        n *= mesh.shape[d]
    return n


def _index(mesh: Mesh, coord: dict, dims) -> int:
    i = 0
    for d in dims:
        i = i * mesh.shape[d] + coord[d]
    return i


def gather_result(res, mesh: Mesh, axis="channel"):
    """The global view of a local result (a DemodResult, or any dataclass of
    tensors such as a DecodeResult): every field gathered over the mesh in
    one all_gather, None fields left None.

    axis="channel": the rows are this rank's channel_sharding block (as
    shard_demodulate gives them) -> [B, ...].  axis="time": the result is
    one time shard's frame slots over this rank's channel block (as
    demodulate_stream gives them) -> [time, B, ...], lora_tpu's layout.
    A tuple is a spec for gather() (e.g. ("channel", "time") for the
    [B, K] channels of channelize_stream's corner turn)."""
    names = [f.name for f in dataclasses.fields(res)
             if getattr(res, f.name) is not None]
    local = [getattr(res, k) for k in names]
    if axis == "time":
        local = [t[None] for t in local]
    full = gather(local, mesh, _spec(axis))
    return dataclasses.replace(res, **dict(zip(names, full)))


def aggregate_metrics(dem: DemodResult, statuses=None, mesh: Mesh | None = None
                      ) -> dict:
    """Health report over a channel bank sharded over the mesh: this rank's
    sums, one all_reduce, then the means (lora_tpu/parallel/mesh.py:85).
    Counts equal the whole bank's exactly; the means are float32 sums in
    another order.  0-d tensors on the result's device: frames, synced,
    mean_snr_db, mean_power_db, mean_cfo_bins, symbols and, given the decode
    statuses, decoded_ok and dropped among the synced frames."""
    found = dem.found
    dev = found.device
    f32 = torch.float32

    def masked_sum(v):
        return torch.where(found, v.to(f32), 0.0).sum()

    sums = [found.sum(), torch.tensor(found.numel(), device=dev),
            dem.count.sum(), masked_sum(dem.snr), masked_sum(dem.power),
            masked_sum(dem.freq_error)]
    if statuses is not None:
        ok = torch.as_tensor(statuses, device=dev) == OK
        sums += [(found & ok).sum(), (found & ~ok).sum()]
    total = torch.stack([s.to(torch.float64) for s in sums])
    group = mesh.group() if mesh is not None else None
    total = comm.all_reduce_sum(total, group)
    i32 = lambda k: total[k].to(torch.int32)
    denom = torch.clamp(i32(0), min=1).to(f32)
    out = {
        "frames": i32(1),
        "synced": i32(0),
        "mean_snr_db": total[3].to(f32) / denom,
        "mean_power_db": total[4].to(f32) / denom,
        "mean_cfo_bins": total[5].to(f32) / denom,
        "symbols": i32(2),
    }
    if statuses is not None:
        out["decoded_ok"] = i32(6)
        out["dropped"] = i32(7)
    return out
