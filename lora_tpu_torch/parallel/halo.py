"""Time-axis sharding with overlap-save halo exchange (port of
lora_tpu/parallel/halo.py).

A long capture is split into fixed blocks over the mesh's `time` dim; each
rank receives a left margin from its left neighbour and a right halo from
its right neighbour (comm.shift: an all_to_all_single that both NCCL and
gloo take for CUDA tensors) and runs the frame search on the extended
block.

Ownership rule: a frame belongs to the shard whose main region holds its
preamble start.  Both margins are multiples of N and every shard sees the
same samples on the same N-aligned window grid, so neighbouring shards
compute bit-identical detections shifted by exactly t_local: a frame that
straddles a boundary is claimed exactly once, with no reconciliation
collective.  The left margin covers the longest preamble run a frame can
present (10 preamble + 2 sync symbols); a frame starting within the margin
is detected here too but disowned, and claimed by its owner.
"""

from __future__ import annotations

import torch

from ..config import LoRaConfig
from ..models.demodulator import DemodResult, demodulate, required_samples
from ..ops import cplx
from . import comm
from .mesh import Mesh


def left_margin(cfg: LoRaConfig) -> int:
    """Samples of left-neighbour context: full preamble + sync + slack."""
    return (cfg.preamble_symbols + 2 + 2) * cfg.N


def halo_exchange(x: torch.Tensor, left: int, right: int, mesh: Mesh,
                  axis: str = "time", wrap: bool = False) -> torch.Tensor:
    """Extend this rank's block [..., T_local] to [..., left + T_local +
    right] with its neighbours' samples along the mesh dim `axis`: shard j's
    suffix goes to j+1 and its prefix to j-1.  With wrap=False (a linear
    capture) shard 0's left margin and the last shard's right halo are
    zeros.  On a one-shard axis the block's own edges wrap round.
    Requires left, right <= T_local."""
    t_local = x.shape[-1]
    if not (0 <= left <= t_local and 0 <= right <= t_local):
        raise ValueError(f"margins (left {left}, right {right}) must lie in "
                         f"[0, {t_local}], the local block")
    group = mesh.group(axis)
    recv_l = comm.shift(x[..., t_local - left:], group, 1)
    recv_r = comm.shift(x[..., :right], group, -1)
    idx = mesh.coord[axis]
    if not wrap:
        if idx == 0:
            recv_l = torch.zeros_like(recv_l)
        if idx == mesh.shape[axis] - 1:
            recv_r = torch.zeros_like(recv_r)
    return torch.cat([recv_l, x, recv_r], -1)


def demodulate_stream(x_local, cfg: LoRaConfig, mesh: Mesh,
                      halo: int | None = None,
                      max_frames: int = 1) -> DemodResult:
    """Demodulate this rank's block [B_local, t_local] of a bank of long
    captures (rows split over 'channel', time over 'time'; multihost.
    local_time_range gives the block).  Returns this time shard's frame
    slots: the frames whose preamble starts in its main region, t_sync and
    consumed in global sample coordinates, -1 and 0 where a slot is not
    owned; gather_result(..., axis="time") gives lora_tpu's [time, B, ...].
    max_frames > 1 adds the candidate axis after the batch axis.

    halo defaults to required_samples(cfg): enough to finish a frame whose
    preamble starts on the block's last sample."""
    if halo is None:
        halo = required_samples(cfg)
    x = cplx.as_iq(x_local, mesh.device)
    N = cfg.N
    L = left_margin(cfg)
    t_local = x.shape[-1]
    if t_local % N:
        raise ValueError(
            f"local block {t_local} must be a multiple of N={N} so all "
            "shards share one window grid")
    if max(halo, L) > t_local:
        raise ValueError(
            f"margins (left {L}, right {halo}) exceed local block {t_local};"
            " use fewer time shards")
    ext = halo_exchange(x, L, halo, mesh, "time")
    dem = demodulate(ext, cfg, max_frames=max_frames)
    start = dem.t_sync - cfg.preamble_symbols * N  # approx preamble start
    own = dem.found & (start >= L) & (start < L + t_local)
    t_off = mesh.coord["time"] * t_local - L
    return DemodResult(
        symbols=torch.where(own[..., None], dem.symbols, 0),
        count=torch.where(own, dem.count, 0),
        found=own,
        freq_error=torch.where(own, dem.freq_error, 0),
        fine_freq=torch.where(own, dem.fine_freq, 0.0),
        power=dem.power,
        snr=dem.snr,
        t_sync=torch.where(own, dem.t_sync + t_off, -1),
        consumed=torch.where(own, dem.consumed + t_off, 0),
    )
