"""Distributed channelizer: time-sharded wideband in, channel-sharded out
(port of lora_tpu/parallel/channelize.py).

A wideband capture arrives sharded along time (each ingest rank holds a
contiguous slice); demodulation wants the channel axis parallel.  Every
rank runs the polyphase channelizer (kernel D on the card) on its time
block, with the filter history taken from its left neighbour's tail
(comm.shift), exactly the streaming `state` of ops/channelizer.channelize,
and then corner-turns the result with one all_to_all_single, so that each
rank holds a group of channels over the whole capture.
"""

from __future__ import annotations

import torch

from ..ops import channelizer as chz
from ..ops import cplx
from . import comm
from .mesh import Mesh


def channelize_stream(x_local, K: int, mesh: Mesh, taps_per_phase: int = 8,
                      axis: str = "time") -> torch.Tensor:
    """Channelize this rank's block [B_local, t_local] of a bank of wideband
    captures (rows split over 'channel', time over `axis`).

    Returns complex64 [B_local, K / n_time, T_global / K]: the channels
    [j * K / n, (j + 1) * K / n) of time shard j (the corner-turn layout),
    each over the whole capture.  Requires K % n_time == 0 and T_global %
    (K * n_time) == 0, and a block no shorter than the filter history
    (taps_per_phase * K - 1 samples)."""
    x = cplx.as_iq(x_local, mesh.device)
    n = mesh.shape[axis]
    B, t_local = x.shape
    T = t_local * n
    if T % (K * n):
        raise ValueError(f"T={T} must divide into {n} K-aligned blocks")
    if K % n:
        raise ValueError(f"K={K} must be divisible by time shards {n}")
    hist = K * taps_per_phase - 1
    if t_local < hist:
        raise ValueError(f"local block {t_local} is shorter than the filter "
                         f"history {hist}")
    group = mesh.group(axis)
    # filter history = the last hist samples of the left neighbour; zeros
    # before the capture's start
    state = comm.shift(x[:, t_local - hist:], group, 1)
    if mesh.coord[axis] == 0:
        state = torch.zeros_like(state)
    y, _ = chz.channelize(x, K, taps_per_phase, state=state)
    if group is None:
        return y
    # corner turn: channel group j goes to time shard j; the blocks that
    # arrive are consecutive stretches of time
    M = y.shape[-1]
    blocks = y.reshape(B, n, K // n, M).transpose(0, 1)
    got = comm.all_to_all(blocks, group)  # [n (source), B, K/n, M]
    return got.permute(1, 2, 0, 3).reshape(B, K // n, n * M)
