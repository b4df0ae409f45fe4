"""Rank programs of the port's parallel tests (not a test module).

`lora_tpu_torch.parallel.dryrun.launch` runs each of these on spawned
ranks of one process group.  A rank imports this module by name, so it
imports torch, numpy and lora_tpu_torch only, never jax or lora_tpu (the
test files do), and returns host numpy values: the tests hold them against
lora_tpu on the same inputs.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from lora_tpu_torch import api
from lora_tpu_torch.ops import cplx
from lora_tpu_torch.parallel import (ChannelDispatcher, aggregate_metrics,
                                     channel_sharding, channelize_stream,
                                     demodulate_stream, gather_result,
                                     halo_exchange, make_mesh,
                                     shard_demodulate)
from lora_tpu_torch.parallel import multihost
from lora_tpu_torch.parallel.mesh import gather
from lora_tpu_torch.utils import trace


def fields(res) -> dict:
    """A result's non-None fields as host numpy."""
    return {f.name: cplx.host(getattr(res, f.name))
            for f in dataclasses.fields(res)
            if getattr(res, f.name) is not None}


def metrics(m: dict) -> dict:
    return {k: v.item() for k, v in m.items()}


def bank_demod(x, cfg, time_ax, device="cpu", spectra=False):
    """shard_demodulate of this rank's channel_sharding rows of x [B, T],
    decode and aggregate_metrics under the sharding, then the gathered
    demod and decode results and the kernels' launches in this rank
    (utils/trace.launches of a session around it all: zeros without a
    card)."""
    mesh = make_mesh(time=time_ax, device=device)
    with trace.session() as prof:
        dem = shard_demodulate(x[channel_sharding(mesh, x.shape[0])], cfg,
                               mesh, spectra=spectra)
        dec = api.decode(dem.symbols, cfg)
        m = aggregate_metrics(dem, dec.status, mesh)
        out = {"dem": fields(gather_result(dem, mesh)),
               "dec": fields(gather_result(dec, mesh)),
               "metrics": metrics(m), "shape": dict(mesh.shape),
               "local_rows": int(dem.found.shape[0])}
    return {**out, "launches": trace.launches(prof)}


def stream_demod(bank, cfg, time_ax, max_frames=1, device="cpu"):
    """demodulate_stream of this rank's block of bank [B, T] (rows over
    'channel', time over 'time'), gathered to [time, B, ...], with
    aggregate_metrics over every slot."""
    mesh = make_mesh(time=time_ax, device=device)
    x = multihost.host_array(bank.shape, bank, mesh, ("channel", "time"))
    dem = demodulate_stream(x, cfg, mesh, max_frames=max_frames)
    return {"dem": fields(gather_result(dem, mesh, "time")),
            "metrics": metrics(aggregate_metrics(dem, None, mesh))}


def channelize(wide, K, time_ax, device="cpu"):
    """channelize_stream of this rank's block of wide [S, T] -> the global
    [S, K, T / K] bank."""
    mesh = make_mesh(time=time_ax, device=device)
    x = multihost.host_array(wide.shape, wide, mesh, ("channel", "time"))
    y = channelize_stream(x, K, mesh)
    return {"y": cplx.host(gather([y], mesh, ("channel", "time"))[0]),
            "local": tuple(y.shape)}


def channelized_demod(wide, K, cfg, time_ax, device="cpu"):
    """channelize_stream and then shard_demodulate of the rank's channels,
    gathered to [S, K, ...]."""
    mesh = make_mesh(time=time_ax, device=device)
    x = multihost.host_array(wide.shape, wide, mesh, ("channel", "time"))
    y = channelize_stream(x, K, mesh)
    S, k, M = y.shape
    dem = shard_demodulate(y.reshape(S * k, M), cfg, mesh)
    dem = dataclasses.replace(dem, **{
        f: getattr(dem, f).reshape(S, k, *getattr(dem, f).shape[1:])
        for f in fields(dem)})
    return fields(gather_result(dem, mesh, ("channel", "time")))


def halo(x, left, right, time_ax, wrap, device="cpu"):
    """halo_exchange of this rank's time block of x [B, T]."""
    mesh = make_mesh(time=time_ax, device=device)
    blk = multihost.host_array(x.shape, x, mesh, ("channel", "time"))
    return {"coord": dict(mesh.coord),
            "ext": cplx.host(halo_exchange(blk, left, right, mesh,
                                           wrap=wrap))}


def dispatch(configs, streams, soft, time_ax=1, device="cpu"):
    """ChannelDispatcher over the rank's mesh: every channel's result."""
    mesh = make_mesh(time=time_ax, device=device)
    res = ChannelDispatcher(configs, soft=soft, mesh=mesh).run(streams)
    return [(r.found, r.status, r.payload, r.symbols, r.snr) for r in res]


def multihost_recipe(bank, cfg, ranks_per_host):
    """lora_tpu/parallel/multihost.py's recipe as a rank runs it: the global
    mesh (one time shard per host), this rank's local_time_range slice of
    the capture, host_array, demodulate_stream, aggregate_metrics and the
    gathered frames."""
    os.environ["LOCAL_WORLD_SIZE"] = str(ranks_per_host)
    mesh = multihost.global_mesh(device="cpu")
    s, e = multihost.local_time_range(mesh, bank.shape[-1])
    x = multihost.host_array(bank.shape, bank[:, s:e], mesh,
                             ("channel", "time"))
    dem = demodulate_stream(x, cfg, mesh)
    return {"shape": dict(mesh.shape), "range": (s, e),
            "metrics": metrics(aggregate_metrics(dem, None, mesh)),
            "dem": fields(gather_result(dem, mesh, "time"))}


def imported() -> list:
    """The jax and lora_tpu modules this rank has loaded (none)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "lora_tpu"))


def fail(rank_to_fail):
    import torch.distributed as dist

    print(f"rank {dist.get_rank()} here", flush=True)
    if dist.get_rank() == rank_to_fail:
        raise ValueError("this rank fails on purpose")
    dist.barrier()  # the other ranks wait for the one that failed


def hang():
    time.sleep(600)
