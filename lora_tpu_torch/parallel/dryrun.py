"""The sharded PHY step of lora_tpu's __graft_entry__, on the ranks of a
process group (the twin of __graft_entry__.dryrun_multichip and
dryrun_multiprocess).

`dryrun_multichip` runs on every rank of an initialized group (or alone on
the one-rank mesh) and asserts, at tiny SF7/SF8 shapes, the four steps of
lora_tpu's entry: channel-bank encode/modulate and the halo-exchanged
stream demod, a frame straddling a time-shard boundary claimed once, the
corner-turn channelizer feeding the channel-bank demod, and the mixed-SF
dispatcher, payload-exact.  `launch` starts the ranks: fresh interpreters
(the parent may have initialized CUDA) that meet in a file store in a
temporary directory, each killed at the timeout; a rank that fails fails
the launch with its output, and no process it started outlives it.  The
ranks import torch, numpy and this package only.
"""

from __future__ import annotations

import dataclasses
import functools
import multiprocessing.spawn
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import api
from ..config import LoRaConfig
from ..ops import channelizer as chz
from ..ops import cplx
from . import multihost
from .channelize import channelize_stream
from .dispatch import ChannelDispatcher
from .halo import demodulate_stream
from .mesh import (DIMS, aggregate_metrics, channel_sharding, gather,
                   gather_result, make_mesh, shard_demodulate)


def _tail(path: str, limit: int = 20000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-limit:]
    except OSError:
        return "(no output)"


# A rank's interpreter: the parent's sys.path, working directory and main
# module as multiprocessing's "spawn" sets them up, then the job.  Started
# by subprocess, not by multiprocessing, which would also start its
# resource tracker, a process that outlives the launch.
_BOOT = """import pickle, sys
from multiprocessing import spawn
job, rank = sys.argv[1], int(sys.argv[2])
with open(job, "rb") as f:
    spawn.prepare(pickle.load(f))  # sets sys.argv to the parent's
    main, args = pickle.load(f)
main(rank, *args)
"""


def _rank_main(rank: int, world: int, tmp: str, backend, device, fn) -> None:
    if cplx.resolve_device(device).type == "cpu":
        # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    multihost.initialize(coordinator=f"file://{os.path.join(tmp, 'store')}",
                         num_processes=world, process_id=rank,
                         backend=backend, device=device)
    result = fn()
    dist.barrier()
    dist.destroy_process_group()
    part = os.path.join(tmp, f"rank{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(result, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))


def launch(world: int, fn, *, backend: str | None = None, device=None,
           timeout: float = 600.0) -> list:
    """Run fn() on `world` ranks of one process group (backend as
    multihost.initialize picks it from device: NCCL for the card, gloo for
    "cpu") and return each rank's result, in rank order.  Each rank is a
    fresh interpreter.  fn and its result must pickle (a module-level
    function, or a functools.partial of one).  Every rank is killed at
    `timeout` seconds (TimeoutError); a rank that exits with an error
    kills the others and raises RuntimeError with its output.  Every rank
    has ended when launch returns or raises."""
    with tempfile.TemporaryDirectory(prefix="lora_ranks_") as tmp:
        job = os.path.join(tmp, "job.pkl")
        prep = multiprocessing.spawn.get_preparation_data("rank")
        del prep["authkey"]  # no multiprocessing connection is made
        with open(job, "wb") as f:
            pickle.dump(prep, f)
            pickle.dump((_rank_main, (world, tmp, backend, device, fn)), f)
        procs = []
        try:
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.log"), "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", _BOOT, job, str(r)],
                        stdin=subprocess.DEVNULL, stdout=log,
                        stderr=subprocess.STDOUT))
            _wait(procs, tmp, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _wait(procs, tmp: str, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while True:
        for r, p in enumerate(procs):
            if p.poll() not in (None, 0):
                log = _tail(os.path.join(tmp, f"rank{r}.log"))
                raise RuntimeError(f"rank {r} of {len(procs)} failed (exit "
                                   f"code {p.returncode}):\n{log}")
        alive = [p for p in procs if p.returncode is None]
        if not alive:
            return
        left = deadline - time.monotonic()
        if left <= 0:
            logs = "\n".join(
                f"--- rank {r}:\n"
                + _tail(os.path.join(tmp, f"rank{r}.log"), 4000)
                for r in range(len(procs)))
            raise TimeoutError(f"ranks still running after {timeout} s; "
                               f"killed\n{logs}")
        try:
            alive[0].wait(timeout=min(left, 0.2))
        except subprocess.TimeoutExpired:
            pass


def _rows(res, shape):
    """Every field of a result [R, ...] reshaped to [*shape, ...]."""
    return dataclasses.replace(res, **{
        f.name: getattr(res, f.name).reshape(*shape,
                                             *getattr(res, f.name).shape[1:])
        for f in dataclasses.fields(res) if getattr(res, f.name) is not None})


def _pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (left, max(0, right)))


def dryrun_multichip(device=None, mesh=None) -> dict:
    """One full sharded PHY step on this rank's mesh, tiny shapes (the twin
    of __graft_entry__.dryrun_multichip).  The mesh defaults to time = 4,
    2 or 1 ranks (the largest that divides the world) by the rest on
    channel.  Every rank makes the same inputs from one seed and keeps its
    block.  Raises AssertionError on a wrong result; returns what each
    step found, global on every rank."""
    if mesh is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(time=next(t for t in (4, 2, 1) if n % t == 0),
                         device=device)
    dev = mesh.device
    time_ax, n_chan = mesh.shape["time"], mesh.shape["channel"]
    t_idx, c_idx = mesh.coord["time"], mesh.coord["channel"]

    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    B = 2 * mesh.size
    rng = np.random.default_rng(7)
    payload_np = rng.integers(0, 256, (B, 4), dtype=np.uint8)
    want = [bytes(p.tolist()) for p in payload_np]

    # --- 1: DP encode/modulate over the whole mesh, then the stream bank's
    # layout (rows over 'channel', time over 'time'), halo-exchanged demod
    need = api.required_samples(cfg)
    t_local = ((need - 1) // 256 + 1) * 256
    T = t_local * time_ax
    rows = channel_sharding(mesh, B)
    iq = api.modulate(api.encode(payload_np[rows], cfg, device=dev), cfg)
    iq = _pad(iq, 0, T - iq.shape[-1])
    iq = gather([iq], mesh, (DIMS,))[0]  # re-shard through the global bank
    bc = B // n_chan
    x = iq[c_idx * bc : (c_idx + 1) * bc,
           t_idx * t_local : (t_idx + 1) * t_local]
    dem = demodulate_stream(x, cfg, mesh)
    dec = api.decode(dem.symbols, cfg)
    metrics = aggregate_metrics(dem, dec.status, mesh)
    metrics = {k: v.item() for k, v in metrics.items()}
    assert metrics["synced"] == B, metrics
    assert metrics["decoded_ok"] == B, metrics
    g = gather_result(dem, mesh, "time")  # [time, B]: slot 0 holds all
    got = api.extract_payloads(api.decode(g.symbols[0], cfg))
    assert got == want, "multichip loopback payload mismatch"
    out = {"metrics": metrics, "found1": cplx.host(g.found)}

    # --- 2: max_frames=2 slots and a frame straddling a shard boundary ---
    if time_ax > 1:
        frame = api.modulate(api.encode(payload_np[:3], cfg, device=dev), cfg)
        FL = frame.shape[-1]
        t_loc2 = ((need + FL + 640 - 1) // 128 + 1) * 128
        B2 = max(2 * n_chan, 2)
        bank = torch.zeros((B2, t_loc2 * time_ax), dtype=torch.complex64,
                           device=dev)
        bank[0, 64 : 64 + FL] = frame[0]  # two frames inside shard 0
        o1 = 64 + FL + 512
        bank[0, o1 : o1 + FL] = frame[1]
        o2 = t_loc2 - FL // 3  # one frame straddling the shard 0/1 boundary
        bank[1, o2 : o2 + FL] = frame[2]
        bc2 = B2 // n_chan
        x2 = bank[c_idx * bc2 : (c_idx + 1) * bc2,
                  t_idx * t_loc2 : (t_idx + 1) * t_loc2]
        g2 = gather_result(demodulate_stream(x2, cfg, mesh, max_frames=2),
                           mesh, "time")
        found = cplx.host(g2.found)  # [time, B2, 2]
        assert found[0, 0].tolist() == [True, True], found[:, 0]
        assert found[:, 1].sum() == 1 and found[0, 1, 0], found[:, 1]
        assert found[1:, 0].sum() == 0, "double-claimed frame"
        sym2 = g2.symbols
        dec0 = api.decode(sym2[0, 0], cfg)
        straddle = sym2[int(found.argmax(axis=0)[1, 0]), 1, 0]
        dec1 = api.decode(straddle[None], cfg)
        got2 = api.extract_payloads(dec0) + api.extract_payloads(dec1)
        assert got2 == want[:3], got2
        out["found2"] = found

    # --- 3: corner-turn channelizer feeding the channel-bank demod --------
    K, chan = 4 * time_ax, 3  # K % n_time == 0 (corner-turn constraint)
    nb = api.modulate(api.encode(payload_np[:1], cfg, device=dev), cfg)[0]
    nb = _pad(nb, 32, need + 64 - nb.shape[-1] - 32)
    wide = chz.upconvert(nb, K, chan)
    T3 = (wide.shape[-1] // (K * time_ax)) * K * time_ax
    nz = 1e-2 * rng.standard_normal((2, T3)).astype(np.float32)
    wide = wide[:T3] + cplx.from_planar(nz[0], nz[1], dev)
    t3 = T3 // time_ax
    x3 = wide[None, t_idx * t3 : (t_idx + 1) * t3]  # this rank's stream row
    y = channelize_stream(x3, K, mesh)  # [1, K / time, T3 / K]
    dem3 = shard_demodulate(y.reshape(-1, y.shape[-1]), cfg, mesh)
    g3 = gather_result(_rows(dem3, (1, K // time_ax)), mesh,
                       ("channel", "time"))  # [n_chan, K]
    found3 = cplx.host(g3.found)
    assert found3[:, chan].all(), found3
    # the polyphase crossover overlaps immediate neighbours (they may sync
    # on leakage); channels beyond +-1 must be clean.  The channels wrap
    # round the band: at K = 4 (one time shard) channel 0 neighbours
    # channel 3, which lora_tpu's check (a linear +-1) misses
    ghost = found3.copy()
    ghost[:, [(chan + d) % K for d in (-1, 0, 1)]] = False
    assert not ghost.any(), found3
    dec3 = api.decode(g3.symbols.reshape(n_chan * K, -1), cfg)
    got3 = api.extract_payloads(dec3)
    assert all(got3[c * K + chan] == want[0] for c in range(n_chan)), got3
    out["found3"] = found3

    # --- 4: dispatcher: mixed-SF groups, each data-parallel on the mesh --
    cfg8 = LoRaConfig(sf=8, cr="4/7", ampl=1.0)
    cfg8 = cfg8.replace(mtu=cfg8.num_symbols(4) + 2)
    n_mix = 2 * mesh.size  # alternating SF7 / SF8 channels
    configs = [cfg if ch % 2 == 0 else cfg8 for ch in range(n_mix)]
    pay4 = rng.integers(0, 256, (n_mix, 4), dtype=np.uint8)
    streams = []
    for ch in range(n_mix):
        c = configs[ch]
        fr = api.modulate(api.encode(pay4[ch][None], c, device=dev), c)[0]
        off = 16 * (ch % 3)
        pad_to = api.required_samples(c) + 256
        streams.append(cplx.host(_pad(fr, off, pad_to - fr.shape[-1] - off)))
    results = ChannelDispatcher(configs, mesh=mesh).run(streams)
    for ch, r in enumerate(results):
        assert r.found, f"dispatcher channel {ch} (SF{configs[ch].sf}) lost"
        assert r.status == 0, (ch, r.status)
        assert r.payload == bytes(pay4[ch].tolist()), ch
    out["payloads4"] = [r.payload for r in results]
    return out


def dryrun_multiprocess(world: int = 2, device=None, backend=None,
                        timeout: float = 600.0) -> list:
    """dryrun_multichip on `world` spawned ranks (the twin of
    __graft_entry__.dryrun_multiprocess); each rank's summary."""
    return launch(world, functools.partial(dryrun_multichip, device),
                  backend=backend, device=device, timeout=timeout)
