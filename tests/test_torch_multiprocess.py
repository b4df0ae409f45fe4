"""The port's multi-process set-up (lora_tpu_torch.parallel.multihost and
dryrun.launch) on gloo ranks on the CPU: the twin of
__graft_entry__.dryrun_multiprocess at 2 and 4 ranks, the
initialize -> global_mesh -> local_time_range -> host_array ->
demodulate_stream -> aggregate_metrics recipe of tests/test_multiprocess.py
held against lora_tpu's on the 8-device virtual CPU mesh, the ranks'
imports, and a failing or hanging rank failing the launch.  Integer fields
bit for bit, the means within 1e-3 of their size.  Every launch ends
within 120 s or fails the test."""

import functools
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import lora_tpu
from lora_tpu import api as japi
from lora_tpu import parallel as jpar
from lora_tpu.ops import cplx as jcplx

import lora_tpu_torch
from lora_tpu_torch.parallel import Mesh, multihost
from lora_tpu_torch.parallel.dryrun import dryrun_multiprocess, launch

import torch_parallel_ranks as ranks

LAUNCH_TIMEOUT = 120.0
EXACT = ("found", "symbols", "t_sync", "consumed", "count", "freq_error")


@pytest.mark.parametrize("world", [2, 4])
def test_torch_dryrun_multiprocess(world):
    """The four steps of lora_tpu's sharded dryrun on `world` ranks (time 2
    or 4): loopback payloads, the straddling frame claimed once, the corner
    turn into the demod, the mixed-SF dispatcher; every rank returns the
    same global view."""
    outs = dryrun_multiprocess(world, device="cpu", timeout=LAUNCH_TIMEOUT)
    assert len(outs) == world
    B = 2 * world
    for o in outs:
        assert o["metrics"]["synced"] == B
        assert o["metrics"]["decoded_ok"] == B
        assert o["metrics"]["frames"] == world * B  # every time slot
        assert o["found1"][0].all() and not o["found1"][1:].any()
        np.testing.assert_array_equal(o["found2"], outs[0]["found2"])
        np.testing.assert_array_equal(o["found3"], outs[0]["found3"])
        assert o["payloads4"] == outs[0]["payloads4"]
    assert outs[0]["found2"].sum() == 3  # two frames + the straddling one


def recipe_bank(cfg, n_time, n_chan):
    """tests/test_multiprocess.py's capture: four frames, one straddling the
    shard boundary, noise 0.05, made the same on every process."""
    N = cfg.N
    need = japi.required_samples(cfg)
    t_local = ((max(need, (cfg.preamble_symbols + 4) * N) - 1) // N + 1) * N \
        + N
    T = t_local * n_time
    B = 2 * n_chan
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, size=(B, 4)).astype(np.uint8)
    frame = np.asarray(jcplx.to_complex(
        japi.modulate(japi.encode(jnp.asarray(payload), cfg), cfg)))
    FL = frame.shape[-1]
    offsets = [0, t_local - FL // 3, t_local + N, T - t_local // 2]
    offsets = [min(o, T - need) for o in offsets][:B]
    bank = np.zeros((B, T), np.complex64)
    for b, o in enumerate(offsets):
        bank[b, o : o + FL] = frame[b]
    bank += 0.05 * rng.standard_normal((B, 2 * T), dtype=np.float32).view(
        np.complex64)
    return bank, payload, offsets


def test_torch_multihost_recipe_matches_jax():
    """Two hosts of two ranks (LOCAL_WORLD_SIZE=2): global_mesh gives one
    time shard a host (2 x 2), each rank provides its local_time_range
    slice, host_array keeps its channel rows; the stream's frames, the
    all-reduced metrics and the gathered slots equal lora_tpu's, every
    planted frame claimed once at its offset."""
    fields = dict(sf=7, cr="4/8", ampl=1.0)
    jcfg = lora_tpu.LoRaConfig(**fields)
    jcfg = jcfg.replace(mtu=jcfg.num_symbols(4) + 2)
    tcfg = lora_tpu_torch.LoRaConfig(**fields).replace(mtu=jcfg.mtu)
    bank, payload, offsets = recipe_bank(jcfg, 2, 2)
    T = bank.shape[-1]

    jmesh = jpar.make_mesh(time=2)
    xj = jax.device_put(jcplx.from_complex(bank),
                        NamedSharding(jmesh, P("channel", "time")))
    jdem = jpar.demodulate_stream(xj, jcfg, jmesh)
    jm = {k: np.asarray(v).item()
          for k, v in jpar.aggregate_metrics(jdem).items()}

    outs = launch(4, functools.partial(ranks.multihost_recipe, bank, tcfg, 2),
                  device="cpu", timeout=LAUNCH_TIMEOUT)
    t_local = T // 2
    for r, o in enumerate(outs):
        assert o["shape"] == {"time": 2, "channel": 2}
        assert o["range"] == ((r // 2) * t_local, (r // 2 + 1) * t_local)
        for k in jm:
            if k.startswith("mean_"):
                assert abs(o["metrics"][k] - jm[k]) <= 1e-3 * abs(jm[k])
            else:
                assert o["metrics"][k] == jm[k], k
        for k in EXACT:
            np.testing.assert_array_equal(o["dem"][k], np.asarray(
                getattr(jdem, k)), err_msg=k)
    dem = outs[0]["dem"]
    assert outs[0]["metrics"]["synced"] == len(offsets)
    found = dem["found"].reshape(-1)
    t_pre = dem["t_sync"].reshape(-1)[found] - jcfg.preamble_symbols * jcfg.N
    assert sorted(t_pre.tolist()) == pytest.approx(sorted(offsets), abs=2)
    order = np.argsort(np.where(found, dem["t_sync"].reshape(-1), 1 << 30))
    sym = dem["symbols"].reshape(-1, dem["symbols"].shape[-1])[order][
        : int(found.sum())]
    from lora_tpu_torch import api as tapi

    got = tapi.extract_payloads(tapi.decode(sym, tcfg, device="cpu"))
    assert got == [bytes(p.tolist()) for p in payload[np.argsort(offsets)]]


def test_torch_ranks_import_no_jax():
    """A rank loads the port, torch and numpy: no jax, nothing of
    lora_tpu, though the test process that launched it has both."""
    assert "jax" in __import__("sys").modules
    for mods in launch(2, ranks.imported, device="cpu",
                       timeout=LAUNCH_TIMEOUT):
        assert mods == []


def test_torch_launch_fails_with_the_rank_output():
    """A rank that raises fails the launch with its output; the rank left
    waiting in a collective is killed, not waited for."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        launch(2, functools.partial(ranks.fail, 1), device="cpu",
               timeout=LAUNCH_TIMEOUT)
    assert "this rank fails on purpose" in str(e.value)
    assert "rank 1 here" in str(e.value)


def test_torch_launch_kills_ranks_at_timeout():
    with pytest.raises(TimeoutError, match="killed"):
        launch(2, ranks.hang, device="cpu", timeout=8.0)



def _children() -> set:
    """The pids of this process's live children (Linux /proc)."""
    me, kids = os.getpid(), set()
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(stat) as f:
                s = f.read()
        except OSError:
            continue  # ended while listed
        fields = s[s.rindex(")") + 2:].split()
        if int(fields[1]) == me and fields[0] != "Z":
            kids.add(int(s.split()[0]))
    return kids


@pytest.mark.parametrize("how", ["ok", "fail", "hang"])
def test_torch_launch_leaves_no_process(how):
    """Every process a launch starts has ended when it returns or raises:
    the ranks, and no helper of multiprocessing (its resource tracker
    would outlive the launch)."""
    before = _children()
    fn = {"ok": ranks.imported, "fail": functools.partial(ranks.fail, 1),
          "hang": ranks.hang}[how]
    try:
        launch(2, fn, device="cpu", timeout=LAUNCH_TIMEOUT if how != "hang"
               else 8.0)
    except (RuntimeError, TimeoutError):
        assert how != "ok"
    else:
        assert how == "ok"
    assert _children() - before == set()

def test_torch_host_array_and_local_time_range():
    """host_array keeps the rank's block along each split axis, from the
    whole extent or from the block itself; local_time_range is the rank's
    time shard."""
    mesh = Mesh(2, 2, "cpu")
    mesh.coord = {"time": 1, "channel": 0}
    mesh.rank = 2
    g = np.arange(4 * 12).reshape(4, 12).astype(np.complex64)
    a = multihost.host_array(g.shape, g, mesh, ("channel", "time")).numpy()
    np.testing.assert_array_equal(a, g[0:2, 6:12])
    b = multihost.host_array(g.shape, g[:, 6:12], mesh,
                             ("channel", "time")).numpy()
    np.testing.assert_array_equal(b, a)
    c = multihost.host_array(g.shape, g, mesh, (("time", "channel"),))
    np.testing.assert_array_equal(c.numpy(), g[2:3])
    assert multihost.local_time_range(mesh, 12) == (6, 12)
    with pytest.raises(ValueError, match="neither the global"):
        multihost.host_array(g.shape, g[:, :5], mesh, ("channel", "time"))
    with pytest.raises(ValueError, match="not divisible"):
        multihost.host_array((4, 13), np.zeros((4, 13)), mesh,
                             ("channel", "time"))
    with pytest.raises(ValueError, match="unknown mesh dim"):
        multihost.host_array(g.shape, g, mesh, ("chan",))


def test_torch_dryrun_one_rank_mesh_wraps_the_band():
    """Without a process group the dryrun runs on the one-rank mesh (time 1,
    K = 4): a frame on channel 3 leaks into channel 0, its neighbour across
    the band edge.  The channels found equal lora_tpu's from the same
    inputs through channelize_stream and shard_demodulate on a mesh of one
    virtual device; the port's check excludes the neighbours round the
    band, so it passes where a linear +-1 would not."""
    from lora_tpu.ops import channelizer as jchz
    from lora_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(device="cpu")
    assert "found2" not in out  # one time shard: no boundary to straddle
    # step 3 of the dryrun through lora_tpu: the same seed, payload row and
    # noise draw, K = 4, the frame on channel 3
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    rng = np.random.default_rng(7)
    payload_np = rng.integers(0, 256, (2, 4), dtype=np.uint8)
    need = japi.required_samples(cfg)
    K, chan = 4, 3
    nb = japi.modulate(japi.encode(jnp.asarray(payload_np[:1]), cfg), cfg)[0]
    nb = jcplx.pad(nb, ((32, need + 64 - nb.shape[-1] - 32),))
    wide = jchz.upconvert(nb, K, chan)
    T3 = (wide.shape[-1] // K) * K
    nz = 1e-2 * rng.standard_normal((2, T3)).astype(np.float32)
    wide = jcplx.IQ(wide.re[None, :T3] + nz[0], wide.im[None, :T3] + nz[1])
    mesh = jpar.make_mesh(devices=jax.devices()[:1])
    xs = jax.device_put(wide, NamedSharding(mesh, P("channel", "time")))
    y = jpar.channelize_stream(xs, K, mesh)
    bank = jax.tree.map(lambda a: a.reshape(K, -1), y)
    dem = jpar.shard_demodulate(
        jax.device_put(bank, jpar.channel_sharding(mesh)), cfg, mesh)
    want = np.asarray(dem.found).reshape(1, K)
    np.testing.assert_array_equal(out["found3"], want)
    assert want[0, 0] and want[0, chan]  # the leak across the band edge
