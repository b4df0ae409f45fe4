"""The port's sharded paths (lora_tpu_torch.parallel: mesh, halo,
corner-turn channelizer) on gloo ranks against lora_tpu's on the 8-device
virtual CPU mesh (tests/conftest.py), on the same numpy inputs.

The port is multi-controller: each rank returns its local result and
gather_result builds the global view that lora_tpu returns, so the tests
compare global with global.  Integer fields bit for bit; dB values and the
fine CFO within 1e-3 + 1e-4 of their size (float32 FFTs of another order:
the rounding of a noise floor 60 dB down reads about 2e-3 dB);
aggregate_metrics' counts exactly, its means within 1e-3 of their size;
channelizer outputs within 1e-5 of the largest (float32 sums in another
order).  Every launch of ranks ends within 120 s or fails the test.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import lora_tpu
from lora_tpu import api as japi
from lora_tpu import parallel as jpar
from lora_tpu.ops import channelizer as jchz
from lora_tpu.ops import cplx as jcplx

import lora_tpu_torch
from lora_tpu_torch import api as tapi
from lora_tpu_torch import parallel as tpar
from lora_tpu_torch.ops import channelizer as tchz
from lora_tpu_torch.parallel import multihost
from lora_tpu_torch.parallel.dryrun import launch

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

EXACT = ("found", "symbols", "t_sync", "consumed", "count", "freq_error",
         "found_pre", "t_candidate", "payload_complete")
CLOSE = ("power", "snr", "fine_freq")
TOL = 1e-3
RTOL = 1e-4
LAUNCH_TIMEOUT = 120.0


def run(world, fn, *args, **kw):
    """fn(*args, **kw) on `world` gloo ranks on the CPU; rank 0's result
    (every rank returns the same global view: checked)."""
    out = launch(world, functools.partial(fn, *args, **kw), device="cpu",
                 timeout=LAUNCH_TIMEOUT)
    for r in out[1:]:
        assert_same(r, out[0])
    return out[0]


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def configs(sf, cr, nbytes):
    fields = dict(sf=sf, cr=cr, ampl=1.0)
    j = lora_tpu.LoRaConfig(**fields)
    t = lora_tpu_torch.LoRaConfig(**fields)
    m = j.num_symbols(nbytes) + 2
    return j.replace(mtu=m), t.replace(mtu=m)


def jfields(dem) -> dict:
    return {k: np.asarray(v) for k, v in vars(dem).items() if v is not None}


def assert_dem_equal(got: dict, want: dict, names=EXACT + CLOSE):
    for k in names:
        if k not in want:
            continue
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        if k in CLOSE:
            fin = np.isfinite(want[k])
            np.testing.assert_array_equal(np.isfinite(got[k]), fin, err_msg=k)
            w = want[k][fin].astype(np.float64)
            d = np.abs(got[k][fin] - w) - RTOL * np.abs(w)
            assert d.max(initial=0) <= TOL, (k, d.max())
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_metrics_equal(got: dict, want: dict):
    want = {k: np.asarray(v).item() for k, v in want.items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("mean_"):
            assert abs(got[k] - v) <= TOL * max(1.0, abs(v)), (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


def jax_frames(cfg, payload, T):
    iq = japi.modulate(japi.encode(jnp.asarray(payload), cfg), cfg)
    iq = jcplx.pad(iq, ((0, 0), (0, max(0, T - iq.shape[-1]))))[:, :T]
    return np.asarray(jcplx.to_complex(iq))


def noise(rng, shape, sigma):
    return (sigma * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


# --------------------------------------------------------------------------
# channel bank
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world,time_ax", [(2, 1), (4, 2)])
def test_torch_channel_bank_shard_demod_matches_jax(world, time_ax, rng):
    """shard_demodulate over 2 ranks (1 x 2) and 4 ranks (2 x 2, the time
    dim folded into the channel bank) against lora_tpu's on 1 x 8 devices:
    every field, the payloads and aggregate_metrics."""
    jcfg, tcfg = configs(7, "4/7", 8)
    T = japi.required_samples(jcfg)
    payload = rng.integers(0, 256, (16, 8), dtype=np.uint8)
    x = jax_frames(jcfg, payload, T) + noise(rng, (16, T), 0.05)

    mesh = jpar.make_mesh()
    xj = jax.device_put(jcplx.from_complex(x), jpar.channel_sharding(mesh))
    jdem = jpar.shard_demodulate(xj, jcfg, mesh)
    jdec = japi.decode(jdem.symbols.astype(jnp.int32), jcfg)
    jm = jpar.aggregate_metrics(jdem, statuses=jdec.status)

    got = run(world, ranks.bank_demod, x, tcfg, time_ax)
    assert got["shape"] == {"time": time_ax, "channel": world // time_ax}
    assert got["local_rows"] == 16 // world
    assert_dem_equal(got["dem"], jfields(jdem))
    np.testing.assert_array_equal(got["dec"]["status"],
                                  np.asarray(jdec.status))
    np.testing.assert_array_equal(got["dec"]["data"], np.asarray(jdec.data))
    assert int(got["metrics"]["decoded_ok"]) == 16
    assert_metrics_equal(got["metrics"], jm)


# --------------------------------------------------------------------------
# time shards
# --------------------------------------------------------------------------

def boundary_bank(jcfg, time_ax, rng):
    """tests/test_parallel.py's bank: a frame a channel at offsets around
    the first shard boundary."""
    need = japi.required_samples(jcfg)
    t_local = ((need - 1) // 128 + 1) * 128 + 512
    T = t_local * time_ax
    payload = rng.integers(0, 256, size=(8, 4)).astype(np.uint8)
    frame = japi.modulate(japi.encode(jnp.asarray(payload), jcfg), jcfg)
    fr = np.asarray(jcplx.to_complex(frame))
    FL = fr.shape[-1]
    offsets = [0, t_local - FL // 3, t_local - 2, t_local // 2, t_local + 5,
               max(0, t_local - FL + 64), 37, t_local - 1024]
    bank = np.zeros((8, T), np.complex64)
    for i, o in enumerate(offsets):
        bank[i, o : o + FL] = fr[i, : max(0, min(FL, T - o))]
    return bank, payload, offsets, t_local


@pytest.mark.parametrize("world,time_ax", [(2, 2), (4, 2), (4, 4)])
def test_torch_stream_boundary_frames_match_jax(world, time_ax, rng):
    """demodulate_stream over time 2 (2 ranks, and a 2 x 2 mesh of 4 ranks)
    and time 4 (4 ranks): every frame claimed once, by the shard that owns
    its preamble start, t_sync global and within 1 of the placement, every
    field equal to lora_tpu's [time, B] slots, payloads byte-exact."""
    jcfg, tcfg = configs(7, "4/8", 4)
    bank, payload, offsets, t_local = boundary_bank(jcfg, time_ax, rng)

    jmesh = jpar.make_mesh(time=time_ax)
    xj = jax.device_put(jnp.asarray(bank),
                        NamedSharding(jmesh, P("channel", "time")))
    want = jfields(jpar.demodulate_stream(xj, jcfg, jmesh))

    got = run(world, ranks.stream_demod, bank, tcfg, time_ax)["dem"]
    assert_dem_equal(got, want)
    found = got["found"]  # [time, B]
    assert np.all(found.sum(axis=0) == 1), found
    owner = found.argmax(axis=0)
    for i, o in enumerate(offsets):
        assert owner[i] == o // t_local, (i, o, owner[i])
        assert abs(int(got["t_sync"][owner[i], i]) - (o + 10 * jcfg.N)) <= 1
    syms = got["symbols"][owner, np.arange(8)]
    dec = tapi.decode(torch.as_tensor(syms), tcfg)
    assert tapi.extract_payloads(dec) == [bytes(p.tolist()) for p in payload]


def test_torch_stream_multi_frame_matches_jax(rng):
    """Two frames inside one shard's region, both in that shard's candidate
    slots under max_frames=2, equal to lora_tpu's [time, B, 2]; the
    aggregate over every slot counts them."""
    jcfg, tcfg = configs(7, "4/8", 4)
    need = japi.required_samples(jcfg)
    t_local = ((need - 1) // 128 + 1) * 128 + 6144
    T = t_local * 2
    payload = rng.integers(0, 256, size=(2, 4)).astype(np.uint8)
    FL = np.asarray(japi.modulate(japi.encode(jnp.asarray(payload), jcfg),
                                  jcfg).re).shape[-1]
    fr = jax_frames(jcfg, payload, FL)
    bank = np.zeros((8, T), np.complex64)
    offsets = [64, 64 + FL + 500]  # both in shard 0
    for i, o in enumerate(offsets):
        bank[0, o : o + FL] = fr[i]
    bank += noise(rng, bank.shape, 0.02)

    jmesh = jpar.make_mesh(time=2)
    xj = jax.device_put(jnp.asarray(bank),
                        NamedSharding(jmesh, P("channel", "time")))
    jdem = jpar.demodulate_stream(xj, jcfg, jmesh, max_frames=2)

    res = run(2, ranks.stream_demod, bank, tcfg, 2, max_frames=2)
    got = res["dem"]
    assert_dem_equal(got, jfields(jdem))
    assert got["found"].shape == (2, 8, 2)
    assert got["found"][0, 0].tolist() == [True, True]
    assert not got["found"][1].any() and not got["found"][0, 1:].any()
    for k, o in enumerate(offsets):
        assert abs(int(got["t_sync"][0, 0, k]) - (o + 10 * jcfg.N)) <= 1
    dec = tapi.decode(torch.as_tensor(got["symbols"][0, 0]), tcfg)
    assert tapi.extract_payloads(dec) == [bytes(p.tolist()) for p in payload]
    assert_metrics_equal(res["metrics"], jpar.aggregate_metrics(jdem))


def test_torch_stream_one_rank_mesh_matches_jax(rng):
    """Without a process group make_mesh gives the one-rank mesh: no
    collective, a one-shard time axis whose zeroed margins are lora_tpu's
    time = 1 case; shard_demodulate is demodulate."""
    jcfg, tcfg = configs(7, "4/8", 4)
    bank, payload, offsets, t_local = boundary_bank(jcfg, 2, rng)
    mesh = tpar.make_mesh(device="cpu")
    assert mesh.shape == {"time": 1, "channel": 1} and mesh.group() is None
    got = ranks.fields(tpar.gather_result(
        tpar.demodulate_stream(bank, tcfg, mesh), mesh, "time"))
    jmesh = jpar.make_mesh(time=1)
    xj = jax.device_put(jnp.asarray(bank),
                        NamedSharding(jmesh, P("channel", "time")))
    assert_dem_equal(got, jfields(jpar.demodulate_stream(xj, jcfg, jmesh)))
    x = torch.as_tensor(bank[:, :t_local])
    a = ranks.fields(tpar.shard_demodulate(x, tcfg, mesh))
    b = ranks.fields(tapi.demodulate(x, tcfg))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("wrap", [False, True])
def test_torch_halo_exchange(wrap, rng):
    """Each of 4 time shards gets its left neighbour's suffix and its right
    neighbour's prefix; without wrap shard 0's margin and shard 3's halo are
    exact zeros; on the one-rank mesh a block's own edges wrap round (and
    are zeros without wrap), as lora_tpu's n == 1 case."""
    x = noise(rng, (2, 4 * 96), 1.0)
    left, right = 40, 96
    outs = launch(4, functools.partial(ranks.halo, x, left, right, 4, wrap),
                  device="cpu", timeout=LAUNCH_TIMEOUT)
    xw = np.concatenate([x[:, -left:], x, x[:, :right]], -1)
    for r in outs:
        t = r["coord"]["time"]
        want = xw[:, t * 96 : t * 96 + left + 96 + right].copy()
        if not wrap and t == 0:
            want[:, :left] = 0
        if not wrap and t == 3:
            want[:, -right:] = 0
        np.testing.assert_array_equal(r["ext"], want)
        if not wrap and t == 0:  # +0.0, as the kernels must see
            assert not np.signbit(r["ext"][:, :left].view(np.float32)).any()
    mesh = tpar.make_mesh(device="cpu")
    blk = torch.as_tensor(x[:, :96])
    ext = tpar.halo_exchange(blk, 8, 8, mesh, wrap=wrap).numpy()
    own = np.concatenate([x[:, 88:96], x[:, :96], x[:, :8]], -1)
    if not wrap:
        own[:, :8] = 0
        own[:, -8:] = 0
    np.testing.assert_array_equal(ext, own)


# --------------------------------------------------------------------------
# corner-turn channelizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world,time_ax", [(2, 2), (4, 4), (4, 2)])
def test_torch_channelize_stream_matches_jax(world, time_ax, rng):
    """channelize_stream of time-sharded wideband streams: the left
    neighbour's tail as the filter state, then the corner turn, against
    lora_tpu's on the 8-device mesh and against one channelize of the whole
    stream, within 1e-5 of the largest output."""
    K, S = 16, 4
    T = 4 * 16 * 64
    wide = noise(rng, (S, T), 1.0)
    jmesh = jpar.make_mesh(time=time_ax)
    xj = jax.device_put(jcplx.from_complex(wide),
                        NamedSharding(jmesh, P("channel", "time")))
    want = np.asarray(jcplx.to_complex(jpar.channelize_stream(xj, K, jmesh)))
    res = run(world, ranks.channelize, wide, K, time_ax)
    assert res["local"] == (S // (world // time_ax), K // time_ax, T // K)
    y = res["y"]
    assert y.shape == want.shape == (S, K, T // K)
    scale = np.abs(want).max()
    assert np.abs(y - want).max() <= 1e-5 * scale
    whole, _ = tchz.channelize(torch.as_tensor(wide), K)
    assert np.abs(y - whole.numpy()).max() <= 1e-5 * scale


def test_torch_channelize_stream_feeds_demod_matches_jax(rng):
    """The corner turn's channels through shard_demodulate (the dryrun's
    step 3 at time 2): a frame on channel 3 of K = 8 found and decoded, the
    channels beyond +-1 clean, every field equal to lora_tpu's."""
    jcfg, tcfg = configs(7, "4/8", 4)
    K, chan, time_ax = 8, 3, 2
    need = japi.required_samples(jcfg)
    payload = rng.integers(0, 256, (1, 4), dtype=np.uint8)
    nb = japi.modulate(japi.encode(jnp.asarray(payload), jcfg), jcfg)[0]
    nb = jcplx.pad(nb, ((32, need + 64 - nb.shape[-1] - 32),))
    wide = np.asarray(jcplx.to_complex(jchz.upconvert(nb, K, chan)))
    T3 = (wide.shape[-1] // (K * time_ax)) * K * time_ax
    wide = wide[:T3] + noise(rng, (T3,), 0.01)
    xs = np.broadcast_to(wide, (4, T3)).copy()  # one stream a channel row

    jmesh = jpar.make_mesh(time=time_ax)
    xj = jax.device_put(jcplx.from_complex(xs),
                        NamedSharding(jmesh, P("channel", "time")))
    y = jpar.channelize_stream(xj, K, jmesh)
    bank = jax.tree.map(lambda a: a.reshape(4 * K, -1), y)
    jdem = jpar.shard_demodulate(
        jax.device_put(bank, jpar.channel_sharding(jmesh)), jcfg, jmesh)
    want = {k: v.reshape(4, K, *v.shape[1:])
            for k, v in jfields(jdem).items()}

    got = run(4, ranks.channelized_demod, xs, K, tcfg, time_ax)  # 2 x 2
    assert_dem_equal(got, want)
    assert got["found"][:, chan].all()
    ghost = got["found"].copy()
    ghost[:, chan - 1 : chan + 2] = False
    assert not ghost.any(), got["found"]
    dec = tapi.decode(torch.as_tensor(got["symbols"][:, chan]), tcfg)
    assert tapi.extract_payloads(dec) == [bytes(payload[0].tolist())] * 4


# --------------------------------------------------------------------------
# errors, one-rank mesh
# --------------------------------------------------------------------------

def test_torch_parallel_errors_match_jax():
    """The ValueErrors of make_mesh, demodulate_stream, channelize_stream,
    halo_exchange and channel_sharding (lora_tpu's messages where it has
    them), on the one-rank mesh."""
    _, tcfg = configs(7, "4/8", 4)
    with pytest.raises(ValueError, match="not divisible by time=2"):
        tpar.make_mesh(time=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
        tpar.make_mesh(channel=2, device="cpu")
    mesh = tpar.make_mesh(device="cpu")
    N = tcfg.N
    with pytest.raises(ValueError, match="multiple of N"):
        tpar.demodulate_stream(torch.zeros((1, 100 * N + 1),
                                           dtype=torch.complex64), tcfg, mesh)
    with pytest.raises(ValueError, match="exceed local block"):
        tpar.demodulate_stream(torch.zeros((1, 8 * N), dtype=torch.complex64),
                               tcfg, mesh)
    with pytest.raises(ValueError, match="not divisible by time axis"):
        multihost.local_time_range(tpar.Mesh(2, 1, "cpu"), 101)
    with pytest.raises(ValueError, match="divisible by time shards"):
        tpar.channelize_stream(torch.zeros((1, 4 * 1024),
                                           dtype=torch.complex64),
                               8, tpar.Mesh(3, 1, "cpu"))
    with pytest.raises(ValueError, match="K-aligned blocks"):
        tpar.channelize_stream(torch.zeros((1, 1000), dtype=torch.complex64),
                               16, mesh)
    with pytest.raises(ValueError, match="filter history"):
        tpar.channelize_stream(torch.zeros((1, 64), dtype=torch.complex64),
                               16, mesh)
    with pytest.raises(ValueError, match="local block"):
        tpar.halo_exchange(torch.zeros((1, 8)), 9, 0, mesh)
    with pytest.raises(ValueError, match="not divisible by the 2"):
        tpar.channel_sharding(tpar.Mesh(1, 2, "cpu"), 3)
    assert tpar.channel_sharding(mesh, 5) == slice(0, 5)
    assert tpar.left_margin(tcfg) == jpar.halo.left_margin(
        lora_tpu.LoRaConfig(sf=7, cr="4/8"))


def test_torch_aggregate_metrics_one_rank_matches_api(rng):
    """On the one-rank mesh the reduced metrics are api.aggregate_metrics',
    counts equal and means within float32 rounding."""
    _, tcfg = configs(7, "4/8", 4)
    T = tapi.required_samples(tcfg)
    payload = rng.integers(0, 256, (6, 4), dtype=np.uint8)
    x = tapi.modulate(tapi.encode(payload, tcfg, device="cpu"), tcfg)
    x = torch.nn.functional.pad(x, (0, T - x.shape[-1]))
    x[4:] = 0  # two empty channels
    dem = tapi.demodulate(x, tcfg)
    st = tapi.decode(dem.symbols, tcfg).status
    mesh = tpar.make_mesh(device="cpu")
    a = ranks.metrics(tpar.aggregate_metrics(dem, st, mesh))
    b = ranks.metrics(tapi.aggregate_metrics(dem, st))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-6), k
    assert a["synced"] == 4 and a["frames"] == 6
