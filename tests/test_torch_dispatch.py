"""The port's ChannelDispatcher (lora_tpu_torch.parallel.dispatch) against
lora_tpu's on the same numpy streams: mixed-SF groups in one process, hard
and soft, and on a mesh of gloo ranks with soft decoding (lora_tpu on its
8-device virtual CPU mesh).  Found, status, payload and symbols equal for
every channel; snr within 1e-3 + 1e-4 of its size (float32 FFTs of
another order).  Every launch of ranks ends within 120 s or fails the
test."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.ops import cplx as jcplx
from lora_tpu.parallel import ChannelDispatcher as JDispatcher
from lora_tpu.parallel import make_mesh as jmake_mesh

import lora_tpu_torch
from lora_tpu_torch.parallel import ChannelDispatcher, GroupResult
from lora_tpu_torch.parallel.dryrun import launch

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 120.0


def configs(sf, cr, nbytes):
    fields = dict(sf=sf, cr=cr, ampl=1.0)
    j = lora_tpu.LoRaConfig(**fields)
    t = lora_tpu_torch.LoRaConfig(**fields)
    m = j.num_symbols(nbytes) + 2
    return j.replace(mtu=m), t.replace(mtu=m)


def frame(cfg, payload, lead=0, tail=256):
    iq = japi.modulate(japi.encode(jnp.asarray(payload[None]), cfg), cfg)[0]
    x = np.asarray(jcplx.to_complex(iq))
    return np.concatenate([np.zeros(lead, np.complex64), x,
                           np.zeros(tail, np.complex64)])


def summary(res):
    return [(r.found, r.status, r.payload, r.symbols, r.snr) for r in res]


def assert_same_results(got, want):
    assert len(got) == len(want)
    for ch, (g, w) in enumerate(zip(got, want)):
        assert g[:3] == w[:3], (ch, g[:3], w[:3])
        np.testing.assert_array_equal(g[3], w[3], err_msg=str(ch))
        assert abs(g[4] - w[4]) <= 1e-3 + 1e-4 * abs(w[4]), (ch, g[4], w[4])


def test_torch_dispatch_mixed_sf_groups_match_jax(rng):
    """tests/test_dispatch.py's plan: three configs (SF7, SF8, SF9) over six
    channels at their own leads, one group each; every channel found,
    byte-exact, and equal to lora_tpu's dispatcher."""
    plan = [(7, "4/8", 0), (9, "4/5", 133), (7, "4/8", 57), (8, "4/7", 301),
            (9, "4/5", 12), (7, "4/8", 999)]
    jcfgs, tcfgs, streams, payloads = [], [], [], []
    for sf, cr, lead in plan:
        jcfg, tcfg = configs(sf, cr, 6)
        p = rng.integers(0, 256, 6).astype(np.uint8)
        jcfgs.append(jcfg)
        tcfgs.append(tcfg)
        payloads.append(p)
        streams.append(frame(jcfg, p, lead=lead))
    disp = ChannelDispatcher(tcfgs, device="cpu")
    assert len(disp.groups) == 3
    res = disp.run(streams)
    assert all(isinstance(r, GroupResult) for r in res)
    assert [r.channel for r in res] == list(range(6))
    for r, p in zip(res, payloads):
        assert r.found and r.status == 0
        assert r.payload == bytes(p.tolist())
    assert_same_results(summary(res), summary(JDispatcher(jcfgs).run(streams)))
    # without decoding: the demod fields alone
    bare = disp.run(streams, with_decode=False)
    assert all(r.status is None and r.payload is None for r in bare)
    assert_same_results(summary(bare), summary(
        JDispatcher(jcfgs).run(streams, with_decode=False)))
    with pytest.raises(ValueError, match="one stream per configured channel"):
        disp.run(streams[:5])


def weak_strong_streams():
    """tests/test_dispatch.py's soft-mode input: a weak SF7 channel the hard
    path syncs but cannot decode, a clean SF8 channel."""
    pairs = [configs(7, "4/8", 16), configs(8, "4/7", 16)]
    pairs = [(j.replace(mtu=j.num_symbols(16) + 4),
              t.replace(mtu=t.num_symbols(16) + 4)) for j, t in pairs]
    msgs = [b"dispatch soft A!", b"dispatch soft B!"]
    rng = np.random.default_rng(1)
    streams = []
    for (jcfg, _), m in zip(pairs, msgs):
        T = japi.required_samples(jcfg)
        x = np.zeros(T, np.complex64)
        fr = frame(jcfg, np.frombuffer(m, np.uint8), tail=0)[:T]
        x[: fr.size] = fr
        sigma = 2.2 if jcfg.sf == 7 else 0.1
        x += sigma * (rng.standard_normal(T).astype(np.float32)
                      + 1j * rng.standard_normal(T).astype(np.float32))
        streams.append(x)
    return [j for j, _ in pairs], [t for _, t in pairs], streams, msgs


def test_torch_dispatch_soft_recovers_weak_channel_matches_jax():
    """soft=True threads the soft-decision path through the groups: the weak
    channel comes back byte-exact where the hard path drops it, the clean
    one is unaffected; both modes equal lora_tpu's."""
    jcfgs, tcfgs, streams, msgs = weak_strong_streams()
    hard = ChannelDispatcher(tcfgs, device="cpu").run(streams)
    soft = ChannelDispatcher(tcfgs, soft=True, device="cpu").run(streams)
    assert hard[0].found and hard[0].payload is None
    assert soft[0].payload == msgs[0]
    assert hard[1].payload == msgs[1] and soft[1].payload == msgs[1]
    assert_same_results(summary(hard),
                        summary(JDispatcher(jcfgs).run(streams)))
    assert_same_results(summary(soft), summary(
        JDispatcher(jcfgs, soft=True).run(streams)))


@pytest.mark.parametrize("world,time_ax", [(2, 1), (4, 2)])
def test_torch_dispatch_mesh_soft_matches_jax(world, time_ax, rng):
    """mesh + soft: each group's bank padded to the ranks (five channels,
    groups of three and two), demodulated in spectra mode and soft-decoded
    on every rank's rows, only the compact fields gathered, the CRC-less
    guard applied; equal to lora_tpu's mesh + soft dispatcher and to the
    port's without a mesh."""
    plan = [(7, "4/8"), (8, "4/7"), (7, "4/8"), (8, "4/7"), (7, "4/8")]
    jcfgs, tcfgs, streams, payloads = [], [], [], []
    for i, (sf, cr) in enumerate(plan):
        jcfg, tcfg = configs(sf, cr, 5)
        p = rng.integers(0, 256, 5).astype(np.uint8)
        jcfgs.append(jcfg)
        tcfgs.append(tcfg)
        payloads.append(p)
        streams.append(frame(jcfg, p, lead=31 * i))
    want = summary(JDispatcher(jcfgs, soft=True, mesh=jmake_mesh()).run(
        streams))
    outs = launch(world, functools.partial(ranks.dispatch, tcfgs, streams,
                                           True, time_ax),
                  device="cpu", timeout=LAUNCH_TIMEOUT)
    for got in outs:  # every rank returns every channel
        assert_same_results(got, want)
    for (found, status, payload, _, _), p in zip(outs[0], payloads):
        assert found and status == 0 and payload == bytes(p.tolist())
    single = ChannelDispatcher(tcfgs, soft=True, device="cpu").run(streams)
    assert_same_results(outs[0], summary(single))


def test_torch_dispatch_mesh_hard_weak_channel():
    """mesh + hard and mesh + soft on 2 ranks over the weak/clean pair: the
    hard path drops the weak frame, soft recovers it, as without a mesh."""
    jcfgs, tcfgs, streams, msgs = weak_strong_streams()
    for soft in (False, True):
        outs = launch(2, functools.partial(ranks.dispatch, tcfgs, streams,
                                           soft),
                      device="cpu", timeout=LAUNCH_TIMEOUT)
        want = summary(JDispatcher(jcfgs, soft=soft).run(streams))
        for got in outs:
            assert_same_results(got, want)
        assert outs[0][0][2] == (msgs[0] if soft else None)
        assert outs[0][1][2] == msgs[1]
