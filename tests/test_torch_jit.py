"""utils/jit.py, the port's captured programs, on the CPU, and the rewrites
that keep host syncs and uploads out of them, held against lora_tpu.

The cache logic (keys, in-place and copied arguments, the LRU bound, the
weak hold on resident storage, disable_jit, nested programs, failures)
runs with a stub in place of the card: its "graph"
replays by running the function again into the captured output tensors,
as a CUDA graph writes into fixed addresses.  The port's own programs run
through the same stub and must give what they give eagerly.  The card
tests (tests/test_torch_cuda.py) hold real CUDA graphs.
"""

import contextlib
import dataclasses
import weakref

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

import lora_tpu
from lora_tpu.models import decoder as jdec
from lora_tpu.ops import codes as jcodes
from lora_tpu.ops import detect as jdet

import lora_tpu_torch
from lora_tpu_torch import api
from lora_tpu_torch.models import decoder as tdec
from lora_tpu_torch.ops import _bitref, codes, tables
from lora_tpu_torch.ops import cuda_demod
from lora_tpu_torch.ops import detect as det_ops
from lora_tpu_torch.utils import jit

torch.set_num_threads(1)
CPU = torch.device("cpu")


class Pool:
    """A memory pool handle as torch's allocator keeps it: it goes with the
    last graph that captured into it, and a capture into it then fails."""

    def __init__(self):
        self.graphs = weakref.WeakSet()
        self.used = False

    def take(self, graph):
        assert not (self.used and not self.graphs), "use_count > 0"
        self.used = True
        self.graphs.add(graph)


class StubGraph:
    """Replays by running fn again and writing its outputs into the ones
    the capture returned (a CUDA graph's fixed addresses).  Like a CUDA
    graph it holds no reference to its input tensors, only their places."""

    def __init__(self, fn, args, out):
        self.fn = fn
        self.args = {k: place(v) for k, v in args.items()}
        self.outputs = []
        jit._flatten(out, self.outputs)

    def replay(self):
        fresh = []
        with jit.disable_jit():
            jit._flatten(self.fn(**{k: a() for k, a in self.args.items()}),
                         fresh)
        for o, f in zip(self.outputs, fresh):
            o.copy_(f)


def place(v):
    """A tensor argument as its storage (held weakly), offset and layout;
    anything else as itself."""
    if not isinstance(v, torch.Tensor):
        return lambda: v
    ref = weakref.ref(v.untyped_storage())
    dtype, at = v.dtype, (v.storage_offset(), v.shape, v.stride())
    return lambda: torch.empty(0, dtype=dtype).set_(ref(), *at)


class Stream:
    def wait_stream(self, other):
        pass


STREAM = Stream()


class StubCard(jit._Card):
    takes = staticmethod(lambda dev: dev.type == "cpu")
    resolve = staticmethod(lambda dev: dev)
    device = staticmethod(lambda dev: contextlib.nullcontext())
    current_stream = staticmethod(lambda dev: STREAM)
    new_stream = staticmethod(lambda dev: Stream())
    stream = staticmethod(lambda s: contextlib.nullcontext())
    pool = staticmethod(Pool)
    record_stream = staticmethod(lambda t, s: None)
    fail = False

    @staticmethod
    def capture(fn, args, pool):
        if StubCard.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        out = fn(**args)
        graph = StubGraph(fn, args, out)
        pool.take(graph)
        return graph, out


@pytest.fixture
def card(monkeypatch):
    monkeypatch.setattr(jit, "_card", StubCard)
    StubCard.fail = False
    yield
    jit.clear()


def make():
    """A program of a resident bank x and a small argument w."""

    @jit.program(static=("k",), inplace=("x",))
    def prog(x, w, k, device):
        return {"y": x.sum(-1) * w + k, "n": x.shape[0]}

    return prog


def test_key_is_static_arguments_and_layout(card):
    prog = make()
    x = torch.arange(12.0).reshape(3, 4)
    w = torch.ones(3)
    for _ in range(3):
        prog(x, w, 1, CPU)
    assert (prog.captures, prog.replays) == (1, 2)
    prog(x, w, 2, CPU)                      # another static value
    prog(x, w.double(), 1, CPU)             # another dtype
    prog(x, torch.ones(1).expand(3), 1, CPU)  # other strides
    prog(x[:2], w[:2], 1, CPU)              # another shape (and address)
    assert prog.captures == 5
    prog(x, w, 1, CPU)
    assert prog.captures == 5


def test_replay_reads_the_bank_in_place_and_copies_small_arguments(card):
    prog = make()
    x = torch.ones(2, 3)
    w = torch.tensor([1.0, 2.0])
    first = prog(x, w, 0, CPU)["y"]
    x.mul_(2)                       # new data written into the input
    w2 = torch.tensor([3.0, 4.0])   # a new small tensor of the same layout
    again = prog(x, w2, 0, CPU)["y"]
    assert torch.equal(again, torch.tensor([18.0, 24.0]))
    assert torch.equal(first, torch.tensor([3.0, 6.0]))  # still the caller's
    third = prog(x, w, 0, CPU)["y"]
    assert torch.equal(third, torch.tensor([6.0, 12.0]))
    assert torch.equal(again, torch.tensor([18.0, 24.0]))
    assert prog.captures == 1


def test_entry_goes_with_the_banks_storage(card):
    prog = make()
    x = torch.ones(4, 8)
    view = x[:, :8]
    prog(x, torch.ones(4), 0, CPU)
    prog(x, torch.ones(4), 0, CPU)
    del x
    assert len(prog) == 1           # a view keeps the storage
    del view
    assert len(prog) == 0
    # it served two calls: a new bank of that shape is read in place too
    y = torch.ones(4, 8)
    prog(y, torch.ones(4), 0, CPU)
    assert prog._cache and all(e.buffers["x"] is None
                               for e in prog._cache.values())


def test_fresh_banks_are_copied_after_the_first(card):
    prog = make()
    w = torch.ones(5)
    outs = []
    for i in range(4):
        outs.append(prog(torch.full((5, 2), float(i)), w, 0, CPU)["y"])
    assert prog.captures == 2       # in place once, then one copied entry
    assert prog.replays == 2
    assert [o.tolist() for o in outs] == [[2.0 * i] * 5 for i in range(4)]


def test_a_pool_is_not_reused_after_its_last_graph(card):
    """A capture after every graph of the program went (their banks were
    freed) takes a new memory pool: torch's allocator refuses the old."""
    prog = make()
    for i in range(2):
        prog(torch.ones(3, 2), torch.ones(3), i, CPU)  # each bank dies
    assert len(prog) == 0
    x = torch.ones(3, 2)
    prog(x, torch.ones(3), 0, CPU)
    prog(x, torch.ones(3), 1, CPU)  # shares the live pool
    assert len(prog) == 2


def test_lru_bound(card, monkeypatch):
    monkeypatch.setattr(jit, "MAXSIZE", 2)
    prog = make()
    x = torch.ones(3, 3)
    for k in range(3):
        prog(x, torch.ones(3), k, CPU)
    assert len(prog) == 2
    prog(x, torch.ones(3), 0, CPU)  # the oldest went: captured again
    assert prog.captures == 4
    prog(x, torch.ones(3), 2, CPU)
    assert prog.captures == 4


def test_disable_jit_and_devices_the_card_does_not_take(card, monkeypatch):
    prog = make()
    x = torch.ones(2, 2)
    with jit.disable_jit():
        with jit.disable_jit():
            prog(x, torch.ones(2), 0, CPU)
        prog(x, torch.ones(2), 0, CPU)
    assert prog.captures == 0
    monkeypatch.setattr(StubCard, "takes", staticmethod(lambda dev: False))
    prog(x, torch.ones(2), 0, CPU)
    assert prog.captures == 0
    with pytest.raises(TypeError, match="tensors or None"):
        monkeypatch.setattr(StubCard, "takes",
                            staticmethod(lambda dev: True))
        prog(x, [1.0, 1.0], 0, CPU)


def test_nested_program_is_part_of_the_outer(card):
    inner = make()

    @jit.program(inplace=("x",))
    def outer(x, device):
        return inner(x, torch.ones(x.shape[0]), 1, device)["y"] * 2

    x = torch.ones(3, 2)
    for _ in range(3):
        assert outer(x, CPU).tolist() == [6.0] * 3
    assert (outer.captures, inner.captures) == (1, 0)


def test_threads_warm_up_and_capture_one_at_a_time(card):
    """Two threads calling two programs at new keys at once: their warm-ups
    and captures never overlap (on the card they may share a pooled
    stream), and each result is the eager one."""
    import threading
    import time

    inside, most = [0], [0]
    guard = threading.Lock()

    def body(x, k):
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(0.002)
        with guard:
            inside[0] -= 1
        return x * k

    progs = [jit.program(static=("k",))(
        lambda x, k, device: body(x, k)) for _ in range(2)]
    rounds = 6
    start = threading.Barrier(2)
    got = [[], []]

    def work(i):
        x = torch.full((3,), float(i + 1))
        for k in range(rounds):
            start.wait(timeout=30)
            got[i].append(progs[i](x, k, CPU))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1
    assert [p.captures for p in progs] == [rounds, rounds]
    for i in range(2):
        assert [g.tolist() for g in got[i]] == [[(i + 1.0) * k] * 3
                                                for k in range(rounds)]


def test_an_entry_goes_when_its_storage_dies_under_another_capture(card):
    """A bank that dies inside another thread's capture drops its entry
    without waiting on the program's lock, which a thread waiting for the
    capture lock holds."""
    import threading

    prog = make()
    bank = [torch.ones(3, 2)]
    prog(bank[0], torch.ones(3), 0, CPU)
    holding, release = threading.Event(), threading.Event()

    def hold():
        with prog._lock:
            holding.set()
            release.wait(timeout=30)

    def drop():
        with jit._capturing:
            bank.clear()          # the entry's callback runs here

    holder, dropper = (threading.Thread(target=f) for f in (hold, drop))
    holder.start()
    try:
        assert holding.wait(timeout=30)
        dropper.start()
        dropper.join(timeout=5)
        assert not dropper.is_alive()
    finally:
        release.set()
        holder.join(timeout=30)
        dropper.join(timeout=30)
    assert len(prog) == 0


def test_failed_capture_raises_and_restores(card):
    prog = make()
    x = torch.ones(2, 2)
    StubCard.fail = True
    with pytest.raises(RuntimeError, match="capturing"):
        prog(x, torch.ones(2), 0, CPU)
    assert len(prog) == 0 and prog.captures == 0
    StubCard.fail = False
    prog(x, torch.ones(2), 0, CPU)
    assert len(prog) == 1


def test_program_needs_a_device_argument():
    with pytest.raises(TypeError, match="device"):
        jit.program()(lambda x: x)


# ---------------------------------------------------------------------------
# the port's programs through the stub against their eager calls
# ---------------------------------------------------------------------------

def fields_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), f.name


def sf7_bank(B=3, frames=1, seed=0):
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (B * frames, 8)).astype(np.uint8)
    iq = api.modulate(api.encode(pay, cfg, device="cpu"), cfg)
    T = api.required_samples(cfg)
    x = torch.zeros((B, frames * T), dtype=torch.complex64)
    for j in range(frames):
        n = min(iq.shape[1], T - 70)
        x[:, j * T + 70 : j * T + 70 + n] = iq[j::frames][:, :n]
    noise = rng.standard_normal((2, B, frames * T)).astype(np.float32)
    x += 0.05 * torch.complex(torch.from_numpy(noise[0]),
                              torch.from_numpy(noise[1]))
    return cfg, x, pay


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("kw", [{}, {"debug": True}, {"spectra": True},
                                {"max_frames": 3}])
def test_demodulate_captured_equals_eager(card, fused, kw):
    cfg, x, pay = sf7_bank(frames=2 if "max_frames" in kw else 1)
    with jit.disable_jit():
        want = api.demodulate(x, cfg, fused=fused, **kw)
        one = api.demodulate(x[0], cfg, fused=fused, **kw)
    for _ in range(3):
        fields_equal(api.demodulate(x, cfg, fused=fused, **kw), want)
        fields_equal(api.demodulate(x[0], cfg, fused=fused, **kw), one)
    if "spectra" in kw:
        with jit.disable_jit():
            soft = api.decode_soft(want.fft_mag2, cfg)
        for _ in range(2):
            fields_equal(api.decode_soft(want.fft_mag2, cfg), soft)
    hard = api.decode(want.symbols.reshape(-1, cfg.mtu), cfg)
    if "max_frames" not in kw:
        assert api.extract_payloads(hard) == [bytes(p) for p in pay]


def test_decode_and_host_data_captured_equal_eager(card, monkeypatch):
    """decode is no captured program: with the card stubbed, each call
    (host data, a single frame, the Gray passthrough) is one run of its
    device's route, captures nothing and equals the call under
    disable_jit()."""
    cfg, x, pay = sf7_bank()
    dem = api.demodulate(x, cfg)
    sym = dem.symbols.numpy()
    calls = route_calls(monkeypatch)
    with jit.disable_jit():
        want = api.decode(sym, cfg, device="cpu")
        one = api.decode(torch.from_numpy(sym[0]), cfg)
    c0 = jit.captures()
    for _ in range(2):
        fields_equal(api.decode(sym, cfg, device="cpu"), want)
        fields_equal(api.decode(torch.from_numpy(sym[0]), cfg), one)
    assert jit.captures() == c0 and len(calls) == 6
    assert api.extract_payloads(want) == [bytes(p) for p in pay]
    plain = lora_tpu_torch.LoRaConfig(sf=7, interleaving=False)
    with jit.disable_jit():
        gray = api.decode(sym, plain, device="cpu")
    fields_equal(api.decode(sym, plain, device="cpu"), gray)
    assert jit.captures() == c0 and len(calls) == 8


def test_encode_captured_equals_eager(card):
    from lora_tpu_torch.models import encoder as tenc

    rng = np.random.default_rng(12)
    pay = rng.integers(0, 256, (4, 21)).astype(np.uint8)
    for kw in (dict(sf=7, cr="4/8"), dict(sf=8, cr="4/5", crc=False),
               dict(sf=7, cr="4/6", explicit_header=False, data_length=21)):
        cfg = lora_tpu_torch.LoRaConfig(**kw)
        with jit.disable_jit():
            want = api.encode(pay, cfg, device="cpu")
            short = api.encode(torch.from_numpy(pay[0]), cfg, payload_len=9)
        for _ in range(2):
            assert torch.equal(api.encode(pay, cfg, device="cpu"), want)
            assert torch.equal(api.encode(torch.from_numpy(pay[0]), cfg,
                                          payload_len=9), short)
        np.testing.assert_array_equal(want.numpy(), np.asarray(
            japi_encode(pay, kw)).astype(np.int32))
    assert tenc._encode.replays >= 6


def japi_encode(pay, kw):
    from lora_tpu import api as japi

    return japi.encode(jnp.asarray(pay), lora_tpu.LoRaConfig(**kw))


def test_dcblock_captured_equals_eager_across_a_seam(card):
    from lora_tpu_torch.ops import dcblock as tdc

    rng = np.random.default_rng(13)
    x = torch.from_numpy((rng.standard_normal((3, 5000)) + 2.0 + 1j * (
        rng.standard_normal((3, 5000)) - 1.0)).astype(np.complex64))
    with jit.disable_jit():
        y0, s0 = tdc.dcblock(x[:, :2100], device="cpu")
        y1, s1 = tdc.dcblock(x[:, 2100:], state=s0, device="cpu")
    for _ in range(3):
        g0, t0 = tdc.dcblock(x[:, :2100].clone(), device="cpu")
        g1, t1 = tdc.dcblock(x[:, 2100:].clone(), state=t0, device="cpu")
        for a, b in ((g0, y0), (g1, y1), (t0.re, s0.re), (t0.im, s0.im),
                     (t1.re, s1.re), (t1.im, s1.im)):
            assert torch.equal(a, b)
    assert tdc._dcblock.replays >= 2


@pytest.mark.parametrize("fused", ["auto", "off", "bf16"])
def test_channelized_demodulate_captured_equals_eager(card, fused):
    from lora_tpu_torch.ops import channelizer as chz

    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    M = api.required_samples(cfg)
    iq = api.modulate(api.encode(np.arange(4, dtype=np.uint8)[None], cfg,
                                 device="cpu"), cfg)
    u = torch.zeros((1, 8, M), dtype=torch.complex64)
    u[0, 2, 40 : 40 + iq.shape[1]] = iq[0]
    wide, _ = chz.synthesize(u)
    with jit.disable_jit():
        want, state = api.channelized_demodulate(wide, 8, cfg, fused=fused)
        want2, state2 = api.channelized_demodulate(wide, 8, cfg, fused=fused,
                                                   state=state)
    for _ in range(2):
        got, s = api.channelized_demodulate(wide, 8, cfg, fused=fused)
        fields_equal(got, want)
        assert torch.equal(s, state)
        got, s = api.channelized_demodulate(wide, 8, cfg, fused=fused,
                                            state=state)
        fields_equal(got, want2)
        assert torch.equal(s, state2)
    assert bool(want.found[0, 2])


@pytest.mark.parametrize("kw", [{"soft": True}, {"max_frames": 3},
                                {"fused": "off"}])
def test_stream_steps_captured_equal_eager(card, kw):
    from lora_tpu_torch.runtime import StreamDemodulator, stream

    cfg, x, _ = sf7_bank(B=2, frames=3, seed=4)
    blocks = [x[:, i : i + 3000].numpy() for i in range(0, x.shape[1], 3000)]
    runs = []
    for eager in (True, False):
        with jit.disable_jit() if eager else contextlib.nullcontext():
            sd = StreamDemodulator(cfg, 2, device="cpu", **kw)
            frames = list(sd.pump(iter(blocks))) + sd.flush()
        runs.append([(f.channel, f.t_start, tuple(f.symbols.tolist()),
                      f.confidence) for f in frames])
    assert runs[0] == runs[1] and len(runs[0]) >= 4
    assert stream._step.replays > 0


def test_slab_bank_copies_into_one_program(card):
    from lora_tpu_torch.models import demodulator as dm
    from lora_tpu_torch.runtime import demodulate_bank

    cfg, x, _ = sf7_bank(B=5)
    c0 = dm._demod_whole.captures
    got = demodulate_bank(x.real.numpy(), x.imag.numpy(), cfg, slab=2,
                          device="cpu")
    with jit.disable_jit():
        want = demodulate_bank(x.real.numpy(), x.imag.numpy(), cfg, slab=2,
                               device="cpu")
    fields_equal(got, want)
    # here the slabs lie on the program's device: the first is read in
    # place, the rest copied into one entry; on the card every slab is a
    # host tensor copied into one entry's buffer (tests/test_torch_cuda.py)
    assert dm._demod_whole.captures - c0 == 2


def test_cpu_calls_are_the_same_with_and_without_disable_jit():
    cfg, x, pay = sf7_bank()
    c0 = jit.captures()
    with jit.disable_jit():
        want = api.demodulate(x, cfg, spectra=True)
    fields_equal(api.demodulate(x, cfg, spectra=True), want)
    fields_equal(api.decode_soft(want.fft_mag2, cfg),
                 api.decode_soft(want.fft_mag2, cfg))
    assert jit.captures() == c0


# ---------------------------------------------------------------------------
# spans: the entry points' and the programs' ranges in a profiler session
# ---------------------------------------------------------------------------

def lora_spans(prof) -> list:
    """The lora.* ranges a profiler recorded, each as (its name, the name of
    the innermost lora.* range around it, or None), sorted."""
    out = []
    for e in prof.events():
        if not e.name.startswith("lora."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("lora."):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return sorted(out, key=str)


def recorded(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return lora_spans(prof)


def entry_call(entry):
    """(a call of the entry point on a small bank, its program's name)."""
    cfg, x, _ = sf7_bank()
    if entry == "decode":  # kernel G's one launch, no program
        sym = api.demodulate(x, cfg).symbols
        return lambda: api.decode(sym, cfg), None
    if entry == "demodulate":
        return lambda: api.demodulate(x, cfg), "_demod_whole"
    from lora_tpu_torch.ops import channelizer as chz

    u = torch.zeros((1, 4, x.shape[1]), dtype=torch.complex64)
    u[0, :3] = x
    wide, _ = chz.synthesize(u)
    return (lambda: api.channelized_demodulate(wide, 4, cfg),
            "_channelize_demod_step")


def route_calls(monkeypatch) -> list:
    """A list that grows by one at each run of decode's route on the CPU
    (models/decoder.decode_plain, where the card launches kernel G once)."""
    calls = []
    real = tdec.decode_plain

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(tdec, "decode_plain", spy)
    return calls


def nested(entry, prog, children) -> list:
    """The spans of a call of the entry point: its own and, where it runs a
    program, the program's and its steps inside it."""
    top, mid = f"lora.{entry}", f"lora.program:{prog}"
    if prog is None:
        return [(top, None)]
    return sorted([(top, None), (mid, top)]
                  + [(f"lora.program.{c}", mid) for c in children], key=str)


@pytest.mark.parametrize("entry", ["decode", "demodulate",
                                   "channelized_demodulate"])
def test_a_first_call_spans_its_capture(card, entry):
    call, prog = entry_call(entry)
    jit.clear()
    assert recorded(call) == nested(entry, prog, ("lookup", "capture"))


@pytest.mark.parametrize("entry, children", [
    ("decode", ()),
    # the bank, and the wideband block, read in place: nothing copied in
    ("demodulate", ("lookup", "launch", "clone_out")),
    ("channelized_demodulate", ("lookup", "launch", "clone_out")),
])
def test_a_replay_spans_its_steps(card, entry, children):
    call, prog = entry_call(entry)
    call()
    assert recorded(call) == nested(entry, prog, children)


def test_without_a_profiler_a_span_is_the_one_no_op(card, monkeypatch):
    from lora_tpu_torch.utils import trace

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("lora.decode") is trace.span("x") is trace._OFF
    call, _ = entry_call("decode")
    calls = route_calls(monkeypatch)
    c0 = jit.captures()
    for _ in range(3):
        call()
    assert len(calls) == 3 and jit.captures() == c0


@pytest.mark.parametrize("route", ["cpu", "disable_jit"])
def test_eager_calls_span_no_program(card, monkeypatch, route):
    if route == "cpu":
        monkeypatch.setattr(jit, "_card", jit._Card)  # the CPU: eager
    call, _ = entry_call("decode")
    calls = route_calls(monkeypatch)
    c0 = jit.captures()
    with jit.disable_jit() if route == "disable_jit" else \
            contextlib.nullcontext():
        got = recorded(call)
    assert got == [("lora.decode", None)]
    assert jit.captures() == c0 and len(calls) == 1


# ---------------------------------------------------------------------------
# the sync-free rewrites against lora_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thresh", [-30.0, -29.9, 0.1, 7.3, -1e-3])
def test_squelch_threshold_bit_equal_one_ulp_either_side(thresh):
    t32 = np.float32(thresh)
    vals = np.array([np.nextafter(t32, np.float32(-np.inf)), t32,
                     np.nextafter(t32, np.float32(np.inf))], np.float32)
    for a in (np.float32(thresh) + np.zeros(3, np.float32), vals):
        x = torch.from_numpy(a)
        lt = (x < cuda_demod.squelch(thresh)).numpy()
        gt = (x > cuda_demod.squelch(thresh)).numpy()
        old = torch.tensor(thresh, dtype=torch.float32)
        np.testing.assert_array_equal(lt, (x < old).numpy())
        np.testing.assert_array_equal(gt, (x > old).numpy())
        np.testing.assert_array_equal(
            lt, np.asarray(jnp.asarray(a) < jnp.float32(thresh)))
        np.testing.assert_array_equal(
            gt, np.asarray(jnp.asarray(a) > jnp.float32(thresh)))
    assert lt.tolist() == [True, False, False]


def test_crc16_byte_step_is_one_table_step():
    T = tables.crc16_table()
    res = np.arange(1 << 16, dtype=np.int64)
    step = ((res << 8) & 0xFFFF) ^ T[res >> 8]
    want = np.asarray(jcodes._crc16_shift8(jnp.asarray(res, jnp.int32)))
    np.testing.assert_array_equal(step, want)
    assert [_bitref._crc16_shift8(int(r)) for r in res[::257]] == \
        step[::257].tolist()
    v = tables.crc_whitening(300)
    for i in range(300):
        assert v[i + 1] == (_bitref._xsum8(int(v[i]) & 0xB8)
                            | (int(v[i]) << 1)) & 0xFF


@settings(max_examples=40, deadline=None, database=None)
@given(st.data())
def test_payload_crc_matches_jax(data):
    L = data.draw(st.integers(0, 40))
    lead = tuple(data.draw(st.lists(st.integers(1, 3), max_size=2)))
    n = int(np.prod(lead)) if lead else 1
    flat = data.draw(st.lists(st.integers(0, 255), min_size=n * L,
                              max_size=n * L))
    b = np.array(flat, np.int64).reshape(*lead, L)
    lengths = np.array(data.draw(st.lists(st.integers(-2, L + 2),
                                          min_size=n, max_size=n)),
                       np.int64).reshape(lead)
    got = codes.sx1272_data_checksum(torch.from_numpy(b)).numpy()
    want = np.asarray(jcodes.sx1272_data_checksum(jnp.asarray(b, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    got = tdec.masked_crc16(torch.from_numpy(b),
                            torch.from_numpy(lengths)).numpy()
    want = np.asarray(jdec._masked_crc16(jnp.asarray(b, jnp.int32),
                                         jnp.asarray(lengths, jnp.int32)))
    np.testing.assert_array_equal(got, want)


def test_tables_are_uploaded_once_a_device():
    a = codes.lut("whiten", CPU)
    assert codes.lut("whiten", CPU) is a
    np.testing.assert_array_equal(a.numpy(), tables.WHITEN_SEQ)
    assert codes.lut("enc", CPU, 3) is codes.lut("enc", CPU, 3)


def test_table_backed_codecs_match_jax():
    rng = np.random.default_rng(11)
    nib = rng.integers(0, 16, (4, 20))
    cw = rng.integers(0, 256, (4, 24))
    rdd_t = rng.integers(0, 8, (4, 1))
    for rdd in range(5):
        np.testing.assert_array_equal(
            codes.fec_encode(torch.from_numpy(nib), rdd).numpy(),
            np.asarray(jcodes.fec_encode(jnp.asarray(nib), rdd)))
        for got, want in zip(
                codes.fec_decode(torch.from_numpy(cw), rdd),
                jcodes.fec_decode(jnp.asarray(cw), rdd)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            codes.whiten(torch.from_numpy(cw), 3, rdd).numpy(),
            np.asarray(jcodes.whiten(jnp.asarray(cw), 3, rdd)))
    for got, want in zip(codes.fec_decode(torch.from_numpy(cw),
                                          torch.from_numpy(rdd_t)),
                         jcodes.fec_decode(jnp.asarray(cw),
                                           jnp.asarray(rdd_t))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for ppm, rdd in ((7, 4), (10, 1), (12, 3)):
        cwi = rng.integers(0, 1 << (4 + rdd), (3, 2 * ppm))
        sym = codes.interleave(torch.from_numpy(cwi), ppm, rdd)
        np.testing.assert_array_equal(
            sym.numpy(), np.asarray(jcodes.interleave(jnp.asarray(cwi), ppm,
                                                      rdd)))
        np.testing.assert_array_equal(
            codes.deinterleave(sym, ppm, rdd).numpy(), cwi)


@pytest.mark.parametrize("ferr", [0.0, 0.37, -1.25, 3])
def test_rotator_of_a_number_equals_its_tensor_and_jax(ferr):
    """The angle of a number ferr, formed on the host, is bit-equal to the
    angle of a tensor ferr and to lora_tpu's (lora_tpu/ops/detect.py:47-48);
    cos and sin then run in each framework's own math library."""
    N = 128
    got = det_ops.rotator_angle(ferr, N)
    assert torch.equal(got, det_ops.rotator_angle(
        torch.tensor(ferr, dtype=torch.float32), N))
    n = jnp.arange(N, dtype=jnp.float32)
    want = (-2 * np.pi / N) * jnp.asarray(ferr, jnp.float32)[..., None] * n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0]
                                  if np.ndim(want) > 1 else np.asarray(want))
    assert torch.equal(det_ops.rotator(ferr, N),
                       det_ops.rotator(torch.tensor(float(ferr)), N))
