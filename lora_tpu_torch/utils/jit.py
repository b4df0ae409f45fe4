"""Captured programs: the port's counterpart of jax.jit(static_argnames=...)
and jax.disable_jit().

`program(static=..., inplace=...)` wraps a function of tensors in a cache of
torch.cuda.CUDAGraphs, one per key, so that a call on the card replays one
graph instead of dispatching its ops one by one from the host.  Every
function it wraps takes a `device` argument, the device the call runs on.

The key is the values of the static arguments (`device` among them) and,
for each tensor argument, its shape, dtype, strides and device.  A tensor
named in `inplace` (an IQ bank) that lies on the call's device is read where
it lies: its address joins its key, and the entry holds a weak reference to
its storage and goes when the storage does, so the address cannot be reused
under a live entry and the cache never keeps a bank alive.  Every other
tensor argument is copied into a buffer the entry owns (host data through
its host-to-device copy, which that data needs anyway).  An argument of a
shape whose in-place entry served one call and went (a tensor made afresh
for each call) is copied too from then on, into one entry's buffer, so that
such callers replay instead of capturing at every call.

A call runs `fn` eagerly when its device is not a CUDA device, inside
`disable_jit()`, and inside a program's warm-up or capture (a program called
by another is part of the outer graph).  Otherwise the first call at a key
runs `fn` once eagerly on a side stream (the warm-up, which fills the
lru_cached constants on the device, cuFFT plans and the kernels' launch
queries, and whose result that call returns), then captures `fn` into a
graph; every later call copies its arguments into the entry's buffers,
replays, and returns clones of the graph's outputs, so that a replay never
changes a result returned before.  A failed capture raises: there is no
fallback, and the only eager route on the card is `disable_jit()`.

Graphs capture with capture_error_mode "thread_local", so that another
thread (the stream's ingest thread) may copy and pin memory meanwhile.
Programs warm up and capture from one thread at a time, under one lock
for the process: the capture and warm-up streams are torch's pooled
streams, which two threads' programs may share, and a stream that one
thread captures on refuses another's work
(cudaErrorStreamCaptureIsolation).  Replays and eager work do not take
that lock.  A program's graphs share one memory pool: replays run one at a
time on the caller's stream (a lock, and a wait when the stream changes),
and their outputs are cloned before the next replay can overwrite them.

Spans (utils/trace.span, recorded only while a torch.profiler session
records): a call on the card is `lora.program:<fn name>`, holding
`lora.program.lookup` (the key, this program's lock, the sweep), then
`lora.program.capture` at a new key, or `lora.program.copy_in` (only for an
entry with buffers), `lora.program.launch` (the graph's replay) and
`lora.program.clone_out`.  A call run eagerly has none: a span inside a
captured function would run at its capture only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import inspect
import threading
import weakref

import torch

from . import trace

# entries a program keeps, least recently used first out
MAXSIZE = 8

_local = threading.local()
# held over every warm-up and capture (see the module's note)
_capturing = threading.RLock()
_programs: "weakref.WeakSet[Program]" = weakref.WeakSet()


def _eager_depth() -> int:
    return getattr(_local, "eager", 0)


@contextlib.contextmanager
def disable_jit():
    """Run every program called in this thread eagerly, op by op: the eager
    route on the card (jax.disable_jit)."""
    _local.eager = _eager_depth() + 1
    try:
        yield
    finally:
        _local.eager -= 1


# ---------------------------------------------------------------------------
# outputs as leaves and a rebuild spec
# ---------------------------------------------------------------------------

def _flatten(obj, leaves: list):
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return "t"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("d", type(obj), tuple(
            (f.name, _flatten(getattr(obj, f.name), leaves))
            for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return ("s", type(obj), tuple(_flatten(x, leaves) for x in obj))
    if isinstance(obj, dict):
        return ("m", tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return ("c", obj)
    raise TypeError(f"a program returns tensors, None, numbers, tuples, "
                    f"dicts and dataclasses of them, not {type(obj)}")


def _build(spec, it):
    if spec == "t":
        return next(it)
    tag = spec[0]
    if tag == "d":
        return spec[1](**{n: _build(s, it) for n, s in spec[2]})
    if tag == "s":
        return spec[1](_build(s, it) for s in spec[2])
    if tag == "m":
        return {k: _build(s, it) for k, s in spec[1]}
    return spec[1]


# ---------------------------------------------------------------------------
# the card's side: CUDA graphs and streams (tests on the CPU stub it)
# ---------------------------------------------------------------------------

class _Card:
    """Every torch.cuda call of a program, in one place."""

    @staticmethod
    def takes(dev: torch.device) -> bool:
        return dev.type == "cuda"

    @staticmethod
    def resolve(dev: torch.device) -> torch.device:
        if dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return dev

    device = staticmethod(torch.cuda.device)
    current_stream = staticmethod(torch.cuda.current_stream)
    new_stream = staticmethod(torch.cuda.Stream)
    stream = staticmethod(torch.cuda.stream)
    pool = staticmethod(torch.cuda.graph_pool_handle)
    record_stream = staticmethod(torch.Tensor.record_stream)

    @staticmethod
    def capture(fn, args: dict, pool):
        """fn(**args) captured into a new graph -> (graph, its outputs)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = fn(**args)
        return graph, out


_card = _Card


@dataclasses.dataclass
class _Entry:
    graph: "torch.cuda.CUDAGraph"
    buffers: dict          # name -> the entry's own copy target (or None)
    outputs: list          # the graph's output tensors
    spec: object           # their structure
    dev: torch.device = None
    calls: int = 1
    base: tuple = ()       # the key without addresses
    watch: list = dataclasses.field(default_factory=list)  # storage weakrefs


def _meta(v, dev: torch.device):
    if v is None:
        return None
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"a program's non-static arguments are tensors or "
                        f"None, not {type(v)}")
    here = v.device == dev
    return (here, v.dtype, tuple(v.shape), tuple(v.stride()) if here else ())


class Program:
    """fn as a cache of CUDA graphs keyed by its static arguments and its
    tensors' layout (see the module's note).  `captures` counts the graphs
    captured and `replays` the calls that replayed one."""

    def __init__(self, fn, static, inplace=()):
        self.fn = fn
        self.sig = inspect.signature(fn)
        if "device" not in self.sig.parameters:
            raise TypeError(f"{fn.__name__}: a program takes `device`")
        self.static = tuple(static) + (() if "device" in static
                                       else ("device",))
        self.inplace = frozenset(inplace)
        self.captures = 0
        self.replays = 0
        self._cache: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()
        self._copied_bases: set = set()
        self._dead: list = []   # keys whose in-place storage went
        self._lock = threading.RLock()
        self._pools: dict = {}
        self._side: dict = {}
        self._last_stream = None
        self._span = f"lora.program:{fn.__name__}"
        functools.update_wrapper(self, fn)
        _programs.add(self)

    # -- lookup --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        a = self.sig.bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        dev = torch.device(a["device"])
        if not _card.takes(dev) or _eager_depth():
            return self.fn(**a)
        with trace.span(self._span), contextlib.ExitStack() as held:
            with trace.span("lora.program.lookup"):
                dev = _card.resolve(dev)
                tensors = {n: v for n, v in a.items() if n not in self.static}
                base = (tuple(a[n] for n in self.static),
                        tuple(_meta(v, dev) for v in tensors.values()))
                homes = tuple(n for n, v in tensors.items()
                              if n in self.inplace and v is not None
                              and v.device == dev)
                held.enter_context(self._lock)
                self._sweep()
                key = (base, tuple(tensors[n].data_ptr() for n in homes))
                if (key not in self._cache and homes
                        and base in self._copied_bases):
                    key, homes = (base, "copied"), ()
                entry = self._cache.get(key)
            if entry is None:
                with trace.span("lora.program.capture"):
                    return self._capture(a, tensors, homes, dev, key, base)
            self._cache.move_to_end(key)
            return self._replay(entry, tensors, dev)

    # -- capture -------------------------------------------------------------
    def _pool(self, dev):
        """The memory pool this program's graphs on dev share: a new one
        when none of them lives, since a pool goes with its last graph."""
        if not any(e.dev == dev for e in self._cache.values()):
            self._pools[dev] = _card.pool()
        return self._pools[dev]

    def _capture(self, a, tensors, homes, dev, key, base):
        with _card.device(dev):
            buffers = {}
            for n, v in tensors.items():
                if v is None or n in homes:
                    buffers[n] = None
                else:
                    buffers[n] = torch.empty(v.shape, dtype=v.dtype,
                                             device=dev)
                    buffers[n].copy_(v, non_blocking=True)
            args = {**a, **{n: (tensors[n] if b is None else b)
                            for n, b in buffers.items()}}
            main = _card.current_stream(dev)
            _local.eager = _eager_depth() + 1
            try:
                with _capturing:
                    side = self._side.setdefault(dev, _card.new_stream(dev))
                    side.wait_stream(main)
                    with _card.stream(side):
                        out = self.fn(**args)  # the warm-up, returned
                    main.wait_stream(side)
                    warm: list = []
                    spec = _flatten(out, warm)
                    for t in warm:
                        if t.device == dev:  # made on the side stream
                            _card.record_stream(t, main)
                    graph, captured = _card.capture(self.fn, args,
                                                    self._pool(dev))
            finally:
                _local.eager -= 1
            outputs: list = []
            if _flatten(captured, outputs) != spec:
                raise RuntimeError(f"{self.fn.__name__}: the capture returned "
                                   "another structure than the warm-up")
            for t in outputs:
                if t.device != dev:
                    raise RuntimeError(f"{self.fn.__name__}: a captured "
                                       f"program returned a tensor on "
                                       f"{t.device}")
        entry = _Entry(graph, buffers, outputs, spec, dev, base=base)
        for n in homes:
            entry.watch.append(weakref.ref(tensors[n].untyped_storage(),
                                           functools.partial(self._gone, key)))
        self._cache[key] = entry
        self.captures += 1
        while len(self._cache) > MAXSIZE:
            self._cache.popitem(last=False)
        self._last_stream = main
        return out

    def _gone(self, key, _ref) -> None:
        """A storage an entry reads in place was freed: its entry goes at
        the next look-up.  No lock is taken here: the storage may die in a
        thread that holds the capture lock while another, holding this
        program's, waits for it."""
        self._dead.append(key)

    def _sweep(self) -> None:
        """Drop the entries whose storage went, and copy arguments of the
        shape of one that served a single call from now on (under _lock)."""
        while self._dead:
            entry = self._cache.pop(self._dead.pop(), None)
            if entry is not None and entry.calls <= 1:
                self._copied_bases.add(entry.base)

    # -- replay --------------------------------------------------------------
    def _replay(self, entry: _Entry, tensors: dict, dev):
        with _card.device(dev):
            stream = _card.current_stream(dev)
            if self._last_stream is not None and self._last_stream != stream:
                stream.wait_stream(self._last_stream)
            copies = [(b, tensors[n]) for n, b in entry.buffers.items()
                      if b is not None]
            if copies:
                with trace.span("lora.program.copy_in"):
                    for b, v in copies:
                        b.copy_(v, non_blocking=True)
            with trace.span("lora.program.launch"):
                entry.graph.replay()
            with trace.span("lora.program.clone_out"):
                outs = [t.clone() for t in entry.outputs]
            self._last_stream = stream
        entry.calls += 1
        self.replays += 1
        return _build(entry.spec, iter(outs))

    def clear(self) -> None:
        """Drop every graph, buffer and pool of this program."""
        with self._lock:
            self._cache.clear()
            self._dead.clear()
            self._copied_bases.clear()
            self._pools.clear()
            self._last_stream = None

    def __len__(self) -> int:
        with self._lock:
            self._sweep()
            return len(self._cache)


def program(static=(), inplace=()):
    """Decorator: fn as a Program (see the module's note)."""
    return lambda fn: Program(fn, static, inplace)


def clear() -> None:
    """Drop the graphs, buffers and pools of every program."""
    for p in list(_programs):
        p.clear()


def captures() -> int:
    """Graphs captured so far by all programs."""
    return sum(p.captures for p in list(_programs))
