"""Streaming runtime: long captures -> all frames, one device step at a time
(port of lora_tpu/runtime/stream.py).

A fixed demod window slides over each channel's stream: every device step
demodulates one window per channel (at most max_frames frames), then each
channel's read pointer advances by what its frames consumed, or by the
safe no-frame stride.  The decisions of each step are a host loop over the
channels, the same as the JAX package's.

The samples live on the device as complex64 (`_Ring`): the window of every
channel, at its own pointer, is cut by one gather whose index has one entry
per channel, over a ring whose first window-1 slots are mirrored past its
end, so that no window wraps.  Host blocks reach the ring through pinned
staging buffers (runtime/staging.py) and a non_blocking copy.  Everything
runs on the device's current stream, so a block appended while a step is
pending (pump) is copied after that step's window gather, and the ring a
step reads is never changed or freed under it.  A step is one program
(`_step`, utils/jit.py): on the card one captured graph that reads the ring
in place, the channels' slots its one small input, so that a ring that has
not grown replays one graph a step.

`StreamDemodulator.offsets` and the ring's contents describe the progress
completely: save_state / load_state write and read the JAX package's .npz
keys, so a checkpoint of either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import LoRaConfig
from ..models.decoder import OK, decode
from ..models.demodulator import _demod_whole, check_options, required_samples
from ..models.softdec import soft_symbols
from ..ops import cplx
from ..utils import debugcheck, jit
from .staging import Staging


@dataclasses.dataclass
class Frame:
    """One recovered frame."""

    channel: int
    t_start: int          # global sample index of the preamble start
    symbols: np.ndarray   # int16 demodulated data symbols (count entries;
    #                       soft streams carry the ML-corrected values)
    snr: float
    power: float
    freq_error: int
    payload: Optional[bytes] = None  # set by decode_frames
    status: Optional[int] = None
    data_start: int = 0   # global sample index of the first payload symbol
    confidence: Optional[float] = None  # soft-mode ML margin (softdec)
    hard_symbols: Optional[np.ndarray] = None  # soft mode: the argmax
    #                       symbols, kept for the false-positive guard
    #                       (decode_frames cross-checks CRC-less soft OKs)


class _Ring:
    """Circular store of a [B, *] complex64 bank on `device`.

    The global stream interval [base, end) is resident; global index g
    lives in slot g % cap, and slots [0, window-1) are mirrored in
    [cap, cap+window-1), so that every run of at most `window` samples is
    one contiguous slice of the store.  append writes at most two slices
    (wraparound) and their mirror, trim is pointer motion, and the capacity
    doubles only when a consumer lags."""

    def __init__(self, B: int, cap: int, window: int, device):
        cap = 1 << max(int(np.ceil(np.log2(max(cap, window, 2)))), 1)
        self.window = window
        self.buf = torch.zeros((B, cap + window - 1), dtype=torch.complex64,
                               device=device)
        self.base = 0   # global index of the oldest resident sample
        self.end = 0    # global index past the newest resident sample

    @property
    def cap(self) -> int:
        return self.buf.shape[1] - (self.window - 1)

    def _write(self, slot: int, x: torch.Tensor) -> None:
        k = x.shape[1]
        self.buf[:, slot : slot + k] = x
        m = min(slot + k, self.window - 1) - slot
        if m > 0:
            self.buf[:, self.cap + slot : self.cap + slot + m] = x[:, :m]

    def _place(self, start: int, x: torch.Tensor) -> None:
        """Write x [B, n] (n <= cap) at global index start."""
        n = x.shape[1]
        i = start % self.cap
        k = min(n, self.cap - i)
        self._write(i, x[:, :k])
        if n > k:
            self._write(0, x[:, k:])

    def _grow(self, need: int) -> None:
        new = self.cap
        while new < need:
            new *= 2
        n = self.end - self.base
        old = self.view(self.base, n)
        self.buf = torch.zeros((self.buf.shape[0], new + self.window - 1),
                               dtype=torch.complex64, device=self.buf.device)
        if n:
            self._place(self.base, old)

    def append(self, x: torch.Tensor) -> None:
        """Append x [B, n] on the ring's device."""
        n = x.shape[1]
        if self.end - self.base + n > self.cap:
            self._grow(self.end - self.base + n)
        self._place(self.end, x)
        self.end += n

    def view(self, start: int, W: int) -> torch.Tensor:
        """Global [start, start+W) (resident) as [B, W]: a slice of the
        store, or a copy when it wraps past the mirror."""
        i = start % self.cap
        if i + W <= self.buf.shape[1]:
            return self.buf[:, i : i + W]
        k = self.cap - i
        return torch.cat([self.buf[:, i : self.cap],
                          self.buf[:, : W - k]], dim=1)

    def slots(self, offs) -> torch.Tensor:
        """The store's slots of global offsets [B] (host ints), int64 on the
        host: the step's small input."""
        return torch.from_numpy(np.asarray(offs, np.int64) % self.cap)

    def gather(self, offs, W: int) -> torch.Tensor:
        """Per-channel windows: global offsets [B] (host ints) -> complex64
        [B, W] (W <= window), one gather over the store's windows."""
        if W > self.window:
            raise ValueError(f"window {W} > the ring's {self.window}")
        return windows(self.buf, self.slots(offs).to(self.buf.device), W)

    def trim(self, new_base: int) -> None:
        self.base = min(max(self.base, new_base), self.end)


def windows(buf: torch.Tensor, slots: torch.Tensor, W: int) -> torch.Tensor:
    """buf [B, cap + window - 1] and one slot a row [B] -> the rows'
    windows [B, W], one gather over the store's windows."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    return buf.unfold(1, W, 1)[rows, slots]


_FIELDS = ("found", "payload_complete", "t_sync", "consumed", "count",
           "freq_error", "found_pre", "t_candidate")


@jit.program(static=("cfg", "window", "max_frames", "spectra", "soft",
                     "fused"), inplace=("buf",))
def _step(buf: torch.Tensor, slots: torch.Tensor, cfg: LoRaConfig,
          window: int, max_frames: int, spectra: bool, soft: bool,
          fused: str, device: torch.device):
    """One device step as one program: every channel's window cut from the
    ring at its slot, demodulated (models/demodulator._demod_whole), with
    soft=True the ML symbols (models/softdec.soft_symbols), and the fields
    the host decisions read packed into one int32 tensor [B, K, n] ->
    (DemodResult, packed)."""
    win = windows(buf, slots.to(device), window)
    dem = _demod_whole(win, cfg, False, max_frames, fused != "off", spectra,
                       device)
    B, K = buf.shape[0], max_frames
    cols = [getattr(dem, f).reshape(B, K).to(torch.int32) for f in _FIELDS]
    cols += [getattr(dem, f).reshape(B, K).view(torch.int32)
             for f in ("snr", "power")]
    parts = [torch.stack(cols, -1),
             dem.symbols.reshape(B, K, -1).to(torch.int32)]
    if soft:
        ssym, smarg = soft_symbols(dem.fft_mag2, cfg, device=device)
        parts += [ssym.reshape(B, K, -1),
                  smarg.reshape(B, K, 1).view(torch.int32)]
    return dem, torch.cat(parts, -1)


def _host_block(block) -> tuple:
    """A host block as numpy: ("planar", re, im) or ("complex", x), [B, n]."""
    if hasattr(block, "re") and hasattr(block, "im"):  # lora_tpu's IQ
        return "planar", np.asarray(block.re), np.asarray(block.im)
    if isinstance(block, (tuple, list)) and len(block) == 2:
        return "planar", np.asarray(block[0]), np.asarray(block[1])
    if isinstance(block, torch.Tensor):
        return "complex", block.detach().numpy()
    return "complex", np.asarray(block)


def _write_block(dst: np.ndarray, src: tuple) -> None:
    """The ingest conversion: a host block into complex64 dst [B, n]."""
    if src[0] == "planar":
        dst.real[...] = src[1]
        dst.imag[...] = src[2]
    else:
        np.copyto(dst, src[1])


class StreamDemodulator:
    """Multi-frame demodulation over a bank of unbounded channel streams.

    feed() sample blocks [B, n] (any n; host arrays, a planar (re, im)
    pair, or a tensor), then drain run(), or use :meth:`pump` to convert
    the next host blocks in a thread while the steps run.  The ring and the
    demodulation live on `device` (the card when None)."""

    def __init__(self, cfg: LoRaConfig, channels: int, max_frames: int = 1,
                 exact_advance: bool = False, soft: bool = False,
                 observer=None, device=None, fused: str = "auto"):
        check_options(fused)
        self.cfg = cfg
        # the demodulator's route (models/demodulator.demodulate): "off"
        # holds the kernels' steps against the plain versions on the card
        self.fused = fused
        self.B = channels
        self.device = cplx.resolve_device(device)
        # observer(step_dem, frames, offsets): called after every device
        # step with the step's DemodResult, the frames it emitted and the
        # per-channel global read pointers (utils/live.LiveTapView is one).
        # Must not mutate its arguments.
        self.observer = observer
        self.max_frames = max_frames  # frames recovered per device step
        # soft=True demodulates with spectra and emits ML-corrected symbols
        # (models/softdec); Frame.confidence carries the first block's margin
        self.soft = soft
        # exact_advance decodes found frames inside step() and advances by
        # the header's frame length instead of the mtu-padded symbol count,
        # recovering back-to-back frames the reference FSM's mtu consumption
        # (LoRaDemod.cpp:286-301) eats
        self.exact_advance = exact_advance
        self.window = required_samples(cfg)
        # the no-frame stride keeps enough tail to see again a preamble that
        # starts near the window's end
        self.stride = self.window - (cfg.preamble_symbols + 4) * cfg.N
        assert self.stride > 0
        self.offsets = np.zeros(channels, np.int64)  # global read pointers
        self._ring = _Ring(channels, 4 * self.window, self.window,
                           self.device)
        self._staging = self._new_staging(2)

    # -- input ---------------------------------------------------------------
    def _new_staging(self, n: int) -> Optional[Staging]:
        return Staging(n) if self.device.type == "cuda" else None

    def _stage(self, block, staging: Optional[Staging], stop=None):
        """Block -> an item for _ingest: (tensor, staging slot or None);
        None if `stop` was set.  Host blocks are converted here (into a
        pinned staging buffer for the card): pump runs this in its ingest
        thread, under the device step."""
        if isinstance(block, torch.Tensor) and block.device.type != "cpu":
            return block, None
        src = _host_block(block)
        shape = src[1].shape
        if len(shape) != 2 or shape[0] != self.B:
            raise ValueError(f"expected a block [{self.B}, n], got {shape}")
        if staging is None:
            out = torch.empty(shape, dtype=torch.complex64)
            _write_block(out.numpy(), src)
            return out, None
        got = staging.take(shape, stop)
        if got is None:
            return None
        slot, pinned = got
        _write_block(pinned.numpy(), src)
        return pinned, slot

    def _ingest(self, item, staging: Optional[Staging]) -> None:
        x, slot = item
        if slot is None:
            x = x.to(self.device, torch.complex64)
        else:
            x = x.to(self.device, non_blocking=True)
            staging.sent(slot, self.device)
        if x.dim() != 2 or x.shape[0] != self.B:
            raise ValueError(f"expected a block [{self.B}, n], got "
                             f"{tuple(x.shape)}")
        self._ring.append(x)

    def feed(self, block) -> None:
        """Append samples [B, n]: a host array (complex or a planar pair)
        or a tensor."""
        self._ingest(self._stage(block, self._staging), self._staging)

    def _trim(self) -> None:
        self._ring.trim(int(self.offsets.min()))

    def ready(self) -> bool:
        """True if every channel has a full window buffered."""
        return bool(np.all(self.offsets + self.window <= self._ring.end))

    # -- processing ----------------------------------------------------------
    def _step_begin(self):
        """Launch the current step: one program (`_step`, captured on the
        card) cuts every channel's window, demodulates it and packs what
        the decisions read.  It makes no host sync, so the step's kernels
        may still run when this returns.  -> (DemodResult, packed)."""
        spectra = self.soft or debugcheck.armed()
        step = _step(self._ring.buf, self._ring.slots(self.offsets), self.cfg,
                     self.window, self.max_frames, spectra, self.soft,
                     self.fused, self.device)
        if debugcheck.armed():
            debugcheck.check_demod(step[0], self.cfg, self.window)
        return step

    def step(self) -> list[Frame]:
        """One device step: demodulate the current window of every channel."""
        if not self.ready():
            return []
        return self._step_end(self._step_begin())

    def _fetch(self, packed) -> dict:
        """The step's fields as host numpy [B, K, ...], in one copy."""
        host = packed.cpu().numpy()
        mtu = self.cfg.mtu
        out = {f: host[..., i] for i, f in enumerate(_FIELDS)}
        out["snr"] = host[..., 8].view(np.float32)
        out["power"] = host[..., 9].view(np.float32)
        out["symbols"] = host[..., 10 : 10 + mtu]
        if self.soft:
            out["hard_symbols"] = out["symbols"]
            out["symbols"] = host[..., 10 + mtu : -1]
            out["confidence"] = host[..., -1].view(np.float32)
        return out

    def _step_end(self, step) -> list[Frame]:
        """Read a launched step's results, emit frames, advance."""
        K = self.max_frames
        dem, packed = step
        f = self._fetch(packed)
        found, complete, t_sync = f["found"], f["payload_complete"], f["t_sync"]
        consumed, counts, ferr = f["consumed"], f["count"], f["freq_error"]
        found_pre, t_cand = f["found_pre"], f["t_candidate"]
        snr, power, symbols = f["snr"], f["power"], f["symbols"]
        conf, hard_syms = f.get("confidence"), f.get("hard_symbols")

        N = self.cfg.N
        frames: list[Frame] = []
        for b in range(self.B):
            advance = None
            accepted_end = 0
            emitted = 0
            for k in range(K):  # candidates are time-ordered
                if not found[b, k]:
                    continue
                t_pre = int(t_sync[b, k]) - self.cfg.preamble_symbols * N
                # a previous frame's mtu overshoot may consume a few
                # preamble symbols, putting the nominal start before the
                # window: clamp for the ordering/room checks
                if max(t_pre, 0) < accepted_end:
                    continue  # overlaps an already-accepted frame
                if not complete[b, k]:
                    # the frame starts too late for its payload to fit this
                    # window: aim the next window at it
                    advance = max(t_pre, 1)
                    break
                n = int(counts[b, k])
                frames.append(Frame(
                    channel=b,
                    t_start=int(self.offsets[b]) + t_pre,
                    symbols=symbols[b, k, :n].astype(np.int16),
                    snr=float(snr[b, k]),
                    power=float(power[b, k]),
                    freq_error=int(ferr[b, k]),
                    data_start=int(self.offsets[b]) + int(consumed[b, k])
                    - n * N,
                    confidence=(float(conf[b, k]) if conf is not None
                                else None),
                    hard_symbols=(hard_syms[b, k, :n].astype(np.int16)
                                  if hard_syms is not None else None),
                ))
                accepted_end = max(int(consumed[b, k]), accepted_end + 1, 1)
                emitted += 1
            if advance is None:
                if emitted:
                    advance = accepted_end
                elif found_pre[b, 0]:
                    # coarse preamble hit but the sync scan ran off the
                    # window's end (frame tail not buffered yet).  The
                    # candidate marks the run's end (the preamble's tail),
                    # so aim a full preamble before it; advance at least N
                    # so that a noise candidate cannot stall the stream
                    advance = max(int(t_cand[b, 0])
                                  - (self.cfg.preamble_symbols + 2) * N, N)
                else:
                    advance = self.stride
            self.offsets[b] += advance
        if self.observer is not None:
            self.observer(dem, frames, self.offsets.copy())
        if self.exact_advance and frames:
            decode_frames(frames, self.cfg, self.device)
            for fr in frames:
                if fr.status == OK:
                    exact_end = fr.data_start + self.cfg.num_symbols(
                        len(fr.payload)) * N
                    # pull the pointer back from the mtu-padded advance,
                    # never past what was already consumed earlier
                    if exact_end < self.offsets[fr.channel]:
                        self.offsets[fr.channel] = max(exact_end,
                                                       fr.data_start)
        self._trim()
        return frames

    def run(self) -> Iterator[Frame]:
        """Drain every ready window."""
        while self.ready():
            yield from self.step()

    def pump(self, blocks, prefetch: int = 2) -> Iterator[Frame]:
        """Drive the stream from a block iterator: an ingest thread pulls
        blocks and converts them (into pinned staging buffers for the card)
        into a queue of at most `prefetch` blocks, while this thread, which
        owns the ring and the device, runs the steps and the per-channel
        decisions.  This thread appends the next block after step k's
        launch and before it reads step k back: the launch makes no host
        sync, so the host takes the next block while the step runs, and
        the block's copy to the card queues behind the step on the device's
        stream (`chip_smoke.py --profile` measures it, step 6a).  Yields
        frames in order; an exception of the source re-raises here.  A
        consumer that stops early releases the ingest thread within its
        0.2 s poll."""
        q: "queue.Queue[tuple[str, object]]" = queue.Queue(
            maxsize=max(prefetch, 1))
        stop = threading.Event()
        # a slot per queued block, one being converted, one being copied
        staging = self._new_staging(max(prefetch, 1) + 2)

        def put(item) -> bool:
            # a bounded put that watches the stop flag: a plain q.put would
            # block forever on the full queue of an abandoned generator
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                for blk in blocks:
                    item = self._stage(blk, staging, stop)
                    if item is None or not put(("blk", item)):
                        return
                put(("end", None))
            except BaseException as e:  # noqa: BLE001, re-raised in take()
                put(("err", e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        exhausted = False

        def take() -> None:
            nonlocal exhausted
            kind, item = q.get()
            if kind == "err":
                raise item  # type: ignore[misc]
            if kind == "end":
                exhausted = True
            else:
                self._ingest(item, staging)

        pending = None
        try:
            while True:
                if pending is not None:
                    if not exhausted:  # ingest while the device runs
                        take()
                    yield from self._step_end(pending)
                    pending = None
                elif self.ready():
                    pending = self._step_begin()
                elif not exhausted:
                    take()
                else:
                    t.join()
                    return
        finally:
            stop.set()

    # -- checkpoint / resume ---------------------------------------------------
    def save_state(self, path) -> None:
        """Write the progress: read pointers and the resident samples, as
        the JAX package writes them (offsets, base, planar float32 re/im).
        `path` is a file name or a binary file object."""
        n = self._ring.end - self._ring.base
        re, im = cplx.to_planar(self._ring.view(self._ring.base, n))
        np.savez(path, offsets=self.offsets, base=np.int64(self._ring.base),
                 re=re, im=im)

    def load_state(self, path) -> None:
        z = np.load(path)
        if z["re"].shape[0] != self.B:
            raise ValueError("checkpoint channel count mismatch")
        self.offsets = z["offsets"].astype(np.int64)
        self._ring = _Ring(self.B, max(4 * self.window, z["re"].shape[1]),
                           self.window, self.device)
        self._ring.base = self._ring.end = int(z["base"])
        self._ring.append(cplx.from_planar(z["re"], z["im"], self.device))

    def flush(self) -> list[Frame]:
        """End of capture: zero-pad so trailing complete frames demodulate,
        then drain.  (A frame whose payload runs past the real samples is
        unrecoverable and is not reported.)"""
        self._ring.append(torch.zeros((self.B, self.window),
                                      dtype=torch.complex64,
                                      device=self.device))
        return list(self.run())


def decode_frames(frames: list[Frame], cfg: LoRaConfig,
                  device=None) -> list[Frame]:
    """Batch-decode recovered frames on `device` (the card when None),
    padding their symbol vectors to one length; sets payload and status.

    Frames that carry hard_symbols (soft streams) get the false-positive
    guard: a CRC-less soft OK is reported SOFT_UNVERIFIED unless the
    hard-decision decode agrees (models/softdec.guard_soft_status)."""
    if not frames:
        return frames
    n = max(cfg.num_symbols(1), max(len(f.symbols) for f in frames))
    sym = np.zeros((len(frames), n), np.int32)
    for i, f in enumerate(frames):
        sym[i, : len(f.symbols)] = f.symbols
    res = decode(sym, cfg, device=device)
    data = res.data.cpu().numpy()
    off = res.offset.cpu().numpy()
    length = res.length.cpu().numpy()
    status = res.status.cpu().numpy()
    soft_idx = [i for i, f in enumerate(frames) if f.hard_symbols is not None]
    if soft_idx:
        from ..models.softdec import guard_soft_status

        hsym = np.zeros((len(frames), n), np.int32)
        for i in soft_idx:
            f = frames[i]
            hsym[i, : len(f.hard_symbols)] = f.hard_symbols
        hres = decode(hsym, cfg, device=device)
        guarded = guard_soft_status(res, hres)
        mask = np.zeros(len(frames), bool)
        mask[soft_idx] = True
        status = np.where(mask, guarded, status)
    for i, f in enumerate(frames):
        f.status = int(status[i])
        if f.status == OK:
            o, l = int(off[i]), int(length[i])
            f.payload = bytes(data[i, o : o + l].tolist())
    return frames
