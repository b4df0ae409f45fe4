"""Batched LoRa frame demodulator: complex baseband -> symbols (port of
lora_tpu/models/demodulator.py).

Stages, per channel buffer of T samples (padded to required_samples):

  1. coarse search: dechirp-detect every stride-N window, find the strongest
     run of agreeing window pairs and align t0 to the run's tail by the
     circular median of its bins (kernel A on a CUDA tensor);
  2-3. sync scan over 13 aligned windows with fine-CFO integration, then
     the downchirp pair's coarse CFO (kernel B);
  4. the mtu payload windows from data_start, derotated by the fine CFO
     (kernel C), then the squelch cut and packet framing.

Options, as in the JAX package: max_frames=K tracks the first K preamble
runs of every buffer (stages 2-4 over [B, K] candidates, one launch of
each kernel); spectra=True also returns the payload |FFT|^2 windows, which
kernel C writes itself (the soft-decision decoder's input,
models/softdec.py); debug=True returns the aligned payload windows, their
dechirped copies and spectra, cut by the row gather and kernel E
(ops/shift.py) and transformed by torch.fft, as the JAX package leaves
its fused payload kernels for these taps.

fused="auto" runs the kernels for a CUDA tensor and their plain versions
for a CPU tensor; fused="off" runs the plain versions on any device and is
the reference the tests and chip_smoke.py compare against.  fused="bf16"
is "auto": lora_tpu casts only its TPU Pallas kernels' DFT matmul operands
to bfloat16 and takes exactly the "auto" route on every other backend; the
port's kernels transform in float32 registers and have no matmul to cast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import LoRaConfig

from ..ops import cplx
from ..ops import cuda_demod, cuda_detect
from ..ops import detect as det_ops
from ..ops import shift as shift_ops
from ..ops.cuda_demod import squelch, trunc_half
from ..ops.tables import TRACK_ROWS, payload_rows
from ..roadmap import no_counterpart
from ..utils import debugcheck, jit, trace


@dataclasses.dataclass
class DemodResult:
    """Per-frame demod outputs (leading axes = batch, then the candidate
    axis K when max_frames > 1); field names and dtypes of
    lora_tpu.models.demodulator.DemodResult, its planar IQ taps as
    complex64."""

    symbols: torch.Tensor     # int16 [..., mtu] detected data symbols
    count: torch.Tensor       # int32 [...] symbols in the packet
    found: torch.Tensor       # bool [...] sync word matched
    freq_error: torch.Tensor  # int32 [...] coarse CFO, bins
    fine_freq: torch.Tensor   # float32 [...] fine CFO at data start, bins
    power: torch.Tensor       # float32 [...] dB
    snr: torch.Tensor         # float32 [...] dB
    t_sync: torch.Tensor      # int32 [...] sample index of the sync symbol
    consumed: torch.Tensor    # int32 [...] samples consumed through the packet
    found_pre: Optional[torch.Tensor] = None    # bool: coarse preamble hit
    t_candidate: Optional[torch.Tensor] = None  # int32: coarse-aligned start
    payload_complete: Optional[torch.Tensor] = None  # bool: whole payload in
    dec: Optional[torch.Tensor] = None  # complex64 [..., mtu, N] dechirped
    #                                     payload windows (debug)
    fft_mag2: Optional[torch.Tensor] = None  # float32 [..., mtu, N] payload
    #                                     spectra (debug or spectra)
    raw: Optional[torch.Tensor] = None  # complex64 [..., mtu, N] aligned
    #                                     payload sample windows (debug)


def required_samples(cfg: LoRaConfig, search_symbols: int = 4) -> int:
    """Minimum buffer length for demodulate() (a multiple of N), identical
    to the JAX package's (lora_tpu/models/demodulator.py:91-112)."""
    N = cfg.N
    rp = payload_rows(N, cfg.mtu)
    head = cfg.preamble_symbols + 2 + 2 + 1
    w = search_symbols + head + max(cfg.mtu + 1, rp) + 1
    w += (-(w - rp)) % 8
    return w * N


def _coarse_detect(xb: torch.Tensor, cfg: LoRaConfig, fused: bool):
    """Detect every stride-N window of every channel in one call; the
    [B, W, N] view of the buffer is read in place.  -> v, snr0, pwr [B, W]."""
    B, T = xb.shape
    N = cfg.N
    W = T // N
    win = xb[:, : W * N].reshape(B, W, N)
    detect = cuda_detect.dechirp_detect if fused else det_ops.dechirp_detect
    d0 = detect(win, want_f_index=False)
    return d0.value, d0.power - d0.noise, d0.power


def _coarse(v, snr0, pwr, cfg: LoRaConfig):
    """Pairwise agreement map of neighbouring windows [B, W-1]."""
    N = cfg.N
    dv = torch.abs(v[:, :-1] - v[:, 1:])
    dist = torch.minimum(dv, N - dv)
    pair_snr = torch.minimum(snr0[:, :-1], snr0[:, 1:])
    # the absolute floor rejects all-zero windows, whose 0/0 spectra read
    # bin 0 at "0 dB SNR"
    pair_pow = torch.minimum(pwr[:, :-1], pwr[:, 1:])
    agree = ((dist <= 2) & (pair_snr > squelch(cfg.thresh))
             & (pair_pow > -200.0))
    return agree, pair_snr


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _extend_run(cfg: LoRaConfig, agree, v, first_w, T: int):
    """Extend the agreeing run at first_w [M] to its end and align t0 to the
    run's tail by the circular median of its bins
    (lora_tpu/models/demodulator.py:155-195), batched over the M rows of
    agree [M, W-1] and v [M, W]."""
    N = cfg.N
    dev = v.device
    n_pairs = agree.shape[-1]
    idx_w = torch.arange(n_pairs, device=dev)
    brk = (idx_w >= first_w[:, None]) & ~agree
    first_brk = torch.where(brk.any(-1), _first_true(brk), n_pairs)
    last_w = torch.maximum(first_brk - 1, first_w)
    v = v.long()
    v_ref = torch.gather(v, 1, (last_w + 1)[:, None])
    idx_v = torch.arange(v.shape[-1], device=dev)
    in_run = (idx_v >= first_w[:, None]) & (idx_v <= (last_w + 1)[:, None])
    delta = torch.remainder(v - v_ref + N // 2, N) - N // 2
    cnt = in_run.sum(-1)
    d_sorted = torch.sort(torch.where(in_run, delta, N), dim=-1).values
    d_med = torch.gather(d_sorted, 1,
                         (torch.clamp(cnt - 1, min=0) // 2)[:, None])
    v_sel = torch.remainder(v_ref + d_med, N)[:, 0]
    t_cand = last_w * N + (N - v_sel) % N
    # the track stage reads TRACK_ROWS windows from t0
    t0 = torch.clamp(t_cand, 0, T - TRACK_ROWS * N)
    return t_cand.to(torch.int32), t0.to(torch.int32)


def _align_frame(v, snr0, pwr, cfg: LoRaConfig, T: int):
    """Single strongest-frame alignment over [B, W] detections: the earliest
    agreeing pair within 6 dB of the strongest."""
    agree, pair_snr = _coarse(v, snr0, pwr, cfg)
    score = torch.where(agree, pair_snr, float("-inf"))
    good = agree & (score >= score.amax(-1, keepdim=True) - 6.0)
    first_w = _first_true(good)
    found_pre = good.any(-1)
    t_cand, t0 = _extend_run(cfg, agree, v, first_w, T)
    return t_cand, t0, found_pre


def _align_multi(v, snr0, pwr, cfg: LoRaConfig, max_frames: int, T: int):
    """Multi-frame alignment over [B, W] detections: the first max_frames
    runs of at least three agreeing pairs, in time order -> t_cand, t0,
    valid [B, K].  No 6 dB near-far filter: frames that share a buffer may
    differ in power; a false run fails the sync scan
    (lora_tpu/models/demodulator.py:319-340)."""
    agree, _ = _coarse(v, snr0, pwr, cfg)
    B, n_pairs = agree.shape
    pad = torch.nn.functional.pad
    # a preamble of >= 6 chirps gives >= 4 agreeing pairs in a row; asking
    # for 3 drops the short runs of each frame's downchirp pair
    run_start = (agree & ~pad(agree[:, :-1], (1, 0)) & pad(agree[:, 1:], (0, 1))
                 & pad(agree[:, 2:], (0, 2)))
    idx_w = torch.arange(n_pairs, device=v.device)
    # every run start is a distinct index below the sentinel n_pairs, so the
    # sorted values do not depend on how the sort orders the sentinels
    starts = torch.sort(torch.where(run_start, idx_w, n_pairs),
                        dim=-1).values[:, :max_frames]
    K = starts.shape[1]
    valid = starts < n_pairs
    first_w = torch.clamp(starts, max=n_pairs - 1)
    # one batch of B*K rows: each candidate extends its own run over its
    # channel's agreement map (rows repeated by a broadcast view, which asks
    # the card nothing, where repeat_interleave may read a count back)
    rep = lambda a: a[:, None].expand(B, K, a.shape[-1]).reshape(B * K, -1)
    t_cand, t0 = _extend_run(cfg, rep(agree), rep(v), first_w.reshape(-1), T)
    return t_cand.reshape(B, K), t0.reshape(B, K), valid


def _head(tr: dict, cfg: LoRaConfig, t0, t_cand, found_pre, T: int):
    """Stage 4's quarter-chirp correction and the head of the result from
    the track outputs (lora_tpu/models/demodulator.py:264-301)."""
    N = cfg.N
    found = found_pre & tr["synced"]
    k_sync = tr["k_sync"]
    freq_error = tr["freq_error"]
    t_dc = t0 + (k_sync + 2) * N
    data_start = t_dc + 2 * N + N // 4 + trunc_half(freq_error)
    room = max(0, T - payload_rows(N, cfg.mtu) * N)
    fits = data_start <= room
    data_start = torch.clamp(data_start, 0, room).to(torch.int32)
    head = DemodResult(
        symbols=None,
        count=None,
        found=found,
        freq_error=torch.where(found, freq_error, 0).to(torch.int32),
        fine_freq=torch.where(found, tr["fine_total"], 0.0),
        power=tr["power"],
        snr=tr["snr"],
        t_sync=(t0 + k_sync * N).to(torch.int32),
        consumed=data_start,
        found_pre=found_pre,
        t_candidate=t_cand,
        payload_complete=found & fits,
    )
    return head, tr["fine_total"]


def _payload_epilogue(head: DemodResult, value, power, noise, t0,
                      cfg: LoRaConfig) -> DemodResult:
    """Squelch cut + packet framing over payload detections [..., mtu]; the
    squelched symbol is included in the packet."""
    squelched = (power - noise) < squelch(cfg.thresh)
    first_sq = _first_true(squelched)
    count = torch.where(squelched.any(-1),
                        torch.clamp(first_sq + 1, max=cfg.mtu), cfg.mtu)
    count = torch.where(head.found, count, 0).to(torch.int32)
    mask = torch.arange(cfg.mtu, device=power.device) < count[..., None]
    symbols = torch.where(mask, value, 0).to(torch.int16)
    consumed = torch.where(head.found, head.consumed + count * cfg.N, t0)
    return dataclasses.replace(head, symbols=symbols, count=count,
                               consumed=consumed.to(torch.int32))


FUSED = ("auto", "bf16", "off")


def check_options(fused: str = "auto") -> None:
    """Raise for a `fused` route the port does not take.  "auto" and its
    twin "bf16" run the kernels on a CUDA tensor and the plain versions on a
    CPU tensor; "off" the plain versions anywhere.  lora_tpu's "interpret"
    and "interpret-bf16" run its Pallas kernels in the JAX interpreter and
    have no CUDA counterpart."""
    if fused in ("interpret", "interpret-bf16"):
        raise no_counterpart(f"fused={fused!r}")
    if fused not in FUSED:
        raise ValueError(f"fused must be one of {FUSED}, got {fused!r}")


def _payload(xb, data_start, fine_total, cfg: LoRaConfig, use_kernels: bool,
             debug: bool, spectra: bool):
    """Stage 4 over candidates data_start [B, *k]: (value, power, noise,
    fft_mag2, dec, raw), the last three None unless asked for
    (lora_tpu/models/demodulator.py:520-578)."""
    N, mtu = cfg.N, cfg.mtu
    if debug:
        # the taps are the windows themselves, so they are cut here: rows
        # on the N grid, then the sub-window shift (kernel E on the card)
        shift = (shift_ops.shift_windows if use_kernels
                 else shift_ops.shift_windows_plain)
        ds = data_start.long()
        raw = shift(shift_ops.gather_rows(xb, ds // N, mtu + 1, N), ds % N,
                    mtu)
        dec = det_ops.dechirp(raw, ferr=fine_total[..., None])
        dd = det_ops.detect(dec, want_mag2=True, want_f_index=False)
        return dd.value, dd.power, dd.noise, dd.mag2, dec, raw
    payload = (cuda_demod.payload_detect if use_kernels
               else cuda_demod.payload_detect_plain)
    out = payload(xb, data_start, fine_total, mtu, N, want_mag2=spectra)
    return (*out, None, None) if spectra else (*out, None, None, None)


def demodulate(x, cfg: LoRaConfig, debug: bool = False, max_frames: int = 1,
               fused: str = "auto", spectra: bool = False,
               device=None) -> DemodResult:
    """Demodulate frames out of each channel buffer x [B, T] (or [T]),
    complex64 at 1 sample/chip (any form ops/cplx.as_iq accepts: a tensor
    is demodulated where it lies, host data goes to `device`, the card when
    None); buffers shorter than required_samples(cfg) are zero-padded.

    max_frames=K > 1 tracks up to K frames per buffer: every field gains a
    candidate axis [..., K] after the batch axis, candidates in time order,
    unused slots found=False.  spectra=True also carries the payload
    |FFT|^2 windows in fft_mag2, the input of api.decode_soft; debug=True
    carries raw, dec and fft_mag2 (the reference's raw/dec/fft debug
    ports).

    fused="auto" runs the CUDA kernels for a CUDA tensor and their plain
    versions for a CPU tensor; "bf16" is "auto" (see the module's note);
    "off" runs the plain versions anywhere.  On the card either route runs
    as one captured program per static arguments (`_demod_whole`,
    utils/jit.py); inside utils.jit.disable_jit() it runs op by op.

    Inside utils.debugcheck.debug_checks() the result is checked on the
    host before it is returned (DemodCheckError), and spectra are carried
    so that the payload windows are checked too."""
    with trace.span("lora.demodulate"):
        check_options(fused)
        if max_frames < 1:
            raise ValueError(f"max_frames must be >= 1, got {max_frames}")
        armed = debugcheck.armed()
        if armed and not debug:
            spectra = True
        x, dev = cplx.stage_iq(x, device)
        squeeze = x.dim() == 1
        res = _demod_whole(x[None] if squeeze else x, cfg, debug, max_frames,
                           fused != "off", spectra, dev)
        if armed:
            debugcheck.check_demod(res, cfg, max(x.shape[-1],
                                                  required_samples(cfg)))
        if squeeze:
            res = DemodResult(**{
                f.name: None if getattr(res, f.name) is None
                else getattr(res, f.name)[0] for f in dataclasses.fields(res)})
        return res


@jit.program(static=("cfg", "debug", "max_frames", "use_kernels", "spectra"),
             inplace=("xb",))
def _demod_whole(xb: torch.Tensor, cfg: LoRaConfig, debug: bool,
                 max_frames: int, use_kernels: bool, spectra: bool,
                 device: torch.device) -> DemodResult:
    """The whole demodulation of buffers xb [B, T] on `device`, the
    counterpart of lora_tpu's jitted `_demod_whole`
    (lora_tpu/models/demodulator.py:652-663): the coarse search, the track
    and payload stages and the epilogue, with no host sync."""
    xb = xb.to(device)
    N = cfg.N
    need = required_samples(cfg)
    if xb.shape[-1] < need:
        xb = torch.nn.functional.pad(xb, (0, need - xb.shape[-1]))
    xb = xb.contiguous()
    T = xb.shape[-1]

    v, snr0, pwr = _coarse_detect(xb, cfg, use_kernels)
    if max_frames == 1:
        t_cand, t0, found_pre = _align_frame(v, snr0, pwr, cfg, T)
    else:
        t_cand, t0, found_pre = _align_multi(v, snr0, pwr, cfg, max_frames, T)
    track = cuda_demod.track if use_kernels else cuda_demod.track_plain
    tr = track(xb, t0, cfg.sync, cfg.thresh, N)
    head, fine_total = _head(tr, cfg, t0, t_cand, found_pre, T)
    value, power, noise, mag2, dec, raw = _payload(
        xb, head.consumed, fine_total, cfg, use_kernels, debug, spectra)
    res = _payload_epilogue(head, value, power, noise, t0, cfg)
    return dataclasses.replace(res, dec=dec, fft_mag2=mag2, raw=raw)
