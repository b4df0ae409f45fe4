"""Top-level PHY API of the port: encode / modulate / demodulate / decode /
decode_soft and the wideband front end channelized_demodulate (port of
lora_tpu/api.py).

Every entry point works where its tensor argument lies; host data (numpy,
lists) goes to the `device` argument, and device=None means the card:
nothing here picks the CPU by itself (ops/cplx.as_tensor)."""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from .config import LoRaConfig

from .models.decoder import (OK, SOFT_UNVERIFIED, STATUS_NAMES, DecodeResult,
                             decode)
from .models.demodulator import (DemodResult, _demod_whole, check_options,
                                 demodulate, required_samples)
from .models.encoder import encode
from .models.modulator import modulate
from .models.softdec import decode_soft, guard_soft_status, soft_symbols
from .ops import channelizer as chz
from .ops import cplx
from .ops import resample as rs
from .utils import debugcheck, jit, trace

__all__ = [
    "LoRaConfig",
    "encode",
    "decode",
    "decode_soft",
    "soft_symbols",
    "guard_soft_status",
    "modulate",
    "demodulate",
    "DecodeResult",
    "DemodResult",
    "required_samples",
    "OK",
    "SOFT_UNVERIFIED",
    "STATUS_NAMES",
    "extract_payloads",
    "channelized_demodulate",
    "loopback",
    "aggregate_metrics",
]


def extract_payloads(result: DecodeResult) -> list[bytes | None]:
    """Each packet's output bytes, or None where it was dropped."""
    data = np.atleast_2d(result.data.cpu().numpy())
    offset = np.atleast_1d(result.offset.cpu().numpy())
    length = np.atleast_1d(result.length.cpu().numpy())
    status = np.atleast_1d(result.status.cpu().numpy())
    out = []
    for i in range(data.shape[0]):
        if status[i] != OK:
            out.append(None)
        else:
            o, n = int(offset[i]), int(length[i])
            out.append(bytes(data[i, o : o + n].tolist()))
    return out


def aggregate_metrics(dem: DemodResult, statuses=None) -> dict:
    """Health report over a channel bank (lora_tpu/parallel/mesh.py:85):
    frames, synced, the means over synced frames of snr, power and coarse
    CFO, the symbol count and, given the decode statuses, decoded_ok and
    dropped among the synced frames.  0-d tensors on the result's device."""
    found = dem.found
    n_found = found.sum(dtype=torch.int32)
    denom = torch.clamp(n_found, min=1).to(torch.float32)

    def mean_found(v):
        return torch.where(found, v.to(torch.float32), 0.0).sum() / denom

    out = {
        "frames": torch.tensor(found.numel(), dtype=torch.int32,
                               device=found.device),
        "synced": n_found,
        "mean_snr_db": mean_found(dem.snr),
        "mean_power_db": mean_found(dem.power),
        "mean_cfo_bins": mean_found(dem.freq_error),
        "symbols": dem.count.sum(dtype=torch.int32),
    }
    if statuses is not None:
        ok = torch.as_tensor(statuses, device=found.device) == OK
        out["decoded_ok"] = (found & ok).sum(dtype=torch.int32)
        out["dropped"] = (found & ~ok).sum(dtype=torch.int32)
    return out


def channelized_demodulate(wide, K: int, cfg: LoRaConfig,
                           taps_per_phase: int = 8, max_frames: int = 1,
                           state=None, fused: str = "auto",
                           spectra: bool = False, device=None,
                           slot_ratio=1):
    """Wideband front end (BASELINE.json config 3): polyphase-channelize
    [S, T] (or [T]) at K times the slot spacing into K channels and
    demodulate every channel.  Returns (DemodResult with leading [S, K]
    axes, or [K] for a 1-D input, then the candidate axis when max_frames
    > 1; the channelizer state [S, taps_per_phase*K - 1] to pass as
    `state` with the next block).  spectra=True carries the payload
    |FFT|^2 windows in fft_mag2 [S, K, mtu, N] for decode_soft.  A tensor
    is processed where it lies; host data goes to `device` (the card when
    None).

    slot_ratio: a slot's samples per LoRa sample, the slot spacing over the
    bandwidth (a Fraction, or a number taken as the nearest fraction with
    a denominator up to 10^6): 8/5 for LoRaWAN US902-928's 125-kHz uplinks
    200 kHz apart.  Where it is not 1, each of the filterbank's channels
    (M = T/K samples) is resampled to cfg's rate (ops/resample.py,
    `block_plan`: floor(M / slot_ratio) outputs of a block after no state,
    the taps past the block's end clamped to its last sample) before the
    demodulator, inside the same program, and the state passed and returned
    is the pair (the channelizer's state, the resampler's ResampleState).

    fused="auto" runs kernel D then the demod kernels for a CUDA tensor,
    and their plain versions for a CPU tensor; "off" runs the plain
    channelizer and demodulator on any device.  "bf16" channelizes with
    bf16=True (ops/channelizer.channelize: kernel D's bf16 route on the
    card, the bfloat16 product on the CPU, as lora_tpu rounds on a TPU and
    off it) and demodulates as "auto".  On the card a block runs as one
    captured program per static arguments (utils/jit.py), lora_tpu's
    `_channelize_demod_step` (lora_tpu/api.py:62-94)."""
    with trace.span("lora.channelized_demodulate"):
        check_options(fused)
        armed = debugcheck.armed()
        wide, dev = cplx.stage_iq(wide, device)
        ratio = Fraction(slot_ratio).limit_denominator(10**6)
        rstate = tail = table = runs = None
        if ratio != 1 and state is not None:
            state, rstate = state
            if rstate is not None:
                tail, _ = cplx.stage_iq(rstate.tail, dev)
        if state is not None:
            state, _ = cplx.stage_iq(state, dev)
        squeeze = wide.dim() == 1
        M = wide.shape[-1] // K
        if ratio != 1:
            (table, runs), m_next, origin = rs.block_plan(rstate, M, ratio,
                                                          dev)
            M = table.shape[-1]
        dem, new_state = _channelize_demod_step(
            wide[None] if squeeze else wide, state, K, cfg, taps_per_phase,
            max_frames, fused, spectra or armed, dev, ratio, tail, table, runs)
        if ratio != 1:
            new_state, tail = new_state
            new_state = (new_state, rs.ResampleState(m_next, origin, tail))
        if armed:
            T = max(M, required_samples(cfg))
            debugcheck.check_demod(dem, cfg, T)
        if squeeze:
            dem = DemodResult(**{f.name: None if getattr(dem, f.name) is None
                                 else getattr(dem, f.name)[0]
                                 for f in dataclasses.fields(dem)})
        return dem, new_state


@jit.program(static=("K", "cfg", "taps_per_phase", "max_frames", "fused",
                     "spectra", "slot_ratio", "runs"), inplace=("wb",))
def _channelize_demod_step(wb: torch.Tensor, state, K: int, cfg: LoRaConfig,
                           taps_per_phase: int, max_frames: int, fused: str,
                           spectra: bool, device: torch.device,
                           slot_ratio: Fraction = 1, tail=None, table=None,
                           runs=None):
    """Kernel D's filterbank, where slot_ratio is not 1 kernel R's
    resampling of every channel after its history `tail` at the plan
    (`table`, `runs`) of ops/resample.block_plan, and the demodulation of its
    S*K channels as one program on `device`; the result has leading [S, K]
    axes, and the state is then the pair (the channelizer's, the
    resampler's tail)."""
    wb = wb.to(device)
    if state is not None:
        state = state.to(device)
    y, new_state = chz.channelize(
        wb, K, taps_per_phase, state=state, bf16=fused == "bf16",
        impl="xla" if fused == "off" else "auto")
    if slot_ratio != 1:
        if tail is not None:
            y = torch.cat([tail.to(device), y], -1)
        keep = rs.history(y.shape[-1], float(slot_ratio))
        new_state = (new_state, y[..., y.shape[-1] - keep:].clone())
        y = rs.weigh(y, rs.Plan(table.to(device), runs), float(slot_ratio),
                     plain=fused == "off")
    S, _, M = y.shape
    dem = _demod_whole(y.reshape(S * K, M), cfg, False, max_frames,
                       fused != "off", spectra, device)
    split = lambda t: None if t is None else t.reshape(S, K, *t.shape[1:])
    return DemodResult(**{f.name: split(getattr(dem, f.name))
                          for f in dataclasses.fields(dem)}), new_state


def loopback(payload, cfg: LoRaConfig, noise_amplitude: float = 0.0,
             phase: float = 0.0, cfo_bins: float = 0.0, delay: int = 0,
             seed: int = 0, debug: bool = False, device=None,
             fused: str = "auto", soft: bool = False):
    """encode -> modulate -> channel -> demodulate -> decode.  payload
    uint8 [B, L] (or [L]): a tensor stays where it lies, host data goes to
    `device` (the card when None).  soft=True decodes the demodulator's
    spectra with decode_soft; debug=True carries the raw/dec/fft_mag2 taps.
    Returns (DecodeResult, DemodResult)."""
    from .sim import channel as ch

    check_options(fused)
    payload = torch.atleast_2d(cplx.as_tensor(payload, device, torch.uint8))
    iq = modulate(encode(payload, cfg), cfg)
    # pad to the demod window plus the delay, rounded up to a 4096 block
    need = -(-(required_samples(cfg) + delay) // 4096) * 4096
    iq = torch.nn.functional.pad(iq, (0, max(0, need - iq.shape[-1])))
    if delay:
        iq = ch.time_offset(iq, delay)[..., :need]
    if cfo_bins:
        iq = ch.cfo(iq, cfo_bins, cfg.N)
    if phase:
        iq = ch.rotate(iq, phase)
    if noise_amplitude:
        gen = torch.Generator(device=iq.device).manual_seed(seed)
        iq = ch.awgn(iq, noise_amplitude, gen)
    dem = demodulate(iq, cfg, debug=debug, fused=fused,
                     spectra=soft and not debug)
    if soft:
        return decode_soft(dem.fft_mag2, cfg), dem
    return decode(dem.symbols, cfg), dem
