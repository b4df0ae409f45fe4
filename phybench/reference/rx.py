"""The plain receiver: channel buffers -> frame decisions -> payloads.

A frozen copy of the program's plain route (`fused="off"`):
lora_tpu_torch/models/demodulator.py (`_demod_whole` for max_frames = 1),
lora_tpu_torch/ops/detect.py (dechirp, torch.fft, peak search),
lora_tpu_torch/ops/shift.py (`gather_rows`, `shift_windows_plain`),
lora_tpu_torch/ops/cuda_demod.py (`track_plain`, `payload_detect_plain`)
and lora_tpu_torch/models/decoder.py (`_decode`).

`bf16=True` is the control: the same computation with every complex
operand of a transform (the samples, the dechirped windows, the spectra)
rounded to bfloat16, the precision below the configuration's float32.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import codes
from .lora import (HEADER_RDD, N_HEADER_CODEWORDS, N_HEADER_SYMBOLS, N_SCAN,
                   N_TRACK_WIN, TRACK_ROWS, Radio, payload_rows,
                   required_samples)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    r = lambda t: t.to(torch.bfloat16).to(torch.float32)
    return torch.complex(r(x.real), r(x.imag))


def _q(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return _round_bf16(x) if bf16 else x


@functools.lru_cache(maxsize=None)
def _dechirp_table(N: int, down: bool, device) -> torch.Tensor:
    i1 = np.arange(1, N + 1, dtype=np.int64)
    w = np.maximum(0, i1 + 1 - N)
    num = (i1 * (N // 2) * (-1) + i1 * (i1 + 1) // 2 - N * w) % N
    turns = ((num / N) % 1.0)
    if not down:
        turns = (-turns) % 1.0
    t = 2 * np.pi * turns.astype(np.float32).astype(np.float64)
    re = torch.from_numpy(np.cos(t).astype(np.float32))
    im = torch.from_numpy(np.sin(t).astype(np.float32))
    return torch.complex(re, im).to(device)


def _rotator(ferr: torch.Tensor, N: int) -> torch.Tensor:
    c = np.float32(-2 * math.pi / N)
    n = torch.arange(N, dtype=torch.float32, device=ferr.device)
    ang = (ferr.to(torch.float32) * c)[..., None] * n
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _db(a: torch.Tensor, N: int) -> torch.Tensor:
    scale = np.float32(20.0 * np.log10(N))
    return 20.0 * torch.log10(torch.clamp(a, min=1e-20)) - scale


@dataclasses.dataclass
class Det:
    value: torch.Tensor
    power: torch.Tensor
    noise: torch.Tensor
    f_index: torch.Tensor


def dechirp_detect(x: torch.Tensor, down: bool = False, ferr=None,
                   want_f_index: bool = True, bf16: bool = False) -> Det:
    """Dechirp (and derotate by ferr) windows [..., N], FFT, peak search."""
    N = x.shape[-1]
    d = _q(x, bf16) * _dechirp_table(N, down, x.device)
    if ferr is not None:
        d = d * _rotator(ferr, N)
    X = _q(torch.fft.fft(_q(d, bf16)), bf16)
    mag2 = X.real * X.real + X.imag * X.imag
    peak2 = mag2.amax(-1)
    value = torch.argmax(mag2, dim=-1).to(torch.int32)
    fund = torch.sqrt(peak2)
    noise_amp = torch.sqrt(torch.clamp(mag2.sum(-1) - peak2, min=0.0))
    if want_f_index:
        v = value.long()[..., None]
        left = torch.sqrt(torch.gather(mag2, -1, (v - 1) % N))[..., 0]
        right = torch.sqrt(torch.gather(mag2, -1, (v + 1) % N))[..., 0]
        denom = 2.0 * fund - right - left
        f_index = torch.where(denom == 0.0, torch.zeros_like(denom),
                              0.5 * (right - left) / denom)
    else:
        f_index = torch.zeros_like(fund)
    return Det(value, _db(fund, N), _db(noise_amp, N), f_index)


def _squelch(thresh: float) -> float:
    return float(np.float32(thresh))


def _trunc_half(x: torch.Tensor) -> torch.Tensor:
    return torch.div(x, 2, rounding_mode="trunc")


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    return torch.argmax(mask.to(torch.int32), dim=-1)


def gather_rows(x: torch.Tensor, q: torch.Tensor, n_rows: int, N: int):
    """x [B, T]; rows q [B] on the N grid -> [B, n_rows, N]."""
    B, T = x.shape
    rows_total = T // N
    q = torch.clamp(q.long(), 0, max(0, rows_total - n_rows))
    idx = q[..., None] + torch.arange(n_rows, device=x.device)
    a3 = x[:, : rows_total * N].reshape(B, rows_total, N)
    return torch.take_along_dim(a3, idx[:, :, None], dim=1)


def shift_windows(g: torch.Tensor, r: torch.Tensor, mtu: int):
    """Aligned rows g [B, R, N], shift r [B] -> windows [B, mtu, N]."""
    B, R, N = g.shape
    idx = torch.arange(mtu * N, device=g.device) + r.long()[:, None]
    return torch.take_along_dim(g.reshape(B, R * N), idx, dim=1).reshape(
        B, mtu, N)


def _signed(v: torch.Tensor, N: int) -> torch.Tensor:
    return torch.where(v > N // 2, v - N, v)


def track(x, t0, cfg: Radio, bf16: bool) -> dict:
    """Sync scan and downchirp CFO from aligned starts t0 [B]."""
    N = cfg.N
    dev = x.device
    t0 = t0.long()
    xs = shift_windows(gather_rows(x, t0 // N, TRACK_ROWS, N), t0 % N,
                       N_TRACK_WIN)
    B = xs.shape[0]
    thr = _squelch(cfg.thresh)
    sync0, sync1 = cfg.sync >> 4, cfg.sync & 0xF
    state = torch.zeros(B, dtype=torch.int32, device=dev)
    ferr = torch.zeros(B, dtype=torch.float32, device=dev)
    prev_q = torch.full((B,), 999, dtype=torch.int32, device=dev)
    k_sync = torch.zeros(B, dtype=torch.int32, device=dev)
    for k in range(N_SCAN):
        d2 = dechirp_detect(xs[:, k : k + 2], ferr=ferr[:, None], bf16=bf16)
        squelched = (d2.power[:, 0] - d2.noise[:, 0]) < thr
        q = (d2.value[:, 0] + 4) // 8
        q1 = (d2.value[:, 1] + 4) // 8
        searching = state == 0
        is_sync = searching & ~squelched & (prev_q == 0) & (q == sync0) & (
            q1 == sync1)
        state = torch.where(is_sync, 1, state)
        k_sync = torch.where(is_sync, k, k_sync)
        ferr = torch.where(searching & ~is_sync & ~squelched,
                           ferr + d2.f_index[:, 0],
                           torch.where(searching & squelched, 0.0, ferr))
        prev_q = torch.where(searching, q, prev_q)
    idx = k_sync.long()[:, None] + torch.arange(2, 4, device=dev)
    rows_dc = torch.take_along_dim(xs, idx[:, :, None], dim=1)
    ddc = dechirp_detect(rows_dc, down=True, ferr=ferr[:, None],
                         want_f_index=False, bf16=bf16)
    freq_error = _trunc_half(_signed(ddc.value[:, 0], N)
                             + _signed(ddc.value[:, 1], N)).to(torch.int32)
    return {"synced": state == 1, "k_sync": k_sync, "freq_error": freq_error,
            "fine_total": ferr + _trunc_half(freq_error).to(torch.float32),
            "power": ddc.power[:, 1],
            "snr": ddc.power[:, 1] - ddc.noise[:, 1]}


def _align(v, snr0, pwr, cfg: Radio, T: int):
    """The strongest frame's alignment over [B, W] window detections."""
    N = cfg.N
    dev = v.device
    dv = torch.abs(v[:, :-1] - v[:, 1:])
    dist = torch.minimum(dv, N - dv)
    pair_snr = torch.minimum(snr0[:, :-1], snr0[:, 1:])
    pair_pow = torch.minimum(pwr[:, :-1], pwr[:, 1:])
    agree = ((dist <= 2) & (pair_snr > _squelch(cfg.thresh))
             & (pair_pow > -200.0))
    score = torch.where(agree, pair_snr, float("-inf"))
    good = agree & (score >= score.amax(-1, keepdim=True) - 6.0)
    first_w = _first_true(good)
    found_pre = good.any(-1)
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
    t0 = torch.clamp(t_cand, 0, T - TRACK_ROWS * N)
    return t0.to(torch.int32), found_pre


def demodulate(xb: torch.Tensor, cfg: Radio, bf16: bool = False) -> dict:
    """Buffers xb complex64 [B, T] -> the frame's fields, each [B]
    (symbols [B, mtu]): found, t_sync, count, freq_error, fine_freq,
    power, snr, symbols."""
    N, mtu = cfg.N, cfg.mtu
    need = required_samples(cfg)
    if xb.shape[-1] < need:
        xb = torch.nn.functional.pad(xb, (0, need - xb.shape[-1]))
    xb = xb.contiguous()
    B, T = xb.shape
    W = T // N
    d0 = dechirp_detect(xb[:, : W * N].reshape(B, W, N), want_f_index=False,
                        bf16=bf16)
    t0, found_pre = _align(d0.value, d0.power - d0.noise, d0.power, cfg, T)
    tr = track(xb, t0, cfg, bf16)
    found = found_pre & tr["synced"]
    freq_error = tr["freq_error"]
    t_dc = t0 + (tr["k_sync"] + 2) * N
    data_start = t_dc + 2 * N + N // 4 + _trunc_half(freq_error)
    room = max(0, T - payload_rows(N, mtu) * N)
    data_start = torch.clamp(data_start, 0, room).long()
    xd = shift_windows(gather_rows(xb, data_start // N, mtu + 1, N),
                       data_start % N, mtu)
    dd = dechirp_detect(xd, ferr=tr["fine_total"][..., None],
                        want_f_index=False, bf16=bf16)
    squelched = (dd.power - dd.noise) < _squelch(cfg.thresh)
    count = torch.where(squelched.any(-1),
                        torch.clamp(_first_true(squelched) + 1, max=mtu), mtu)
    count = torch.where(found, count, 0).to(torch.int32)
    mask = torch.arange(mtu, device=xb.device) < count[..., None]
    return {
        "found": found,
        "t_sync": (t0 + tr["k_sync"] * N).to(torch.int32),
        "count": count,
        "freq_error": torch.where(found, freq_error, 0).to(torch.int32),
        "fine_freq": torch.where(found, tr["fine_total"], 0.0),
        "power": tr["power"],
        "snr": tr["snr"],
        "symbols": torch.where(mask, dd.value, 0).to(torch.int16),
    }


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n)) if n > 0 else x


OK = 0


def decode(symbols: torch.Tensor, cfg: Radio) -> dict:
    """symbols int [B, S] -> data uint8 [B, max_bytes], offset, length,
    status [B] (OK or the program's DROP_* codes)."""
    num_symbols = symbols.shape[-1]
    dev = symbols.device
    ppm, cfg_rdd, sf = cfg.PPM, cfg.rdd, cfg.sf
    half = (1 << (sf - ppm)) // 2
    sym = codes.binary_to_gray((symbols.long() + half) >> (sf - ppm))
    nbits = 4 + cfg_rdd
    nsym = -(-num_symbols // nbits) * nbits
    sym = _pad_last(sym, nsym - num_symbols)
    ncw = (nsym // nbits) * ppm
    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    if cfg_rdd != HEADER_RDD:
        cw0 = codes.deinterleave(sym[..., :N_HEADER_SYMBOLS], ppm, HEADER_RDD)
        cw0 = torch.cat([cw0[..., :start],
                         codes.whiten(cw0[..., start:], 0, HEADER_RDD)], -1)
        cwr = (codes.deinterleave(sym[..., N_HEADER_SYMBOLS:], ppm, cfg_rdd)
               if nsym > N_HEADER_SYMBOLS else sym[..., :0])
        cwr = _pad_last(cwr, ncw - ppm - cwr.shape[-1])
        cwr = codes.whiten(cwr, ppm - start, cfg_rdd)
        codewords = torch.cat([cw0, cwr], dim=-1)
    else:
        codewords = codes.deinterleave(sym, ppm, cfg_rdd)
        codewords = torch.cat([codewords[..., :start],
                               codes.whiten(codewords[..., start:], 0,
                                            cfg_rdd)], -1)
    batch_shape = codewords.shape[:-1]
    max_bytes = (ncw + 1) // 2
    zeros = torch.zeros(batch_shape, dtype=torch.int64, device=dev)
    if cfg.explicit_header:
        h_nib, h_err, _ = codes.fec_decode(codewords[..., :5], HEADER_RDD)
        b0 = (h_nib[..., 0] << 4) | h_nib[..., 1]
        b1 = h_nib[..., 2]
        b2 = ((h_nib[..., 3] << 4) | h_nib[..., 4]) ^ codes.header_checksum(
            b0, b1)
        hdr_error = torch.any(h_err > 0, dim=-1)
        crc_present = (b1 & 1) == 1
        rdd = (b1 >> 1) & 0x7
        packet_length = b0
        data_length = packet_length + torch.where(crc_present, 5, 3)
        d_ofs0 = 6
        check_crc = crc_present & cfg.crc_check
    else:
        b0 = torch.full(batch_shape, cfg.data_length, dtype=torch.int64,
                        device=dev)
        b1 = b2 = zeros
        hdr_error = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
        crc_present = torch.full(batch_shape, cfg.crc_check, device=dev)
        rdd = torch.full(batch_shape, cfg_rdd, dtype=torch.int64, device=dev)
        packet_length = b0
        data_length = packet_length + (2 if cfg.crc_check else 0)
        d_ofs0 = 0
        check_crc = torch.full(batch_shape, cfg.crc_check, device=dev)
    pay_cw = codewords[..., start:]
    n_pay = ncw - start
    n0 = ppm - start
    nib84, err84, _ = codes.fec_decode(pay_cw, HEADER_RDD)
    nib_dyn, err_dyn, _ = codes.fec_decode(pay_cw, rdd[..., None])
    j = torch.arange(n_pay, device=dev)
    in_first = j < n0
    nib = torch.where(in_first, nib84, nib_dyn)
    err = torch.where(in_first, err84, err_dyn)
    has_straggler = (d_ofs0 + n0) % 2 == 1
    n1 = n0 + (1 if has_straggler else 0)
    pair_nibbles = 2 * torch.clamp(
        data_length[..., None] - ((d_ofs0 + n1) // 2), min=0)
    err_mask = in_first | ((j >= n1) & (j < n1 + pair_nibbles))
    if has_straggler:
        err_mask = err_mask | (j == n0)
    fec_error = torch.any((err > 0) & err_mask, dim=-1)
    pairs = _pad_last(nib, n_pay % 2).reshape(*batch_shape, -1, 2)
    pay_bytes = pairs[..., 0] | (pairs[..., 1] << 4)
    if cfg.explicit_header:
        all_bytes = torch.cat([torch.stack([b0, b1, b2], dim=-1), pay_bytes],
                              dim=-1)
    else:
        all_bytes = pay_bytes
    all_bytes = all_bytes[..., :max_bytes]
    nbytes = all_bytes.shape[-1]
    crc_start = 3 if cfg.explicit_header else 0
    idx = torch.arange(nbytes, device=dev)
    in_payload = (idx >= crc_start) & (idx < crc_start
                                       + packet_length[..., None])
    crc_input = torch.roll(torch.where(in_payload, all_bytes, 0), -crc_start,
                           dims=-1)
    crc = codes.masked_crc16(crc_input, packet_length)
    crc_lo_pos = crc_start + packet_length
    crc_hi_pos = crc_lo_pos + 1
    take = lambda pos: torch.gather(all_bytes, -1,
                                    (pos[..., None] % nbytes))[..., 0]
    crc_mismatch = (take(crc_lo_pos) | (take(crc_hi_pos) << 8)) != crc
    do_unmask = crc_present if cfg.explicit_header else check_crc
    unmask = (torch.where(idx == crc_lo_pos[..., None], crc[..., None] & 0xFF,
                          0)
              | torch.where(idx == crc_hi_pos[..., None],
                            (crc[..., None] >> 8) & 0xFF, 0))
    all_bytes = torch.where(do_unmask[..., None], all_bytes ^ unmask,
                            all_bytes)
    status = torch.full(batch_shape, OK, dtype=torch.int64, device=dev)

    def set_status(status, cond, code):
        return torch.where((status == OK) & cond, code, status)

    if cfg.explicit_header:
        if cfg.error_check:
            status = set_status(status, hdr_error, 1)
        status = set_status(status, rdd > 4, 2)
    status = set_status(status, data_length > nbytes, 3)
    if cfg.error_check:
        status = set_status(status, fec_error, 4)
    status = set_status(status, check_crc & crc_mismatch, 5)
    if cfg.explicit_header and not cfg.hdr:
        offset = torch.full(batch_shape, 3, dtype=torch.int64, device=dev)
        out_length = data_length - 5
    else:
        offset = zeros
        out_length = data_length
    i32 = lambda a: a.to(torch.int32)
    return {"data": all_bytes.to(torch.uint8), "offset": i32(offset),
            "length": i32(out_length), "status": i32(status)}
