"""Soft-decision decoding: FFT spectra -> ML codewords -> payload bytes
(port of lora_tpu/models/softdec.py; plain PyTorch, as the JAX package runs
it outside any Pallas kernel).

The input is the payload |FFT|^2 windows of demodulate(spectra=True), which
kernel C writes (ops/cuda_demod.payload_detect(want_mag2=True)):

  1. word metrics: each Gray-mapped PPM-bit word gets the largest |FFT|^2
     over the bins that hard-decode to it (max-log symbol likelihood);
  2. bit LLRs: L_k = max_{w: bit k = 1} M_w - max_{w: bit k = 0} M_w, by
     reductions over the 2^ppm word metrics seen as a hypercube;
  3. the diagonal deinterleave of ops/codes.deinterleave, applied to the
     LLRs instead of bits;
  4. ML codeword selection: every codeword slot scores the 16 valid
     candidates enc(nibble) ^ whitening against its LLRs and keeps the
     best (the first on ties);
  5. the chosen codewords re-interleave into symbol values that feed the
     ordinary decoder (models/decoder.decode) for header, CRC and status.

ML selection always returns a valid codeword, so the FEC drop statuses
cannot fire on this path and false-positive rejection rests on the payload
CRC; guard_soft_status is the default policy for CRC-less frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (HEADER_RDD, N_HEADER_CODEWORDS, N_HEADER_SYMBOLS,
                      LoRaConfig)
from ..ops import codes, cplx
from ..utils import jit
from .decoder import OK, SOFT_UNVERIFIED, DecodeResult, decode


def _word_metrics(mag2: torch.Tensor, cfg: LoRaConfig) -> torch.Tensor:
    """|FFT|^2 windows [..., N] -> word metrics [..., 2^ppm]."""
    idx = codes.lut("bin_word", mag2.device, cfg.sf, cfg.PPM)
    if idx.shape[1] == 1:  # ppm == sf: a pure permutation
        return mag2[..., idx[:, 0]]
    return mag2[..., idx].amax(-1)


def _bit_llrs(metrics: torch.Tensor, ppm: int) -> torch.Tensor:
    """Word metrics [..., 2^ppm] -> per-bit LLRs [..., ppm] (max-log)."""
    lead = metrics.shape[:-1]
    cube = metrics.reshape(*lead, *([2] * ppm))  # axis i = bit ppm-1-i
    llrs = []
    for k in range(ppm):
        ax = tuple(len(lead) + i for i in range(ppm) if i != ppm - 1 - k)
        # [..., 2] = (bit k = 0, bit k = 1)
        pair = cube.amax(ax) if ax else cube
        llrs.append(pair[..., 1] - pair[..., 0])
    return torch.stack(llrs, dim=-1)


def _deinterleave_llrs(llr: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """LLRs [..., nsym, ppm] -> codeword-bit LLRs [..., nblocks*ppm, 4+rdd]
    (the diagonal gather of ops/codes.deinterleave applied to beliefs)."""
    nbits = 4 + rdd
    *lead, nsym, _ = llr.shape
    nblocks = nsym // nbits
    lb = llr[..., : nblocks * nbits, :].reshape(*lead, nblocks, nbits, ppm)
    m_idx = codes.lut("deinterleave", llr.device, ppm, rdd)
    kk = torch.arange(nbits, device=llr.device)
    cw = lb[..., kk[None, :], m_idx]  # [..., nblocks, ppm, nbits]
    return cw.reshape(*lead, nblocks * ppm, nbits)


def _ml_codewords(llr: torch.Tensor, stream: torch.Tensor, rdd: int):
    """Exact ML over the 16 valid codewords.

    llr [..., n, 4+rdd] deinterleaved bit LLRs (pre-whitening domain);
    stream int [n] whitening values the decoder will XOR onto each slot (0
    where unwhitened).  Candidate nibble m appears on air as
    enc(m) ^ stream, so score_m = sum_b sign(bit_b) * llr_b.  Returns the
    winning pre-whitening codewords int64 [..., n] and the decision margin
    (best score minus runner-up) float [..., n]."""
    nbits = 4 + rdd
    dev = llr.device
    cand = codes.lut("enc", dev, rdd)
    patt = cand[None, :] ^ stream.long()[:, None]  # [n, 16]
    bits = (patt[..., None] >> torch.arange(nbits, device=dev)) & 1
    sgn = (2 * bits - 1).to(llr.dtype)  # [n, 16, nbits]
    score = torch.einsum("...nb,nmb->...nm", llr, sgn)
    best = torch.argmax(score, dim=-1)  # first index on ties
    top = score.amax(-1)
    others = torch.where(
        torch.arange(score.shape[-1], device=dev) == best[..., None],
        float("-inf"), score)
    margin = top - others.amax(-1)
    slot = torch.arange(patt.shape[0], device=dev)
    return patt[slot, best], margin


def _whiten_stream(mode: int, lo: int, hi: int, rdd: int, device):
    return codes.lut("whiten", device)[mode, lo:hi] & ((1 << (4 + rdd)) - 1)


def soft_symbols(mag2, cfg: LoRaConfig, num_symbols: int | None = None,
                 device=None):
    """FFT spectra [..., S, N] -> (symbols int32 [..., S'], margin [...]).

    S' covers whole interleaver blocks (decode() pads identically).  The
    symbols carry the ML-corrected codewords; models/decoder.decode on them
    runs the whole reference pipeline on the cleaned stream.  `margin` is
    the per-frame confidence: the least ML decision margin over the first
    interleaver block's codewords (the header and the first payload
    nibbles); later blocks are CRC-covered, and their mtu-padding slots tie
    at exactly 0.  A tensor is decoded where it lies; host data goes to
    `device` (the card when None).  On the card this runs as one captured
    program per (cfg, num_symbols) and mag2's layout (utils/jit.py),
    lora_tpu's jitted `soft_symbols` (lora_tpu/models/softdec.py:146)."""
    if not cfg.interleaving:
        raise ValueError("soft decoding requires interleaving mode")
    mag2, dev = cplx.stage(mag2, device, torch.float32)
    if num_symbols is None:
        num_symbols = mag2.shape[-2]
    return _soft_symbols(mag2, cfg, num_symbols, dev)


@jit.program(static=("cfg", "num_symbols"))
def _soft_symbols(mag2: torch.Tensor, cfg: LoRaConfig, num_symbols: int,
                  device: torch.device):
    """soft_symbols of spectra on `device`, with no host sync."""
    mag2 = mag2.to(device)
    dev = mag2.device
    ppm, rdd, sf = cfg.PPM, cfg.rdd, cfg.sf
    llr = _bit_llrs(_word_metrics(mag2, cfg), ppm)  # [..., S, ppm]
    nsym = ((num_symbols + (4 + rdd) - 1) // (4 + rdd)) * (4 + rdd)
    pad = nsym - llr.shape[-2]
    if pad > 0:
        llr = torch.nn.functional.pad(llr, (0, 0, 0, pad))
    elif pad < 0:
        llr = llr[..., :nsym, :]

    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    unwhitened = torch.zeros(start, dtype=torch.int64, device=dev)
    mode = 1 if rdd == 1 else 0
    if rdd != HEADER_RDD:
        # mixed-rate frame: the 8-symbol header block at 4/8, the rest at
        # the configured rate (decode()'s split and whitening offsets)
        l0 = _deinterleave_llrs(llr[..., :N_HEADER_SYMBOLS, :], ppm,
                                HEADER_RDD)
        s0 = torch.cat([unwhitened,
                        _whiten_stream(0, 0, ppm - start, HEADER_RDD, dev)])
        cw0, m0 = _ml_codewords(l0, s0, HEADER_RDD)
        lr = _deinterleave_llrs(llr[..., N_HEADER_SYMBOLS:, :], ppm, rdd)
        n_r = lr.shape[-2]
        sr = _whiten_stream(mode, ppm - start, ppm - start + n_r, rdd, dev)
        cwr, _ = _ml_codewords(lr, sr, rdd)
        words = torch.cat([codes.interleave(cw0, ppm, HEADER_RDD),
                           codes.interleave(cwr, ppm, rdd)], dim=-1)
        margin = m0.amin(-1)  # first block: header + first nibbles
    else:
        lcw = _deinterleave_llrs(llr, ppm, rdd)
        n = lcw.shape[-2]
        # the header codewords (slots < start) are unwhitened and always
        # Hamming(8,4), the configured rate here
        stream = torch.cat([unwhitened,
                            _whiten_stream(mode, 0, n - start, rdd, dev)])
        cw, m = _ml_codewords(lcw, stream, rdd)
        words = codes.interleave(cw, ppm, rdd)
        margin = m[..., :ppm].amin(-1)  # first block only
    syms = (codes.gray_to_binary(words) << (sf - ppm)).to(torch.int32)
    return syms, margin


def decode_soft(mag2, cfg: LoRaConfig, num_symbols: int | None = None,
                device=None) -> DecodeResult:
    """Soft-decision decode of demod spectra
    (demodulate(spectra=True).fft_mag2): ML codeword selection, then the
    ordinary decoder on the corrected stream.  soft_symbols also gives the
    per-frame confidence margin."""
    syms, _ = soft_symbols(mag2, cfg, num_symbols, device)
    return decode(syms, cfg)


def guard_soft_status(dec_soft: DecodeResult,
                      dec_hard: DecodeResult) -> np.ndarray:
    """Default false-positive policy of the soft path: a soft OK is trusted
    when the frame carries a payload CRC, or when the hard-decision decode
    of the same frame is OK with the same bytes; every other soft OK
    becomes SOFT_UNVERIFIED.  Returns dec_soft.status with the policy
    applied, as int32 numpy on the host."""
    host = lambda t: t.detach().cpu().numpy()
    st = host(dec_soft.status).copy()
    crc = host(dec_soft.crc_present)
    sdata, hdata = host(dec_soft.data), host(dec_hard.data)
    hst = host(dec_hard.status)
    soff, slen = host(dec_soft.offset), host(dec_soft.length)
    hoff, hlen = host(dec_hard.offset), host(dec_hard.length)
    suspect = (st == OK) & ~crc
    for i in np.nonzero(suspect.reshape(-1))[0]:
        idx = np.unravel_index(i, st.shape)
        agree = (
            hst[idx] == OK
            and hlen[idx] == slen[idx]
            and np.array_equal(
                sdata[idx][soff[idx] : soff[idx] + slen[idx]],
                hdata[idx][hoff[idx] : hoff[idx] + hlen[idx]],
            )
        )
        if not agree:
            st[idx] = SOFT_UNVERIFIED
    return st
