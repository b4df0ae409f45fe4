"""Batched LoRa decoder: modulation symbols -> payload bytes (port of
lora_tpu/models/decoder.py).

The same pipeline, status codes and preserved reference quirks: the
decoder's whitening flag is never consulted, the header checksum is never
verified, and in explicit mode without CRC the output length is
packetLength - 2; the codeword tail past the symbols decodes as the raw
whitening stream (lora_tpu/models/decoder.py:18-26, 142-155).  On the card
the whole decode is one launch of kernel G (ops/cuda_decode.py); on the
CPU it runs op by op (decode_plain).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import (HEADER_RDD, N_HEADER_CODEWORDS,
                             N_HEADER_SYMBOLS, LoRaConfig)

from ..ops import codes, cplx, cuda_decode
from ..utils import trace

OK = 0
DROP_HEADER_FEC = 1
DROP_HEADER_RDD = 2
DROP_LENGTH = 3
DROP_FEC = 4
DROP_CRC = 5
# soft-decision only: a CRC-less frame whose soft decode the hard decode of
# the same frame does not confirm (models/softdec.guard_soft_status)
SOFT_UNVERIFIED = 6

STATUS_NAMES = {
    OK: "ok",
    DROP_HEADER_FEC: "drop_header_fec",
    DROP_HEADER_RDD: "drop_header_rdd",
    DROP_LENGTH: "drop_length",
    DROP_FEC: "drop_fec",
    DROP_CRC: "drop_crc",
    SOFT_UNVERIFIED: "soft_unverified",
}


@dataclasses.dataclass
class DecodeResult:
    """Per-packet decode outputs (leading axes = batch)."""

    data: torch.Tensor          # uint8 [..., max_bytes] (header at 0)
    offset: torch.Tensor        # int32 [...] first output byte
    length: torch.Tensor        # int32 [...] output byte count
    status: torch.Tensor        # int32 [...] OK or DROP_* code
    packet_length: torch.Tensor  # int32 [...]
    rdd: torch.Tensor           # int32 [...] coding rate of the payload
    crc_present: torch.Tensor   # bool [...]
    fec_errors: torch.Tensor    # int32 [...]
    bad: torch.Tensor           # int32 [...] uncorrectable Hamming(8,4) words


def masked_crc16(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """CRC16 over data[..., :length] with a per-packet length: a Python loop
    over the static byte axis, a table step a byte (ops/codes.crc16_step);
    a packet's register stops at its length, and its masking register is
    read at its length (lora_tpu/models/decoder.py:80-101, bit for bit)."""
    data = data.long()
    L = data.shape[-1]
    active = torch.arange(L, device=data.device) < length[..., None]
    res = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    for i in range(L):
        res = torch.where(active[..., i], codes.crc16_step(res, data[..., i]),
                          res)
    return codes.crc16_finish(res, torch.clamp(length, 0, L).long(), L)


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n)) if n > 0 else x


def decode(symbols, cfg: LoRaConfig, num_symbols: int | None = None,
           device=None):
    """symbols int [B, S] (or [S]) -> DecodeResult; with
    cfg.interleaving=False the Gray-mapped symbols pass through.  A tensor
    is decoded where it lies; host data goes to `device` (the card when
    None).  On the card this is one launch of kernel G, lora_tpu's jitted
    `decode` (lora_tpu/models/decoder.py:104)."""
    with trace.span("lora.decode"):
        sym, dev = cplx.stage(symbols, device)
        if num_symbols is None:
            num_symbols = sym.shape[-1]
        squeeze = sym.dim() == 1
        sym = torch.atleast_2d(sym).to(dev)
        if sym.device.type == "cpu":
            result = decode_plain(sym, cfg, num_symbols)
        else:
            result = cuda_decode.decode(sym, cfg, num_symbols)
        if isinstance(result, tuple):  # kernel G's outputs
            data, ints, crc_present = result
            offset, length, status, packet_length, rdd, fec_errors, bad = (
                ints.unbind(0))
            result = DecodeResult(data, offset, length, status,
                                  packet_length, rdd, crc_present,
                                  fec_errors, bad)
        if not squeeze:
            return result
        if isinstance(result, torch.Tensor):
            return result[0]
        return DecodeResult(**{f.name: getattr(result, f.name)[0]
                               for f in dataclasses.fields(result)})


def decode_plain(sym: torch.Tensor, cfg: LoRaConfig, num_symbols: int):
    """decode of symbols [..., S] op by op on their device: the plain
    version of kernel G."""
    sym = sym.long()
    dev = sym.device
    ppm, cfg_rdd, sf = cfg.PPM, cfg.rdd, cfg.sf

    half = (1 << (sf - ppm)) // 2
    sym = codes.binary_to_gray((sym + half) >> (sf - ppm))
    if not cfg.interleaving:
        return sym.to(torch.int32)

    nbits = 4 + cfg_rdd
    nsym = ((num_symbols + nbits - 1) // nbits) * nbits
    sym = _pad_last(sym, nsym - num_symbols)
    ncw = (nsym // nbits) * ppm

    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    if cfg_rdd != HEADER_RDD:
        cw0 = codes.deinterleave(sym[..., :N_HEADER_SYMBOLS], ppm, HEADER_RDD)
        cw0 = torch.cat(
            [cw0[..., :start], codes.whiten(cw0[..., start:], 0, HEADER_RDD)],
            dim=-1,
        )
        if nsym > N_HEADER_SYMBOLS:
            cwr = codes.deinterleave(sym[..., N_HEADER_SYMBOLS:], ppm, cfg_rdd)
        else:
            cwr = sym[..., :0]
        # the reference over-counts the header block at rates != 4/8 and
        # zero-fills the tail before dewhitening
        cwr = _pad_last(cwr, ncw - ppm - cwr.shape[-1])
        cwr = codes.whiten(cwr, ppm - start, cfg_rdd)
        codewords = torch.cat([cw0, cwr], dim=-1)
    else:
        codewords = codes.deinterleave(sym, ppm, cfg_rdd)
        codewords = torch.cat(
            [codewords[..., :start],
             codes.whiten(codewords[..., start:], 0, cfg_rdd)],
            dim=-1,
        )

    batch_shape = codewords.shape[:-1]
    max_bytes = (ncw + 1) // 2
    zeros = torch.zeros(batch_shape, dtype=torch.int64, device=dev)

    if cfg.explicit_header:
        h_nib, h_err, h_bad = codes.fec_decode(codewords[..., :5], HEADER_RDD)
        b0 = (h_nib[..., 0] << 4) | h_nib[..., 1]
        b1 = h_nib[..., 2]
        b2 = (h_nib[..., 3] << 4) | h_nib[..., 4]
        b2 = b2 ^ codes.header_checksum(b0, b1)
        hdr_error = torch.any(h_err > 0, dim=-1)
        hdr_bad = h_bad.sum(-1)
        crc_present = (b1 & 1) == 1
        rdd = (b1 >> 1) & 0x7
        packet_length = b0
        data_length = packet_length + torch.where(crc_present, 5, 3)
        d_ofs0 = 6
    else:
        b0 = torch.full(batch_shape, cfg.data_length, dtype=torch.int64,
                        device=dev)
        b1 = b2 = zeros
        hdr_error = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
        hdr_bad = zeros
        crc_present = torch.full(batch_shape, cfg.crc_check, device=dev)
        rdd = torch.full(batch_shape, cfg_rdd, dtype=torch.int64, device=dev)
        packet_length = b0
        data_length = packet_length + (2 if cfg.crc_check else 0)
        d_ofs0 = 0

    if cfg.explicit_header:
        check_crc = crc_present & cfg.crc_check
    else:
        check_crc = torch.full(batch_shape, cfg.crc_check, device=dev)

    # payload FEC: the first block is always Hamming(8,4), the rest at the
    # header-announced rate
    pay_cw = codewords[..., start:]
    n_pay = ncw - start
    n0 = ppm - start
    nib84, err84, bad84 = codes.fec_decode(pay_cw, HEADER_RDD)
    nib_dyn, err_dyn, bad_dyn = codes.fec_decode(pay_cw, rdd[..., None])
    j = torch.arange(n_pay, device=dev)
    in_first = j < n0
    nib = torch.where(in_first, nib84, nib_dyn)
    err = torch.where(in_first, err84, err_dyn)

    # error mask of the reference's loop bounds: the first block, the odd
    # nibble straggler, then 2 codewords per byte up to dataLength
    has_straggler = (d_ofs0 + n0) % 2 == 1
    n1 = n0 + (1 if has_straggler else 0)
    pair_nibbles = 2 * torch.clamp(
        data_length[..., None] - ((d_ofs0 + n1) // 2), min=0
    )
    err_mask = in_first | ((j >= n1) & (j < n1 + pair_nibbles))
    if has_straggler:
        err_mask = err_mask | (j == n0)
    fec_error = torch.any((err > 0) & err_mask, dim=-1)
    fec_errors = (err * err_mask).sum(-1)
    bad = torch.where(in_first, bad84,
                      torch.where(rdd[..., None] == 4, bad_dyn, 0))
    bad_count = hdr_bad + (bad * err_mask).sum(-1)

    # byte assembly: nibble j lands at stream position d_ofs0 + j
    nib_p = _pad_last(nib, n_pay % 2)
    pairs = nib_p.reshape(*batch_shape, -1, 2)
    pay_bytes = pairs[..., 0] | (pairs[..., 1] << 4)
    if cfg.explicit_header:
        all_bytes = torch.cat([torch.stack([b0, b1, b2], dim=-1), pay_bytes],
                              dim=-1)
    else:
        all_bytes = pay_bytes
    all_bytes = all_bytes[..., :max_bytes]
    nbytes = all_bytes.shape[-1]

    # CRC verify + unmask
    crc_start = 3 if cfg.explicit_header else 0
    idx = torch.arange(nbytes, device=dev)
    pl = packet_length[..., None]
    in_payload = (idx >= crc_start) & (idx < crc_start + pl)
    crc_input = torch.where(in_payload, all_bytes, 0)
    crc_input = torch.roll(crc_input, -crc_start, dims=-1)
    crc = masked_crc16(crc_input, packet_length)

    crc_lo_pos = crc_start + packet_length
    crc_hi_pos = crc_lo_pos + 1
    take = lambda pos: torch.gather(all_bytes, -1, (pos[..., None] % nbytes))[
        ..., 0]
    pkt_crc = take(crc_lo_pos) | (take(crc_hi_pos) << 8)
    crc_mismatch = pkt_crc != crc
    do_unmask = crc_present if cfg.explicit_header else check_crc
    unmask = (
        torch.where(idx == crc_lo_pos[..., None], crc[..., None] & 0xFF, 0)
        | torch.where(idx == crc_hi_pos[..., None], (crc[..., None] >> 8) & 0xFF,
                      0)
    )
    all_bytes = torch.where(do_unmask[..., None], all_bytes ^ unmask,
                            all_bytes)

    status = torch.full(batch_shape, OK, dtype=torch.int64, device=dev)

    def set_status(status, cond, code):
        return torch.where((status == OK) & cond, code, status)

    if cfg.explicit_header:
        if cfg.error_check:
            status = set_status(status, hdr_error, DROP_HEADER_FEC)
        status = set_status(status, rdd > 4, DROP_HEADER_RDD)
    status = set_status(status, data_length > nbytes, DROP_LENGTH)
    if cfg.error_check:
        status = set_status(status, fec_error, DROP_FEC)
    status = set_status(status, check_crc & crc_mismatch, DROP_CRC)

    if cfg.explicit_header and not cfg.hdr:
        offset = torch.full(batch_shape, 3, dtype=torch.int64, device=dev)
        out_length = data_length - 5  # reference quirk: -5 even without CRC
    else:
        offset = zeros
        out_length = data_length

    i32 = lambda a: a.to(torch.int32)
    return DecodeResult(
        data=all_bytes.to(torch.uint8),
        offset=i32(offset),
        length=i32(out_length),
        status=i32(status),
        packet_length=i32(packet_length),
        rdd=i32(rdd),
        crc_present=crc_present,
        fec_errors=i32(fec_errors),
        bad=i32(bad_count),
    )
