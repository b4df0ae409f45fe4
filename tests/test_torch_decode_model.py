"""A CPU replay of kernel G's control flow (lora_tpu_torch/csrc/decode.cu)
against its plain version, models/decoder.decode_plain.

The kernel takes a call's geometry from ops/cuda_decode.geometry (the
codewords a frame, the codeword blocks formed from symbols, the symbols
they read), forms the error mask's bounds from it, stages each frame's symbols Gray-mapped to 16 bits, forms
every codeword (deinterleave, dewhiten), and then walks each frame alone:
the header, the FEC decode at the header-announced rate, the error mask,
the bytes, the CRC register a byte at a time, the unmasking, the status
chain.  The plain version does all of it op by op over the whole batch.
`decode_model` repeats the kernel's steps frame by frame in Python
integers, so what is held here is that control flow and its quirks: every
field bit-equal to decode_plain's on encoded frames, damaged frames and
uniformly random symbols (which reach every DROP_* status and headers that
announce rates 5 to 7), over every spreading factor and coding rate, both
header modes and every decoder flag.  The kernel's own code is held on the
card by tests/test_torch_cuda.py, on the same cases (`decode_cases`).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import lora_tpu_torch
from lora_tpu_torch import api
from lora_tpu_torch.models import decoder
from lora_tpu_torch.ops import _cuda, cuda_decode, tables

torch.set_num_threads(1)

DECODE_CU = (_cuda.CSRC / "decode.cu").read_text()
FIELDS = [f.name for f in dataclasses.fields(decoder.DecodeResult)]
# csrc/decode.cu's status codes, by name
STATUS = {name: int(v) for name, v in re.findall(
    r"kDrop(\w+) = (\d+)", DECODE_CU)}
STATUS_CODES = (decoder.OK, decoder.DROP_HEADER_FEC,
                decoder.DROP_HEADER_RDD, decoder.DROP_LENGTH,
                decoder.DROP_FEC, decoder.DROP_CRC)


def test_the_kernels_constants_are_the_wrappers():
    assert STATUS == {"HeaderFec": decoder.DROP_HEADER_FEC,
                      "HeaderRdd": decoder.DROP_HEADER_RDD,
                      "Length": decoder.DROP_LENGTH,
                      "Fec": decoder.DROP_FEC, "Crc": decoder.DROP_CRC}


def header_checksum(h0, h1):
    a = [(h0 >> (4 + i)) & 1 for i in range(4)]
    b = [(h0 >> i) & 1 for i in range(4)]
    c = [(h1 >> i) & 1 for i in range(4)]
    r = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    r |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    r |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    r |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    r |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return r


def geometry(cfg, S, num_symbols):
    """lora_decode's host part: ops/cuda_decode.geometry, then what the
    kernel forms from it and the configuration."""
    ncw, nexist, K, M = cuda_decode.geometry(cfg, S, num_symbols)
    g = dict(ppm=cfg.PPM, rdd=cfg.rdd, nbits=4 + cfg.rdd, ncw=ncw,
             nexist=nexist, K=K, M=M,
             start=5 if cfg.explicit_header else 0,
             d_ofs0=6 if cfg.explicit_header else 0,
             hb=3 if cfg.explicit_header else 0,
             shift=cfg.sf - cfg.PPM, half=(1 << (cfg.sf - cfg.PPM)) // 2)
    g["n_pay"] = ncw - g["start"]
    g["n0"] = cfg.PPM - g["start"]
    g["straggler"] = (g["d_ofs0"] + g["n0"]) % 2
    g["n1"] = g["n0"] + g["straggler"]
    return g


def gray(s, half, shift):
    """gray((s + half) >> shift) in int64, as the kernel's gray_map."""
    x = ((s + half + 2**63) % 2**64 - 2**63) >> shift
    return x ^ (x >> 1)


def codewords(row, g, wz):
    """Phase B for one frame: row holds its K staged 16-bit symbols."""
    ppm, out = g["ppm"], []
    for i in range(g["ncw"]):
        b, r = divmod(i, ppm)
        cw = 0
        if b < g["nexist"]:
            nb = 8 if b == 0 else g["nbits"]
            base = 0 if b == 0 else 8 + (b - 1) * g["nbits"]
            for k in range(nb):
                s = row[base + k] if base + k < g["K"] else 0
                cw |= ((s >> ((r - k) % ppm)) & 1) << k
        if i >= g["start"]:
            cw ^= wz[i - g["start"]]
        out.append(cw)
    return out


def decode_model(sym, cfg, num_symbols):
    """csrc/decode.cu's steps for symbols int64 numpy [B, S], one frame at
    a time -> {field: numpy array}, the fields of DecodeResult."""
    B, S = sym.shape
    if not cfg.interleaving:
        return np.array([[gray(int(s), (1 << (cfg.sf - cfg.PPM)) // 2,
                               cfg.sf - cfg.PPM) for s in r] for r in sym],
                        np.int64).astype(np.int32)
    g = geometry(cfg, S, num_symbols)
    M, hb = g["M"], g["hb"]
    dec = tables.DEC_LUTS.reshape(-1)
    crc_t = tables.crc16_table()
    vmask = tables.crc_whitening(M + 1)
    # phase A's whitening values: header block at 4/8, the rest at the rate
    wz = []
    for p in range(g["n_pay"]):
        rate = 4 if p + g["start"] < g["ppm"] else g["rdd"]
        w = int(tables.WHITEN_SEQ[1 if rate == 1 else 0][p])
        wz.append(w & ((1 << (4 + rate)) - 1))
    out = {f: [] for f in FIELDS}
    for frame in sym:
        row = [gray(int(s), g["half"], g["shift"]) & 0xFFFF
               for s in frame[: g["K"]]]
        c = codewords(row, g, wz)
        bt = [0] * M
        herr = hbad = 0
        if cfg.explicit_header:
            nib = []
            for i in range(5):
                p = int(dec[4 * 256 + c[i]])
                nib.append(p & 0xF)
                herr |= (p >> 4) & 1
                hbad += (p >> 5) & 1
            b0, b1 = (nib[0] << 4) | nib[1], nib[2]
            b2 = ((nib[3] << 4) | nib[4]) ^ header_checksum(b0, b1)
            bt[:3] = [b0, b1, b2]
            crc_present, rdd, pl = b1 & 1, (b1 >> 1) & 7, b0
            dl = pl + (5 if crc_present else 3)
            check_crc = crc_present & cfg.crc_check
            unmask = crc_present
        else:
            crc_present, rdd, pl = int(cfg.crc_check), cfg.rdd, cfg.data_length
            dl = pl + (2 if cfg.crc_check else 0)
            check_crc = unmask = int(cfg.crc_check)
        pair_end = g["n1"] + 2 * max(dl - (g["d_ofs0"] + g["n1"]) // 2, 0)
        fec_err = fec_errors = 0
        bad, lo = hbad, 0
        for j in range(g["n_pay"]):
            cw = c[g["start"] + j]
            if j < g["n0"]:
                p = int(dec[4 * 256 + cw])
                bd = (p >> 5) & 1
            else:
                p = int(dec[rdd * 256 + cw]) if rdd <= 4 else 0
                bd = (p >> 5) & 1 if rdd == 4 else 0
            e = (p >> 4) & 1
            if (j < g["n0"] or g["n1"] <= j < pair_end
                    or (g["straggler"] and j == g["n0"])):
                fec_err |= e
                fec_errors += e
                bad += bd
            q = hb + (j >> 1)
            if j & 1:
                if q < M:
                    bt[q] = lo | ((p & 0xF) << 4)
            else:
                lo = p & 0xF
        if g["n_pay"] & 1 and hb + (g["n_pay"] >> 1) < M:
            bt[hb + (g["n_pay"] >> 1)] = lo
        n = min(max(pl, 0), M)
        res = 0
        for i in range(n):
            d = bt[i + hb] if i + hb < M else 0
            res = ((res << 8) & 0xFFFF) ^ int(crc_t[(res >> 8) & 0xFF]) ^ d
        crc = (res ^ int(vmask[n]) ^ (int(vmask[n + 1]) << 8)) & 0xFFFF
        lo_pos = hb + pl
        pkt_crc = bt[lo_pos % M] | (bt[(lo_pos + 1) % M] << 8)
        if unmask:
            if 0 <= lo_pos < M:
                bt[lo_pos] ^= crc & 0xFF
            if 0 <= lo_pos + 1 < M:
                bt[lo_pos + 1] ^= crc >> 8
        status = decoder.OK
        if cfg.explicit_header:
            if cfg.error_check and herr:
                status = decoder.DROP_HEADER_FEC
            elif rdd > 4:
                status = decoder.DROP_HEADER_RDD
        if status == decoder.OK and dl > M:
            status = decoder.DROP_LENGTH
        if status == decoder.OK and cfg.error_check and fec_err:
            status = decoder.DROP_FEC
        if status == decoder.OK and check_crc and pkt_crc != crc:
            status = decoder.DROP_CRC
        cut = cfg.explicit_header and not cfg.hdr
        for f, v in (("data", bt), ("offset", 3 if cut else 0),
                     ("length", dl - 5 if cut else dl), ("status", status),
                     ("packet_length", pl), ("rdd", rdd),
                     ("crc_present", crc_present), ("fec_errors", fec_errors),
                     ("bad", bad)):
            out[f].append(v)
    dtypes = dict(data=np.uint8, crc_present=bool)
    return {f: np.array(v).astype(dtypes.get(f, np.int32)).reshape(
        (B, M) if f == "data" else (B,)) for f, v in out.items()}


# --------------------------------------------------------------------------
# the cases, shared with the card test of kernel G
# --------------------------------------------------------------------------

# (sf, cr, ppm): every SF and every rate, and a PPM below the SF
CODES = [(7, "4/5", 0), (8, "4/6", 0), (9, "4/7", 0), (10, "4/8", 0),
         (11, "4/5", 0), (12, "4/8", 0), (12, "4/6", 10), (9, "4/8", 7)]
# (explicit_header, crc_check, hdr, error_check)
FLAGS = [(e, c, h, x) for e in (True, False) for c in (True, False)
         for h in (True, False) for x in (True, False)]
PAYLOAD = 9


def decode_cases(sf, cr, ppm, explicit_header, seed):
    """(cfg with crc_check, hdr and error_check to be set, symbols int64
    numpy [20, S]): 4 encoded frames, 4 with a payload symbol replaced, 4
    with a header symbol replaced, 8 uniformly random, each row followed by
    3 random symbols (a demodulator's mtu past the frame)."""
    rng = np.random.default_rng(seed)
    cfg = lora_tpu_torch.LoRaConfig(sf=sf, cr=cr, ppm=ppm,
                                    explicit_header=explicit_header,
                                    data_length=PAYLOAD)
    pay = rng.integers(0, 256, (12, PAYLOAD)).astype(np.uint8)
    enc = api.encode(pay, cfg, device="cpu").numpy().astype(np.int64)
    S0 = enc.shape[1]
    shift = sf - cfg.PPM
    # a symbol of a whole word moved, as a detector's wrong peak gives it
    hit = lambda n: rng.integers(1, 1 << cfg.PPM, n) << shift
    enc[4:8, rng.integers(8, S0, 4)] ^= hit(4)
    enc[8:12, rng.integers(0, 8, 4)] ^= hit(4)
    rows = np.concatenate([enc, rng.integers(0, cfg.N, (8, S0))])
    return cfg, np.concatenate([rows, rng.integers(0, cfg.N, (20, 3))], 1)


def flagged(cfg, flags):
    explicit, crc_check, hdr, error_check = flags
    assert cfg.explicit_header == explicit
    return cfg.replace(crc_check=crc_check, hdr=hdr, error_check=error_check)


def assert_fields_equal(got, want, what):
    """got {field: numpy}, want DecodeResult."""
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f).numpy(),
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("sf, cr, ppm", CODES)
def test_model_equals_plain_on_every_flag(sf, cr, ppm, explicit):
    cfg0, sym = decode_cases(sf, cr, ppm, explicit, 1000 * sf + 7 * ppm
                             + int(cr[-1]) + 3 * explicit)
    seen = set()
    for flags in FLAGS:
        if flags[0] != explicit:
            continue
        cfg = flagged(cfg0, flags)
        want = decoder.decode_plain(torch.as_tensor(sym), cfg,
                                        sym.shape[1])
        got = decode_model(sym, cfg, sym.shape[1])
        assert_fields_equal(got, want, f"{cfg}")
        seen |= set(got["status"].tolist())
    # the encoded rows decode; damage and noise reach the drops
    assert decoder.OK in seen
    if explicit:
        assert {decoder.DROP_HEADER_FEC, decoder.DROP_HEADER_RDD,
                decoder.DROP_LENGTH} <= seen


def test_random_symbols_reach_every_status_and_rates_5_to_7():
    """Over the grid's explicit cases: every status and every announced
    rate the header can carry."""
    statuses, rates = set(), set()
    for sf, cr, ppm in CODES:
        cfg0, sym = decode_cases(sf, cr, ppm, True, 77 + sf)
        for flags in FLAGS[:8]:
            got = decode_model(sym, flagged(cfg0, flags), sym.shape[1])
            statuses |= set(got["status"].tolist())
            rates |= set(got["rdd"].tolist())
    assert statuses == set(STATUS_CODES)
    assert rates == set(range(8))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.int64])
def test_model_equals_plain_on_symbols_below_the_width(dtype):
    """num_symbols below the row's width (the symbols past it are read, and
    the padding follows the row), in each dtype the callers pass; and a
    single frame [S]."""
    for sf, cr, ppm in CODES[:4]:
        cfg, sym = decode_cases(sf, cr, ppm, True, 5 + sf)
        cfg = cfg.replace(crc_check=True)
        S = sym.shape[1]
        for n in range(S - 8, S + 1):
            try:
                cuda_decode.geometry(cfg, S, n)
            except ValueError:
                continue
            want = decoder.decode_plain(torch.as_tensor(sym).to(dtype),
                                            cfg, n)
            assert_fields_equal(decode_model(sym, cfg, n), want, f"{cfg} {n}")
    one = api.decode(torch.as_tensor(sym[4]).to(dtype), cfg)
    got = decode_model(sym[4:5], cfg, S)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f][0], getattr(one, f).numpy())


def test_model_passes_gray_symbols_without_interleaving():
    rng = np.random.default_rng(3)
    for sf, ppm in ((7, 0), (12, 10)):
        cfg = lora_tpu_torch.LoRaConfig(sf=sf, ppm=ppm, interleaving=False)
        sym = rng.integers(-(1 << 20), 1 << 20, (4, 11))
        sym[0, :3] = [0, cfg.N - 1, -1]
        want = decoder.decode_plain(torch.as_tensor(sym), cfg, 11)
        np.testing.assert_array_equal(decode_model(sym, cfg, 11),
                                      want.numpy())


@pytest.mark.parametrize("cr", ["4/5", "4/8"])
@pytest.mark.parametrize("explicit", [True, False])
def test_refused_geometry_is_what_plain_cannot_decode(cr, explicit):
    """geometry, the wrapper's check, raises exactly where decode_plain
    fails on a shape, over every (width, num_symbols) of short rows; what
    it accepts decodes to M bytes a frame."""
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr=cr, explicit_header=explicit)
    rng = np.random.default_rng(11)
    for S in range(1, 30):
        sym = torch.as_tensor(rng.integers(0, cfg.N, (2, S)))
        for n in range(1, 34):
            try:
                M = cuda_decode.geometry(cfg, S, n).M
            except ValueError:
                with pytest.raises((RuntimeError, IndexError)):
                    decoder.decode_plain(sym, cfg, n)
                continue
            got = decoder.decode_plain(sym, cfg, n)
            assert got.data.shape == (2, M)
