"""A CPU model of the window routine of kernels A, B and C
(lora_tpu_torch/csrc/detect.cuh): which thread and register holds which
sample, the derotator's recurrence, the pass twiddles, the positions of
the exchange buffer with their padding, the bin each output register holds,
the |X|^2 store order and the peak search with its tie rule, replayed in
numpy for every window size from 64 to 4096 and held against numpy.fft.fft
and ops/detect.dechirp_detect.

Read from the header itself, so that an edit there reaches these tests: the
passes of each size (the Plan table: radices, team size), the exchange
buffer's padding rule (Geo's kPadded and kBuf) and the bin map of the last
pass (kb).  The loops of the passes (which position and which twiddle a
register meets) are a hand copy of detect_window: an edit to one must be
made in the other, and only the card tests hold the kernel itself.

The index maps are the part of a register FFT that a CPU can check; the
arithmetic runs in complex64 here as on the card.  Against a float64 FFT the
model's spectrum agrees within 2e-6 of the window's largest bin at N = 4096
(float32 rounding over 12 radix-2 stages); against the plain version
(torch.fft in float32) values are equal and the dB outputs and f_index
within 1e-3, the bar the card tests hold the kernels to.
"""

import math
import re

import numpy as np
import pytest
import torch

from lora_tpu_torch.ops import _cuda, tables
from lora_tpu_torch.ops import detect as det_ops

torch.set_num_threads(1)

SIZES = [64, 128, 256, 512, 1024, 2048, 4096]
W32 = np.exp(-2j * np.pi * np.arange(16) / 32).astype(np.complex64)


def plan(N):
    """(P, R0, R1, R2, T) of window size N, from detect.cuh's Plan table."""
    text = (_cuda.CSRC / "detect.cuh").read_text()
    m = re.search(r"struct Plan<%d>\s*\{ enum \{ P = (\d+), R0 = (\d+),\s*"
                  r"R1 = (\d+),\s*R2 = (\d+),\s*T = (\d+) \}"
                  % int(math.log2(N)), text)
    return tuple(int(g) for g in m.groups())


def _c_flat(expr, env):
    """A C integer expression without parentheses: at most one ?:, &&, ||,
    comparisons and arithmetic (/ is integer division)."""
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        a, b = rest.split(":", 1)
        return _c_flat(a if _c_flat(cond, env) else b, env)
    py = expr.replace("&&", " and ").replace("||", " or ").replace("/", "//")
    return int(eval(py, {"__builtins__": {}}, env))


def c_eval(expr, env):
    """The value of a C integer expression, innermost parentheses first."""
    inner = re.compile(r"\(([^()]*)\)")
    while "(" in expr:
        expr = inner.sub(lambda m: " %d " % _c_flat(m.group(1), env), expr)
    return _c_flat(expr, env)


def header_rule(pattern):
    """The right-hand side of the one statement of detect.cuh that matches
    `pattern` (a regex ending where the expression begins)."""
    text = (_cuda.CSRC / "detect.cuh").read_text()
    found = re.findall(pattern + r"\s*([^;]+);", text)
    assert len(found) == 1, (pattern, found)
    return " ".join(found[0].split())


def brev(p, bits):
    return int(format(p, f"0{bits}b")[::-1], 2) if bits else 0


def fft_reg(v):
    """fft_reg<R>: radix-2 decimation in frequency on the last axis, in
    place, natural order in, bit-reversed out."""
    R = v.shape[-1]
    h = R // 2
    while h >= 1:
        for b in range(0, R, 2 * h):
            for i in range(h):
                a, c = v[..., b + i].copy(), v[..., b + i + h].copy()
                v[..., b + i] = a + c
                v[..., b + i + h] = (a - c) * W32[i * (16 // h)]
        h //= 2


def pass_twiddles(N, P, R0, R1):
    """build_twiddles: W_N^(c*m) as [m][c], then W_Q0^(i*m) as [m][i], from
    the kernels' table exp(-2*pi*i*k/N), k < N/2."""
    half = tables.fft_twiddles_np(N)
    half = (half[:, 0] + 1j * half[:, 1]).astype(np.complex64)
    Q0 = N // R0
    i = np.arange(N + (Q0 if P == 3 else 0))
    q = Q0 // R1
    e = np.where(i < N, (i // Q0) * (i % Q0),
                 R0 * ((i - N) // max(q, 1)) * ((i - N) % max(q, 1))) & (N - 1)
    w = half[e & (N // 2 - 1)]
    return np.where(e < N // 2, w, -w)


def cis32(ang):
    """exp(i*ang) of float32 angles, rounded to complex64 as sincosf does."""
    ang = np.asarray(ang, np.float32).astype(np.float64)
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)


def derotator_start(rot, c, Q0):
    """The derotator of sample c + Q0*j is exp(i*rot*c) * exp(i*rot*Q0)^j:
    a thread calls sincosf twice a column (the float32 products rot*c, and
    rot*Q0, exact because Q0 is a power of two) and then multiplies by the
    step once per sample.  -> (w at j = 0 [T], step)."""
    rot = np.float32(rot)
    return cis32(rot * c.astype(np.float32)), cis32(rot * np.float32(Q0))


def conflict_free(addr, T, buf):
    """Every 16 consecutive lanes of a warp (one team, or two teams of 8
    whose buffers lie `buf` float2 apart) hit 16 different 8-byte banks."""
    for lo in range(0, max(T, 16), 16):
        if T >= 16:
            a = addr[lo : lo + 16]
        else:
            a = np.concatenate([addr + t * buf for t in range(16 // T)])
        if len(set(int(x) % 16 for x in a)) != 16:
            return False
    return True


def window_model(win, N, down=False, rot=None, check_banks=True):
    """Replay detect_window on one window (complex64 [N]): -> (mag2 float32
    [N] in the order the kernel stores it, regs [T, E] of |X|^2, bins [T, E]
    of each register, in the kernel's visiting order along the last axis)."""
    P, R0, R1, R2, T = plan(N)
    E = N // T
    Rl = R1 if P == 2 else R2
    ps = int(math.log2(Rl))
    Q0 = N // R0
    env = dict(N=N, P=P, R0=R0, R1=R1, R2=R2, T=T, E=E, Rl=Rl, Q0=Q0,
               kPadShift=ps)
    env["kPadded"] = c_eval(header_rule(r"constexpr int kPadded ="), env)
    buf = c_eval(header_rule(r"constexpr int kBuf ="), env)
    kb_rule = header_rule(r"kb\[a\] =")
    assert R0 * R1 * R2 == N and E <= 32
    assert all(E % r == 0 for r in (R0, R1, Rl))
    re, im = tables.dechirp_table_np(N, down)
    chirp = (re + 1j * im).astype(np.complex64)
    tw = pass_twiddles(N, P, R0, R1)
    lane = np.arange(T)
    s = np.full(buf, np.nan, np.complex64)
    v = np.zeros((T, E), np.complex64)
    banks_ok = True

    # pass 0
    for a in range(E // R0):
        c = lane + T * a
        if rot is not None:
            w, step = derotator_start(rot, c, Q0)
        for j in range(R0):
            n = c + Q0 * j
            x = win[n] * chirp[n]
            if rot is not None:
                x = x * w
                w = w * step
            v[:, a * R0 + j] = x
        fft_reg(v[:, a * R0 : (a + 1) * R0])
        for m in range(R0):
            x = v[:, a * R0 + brev(m, int(math.log2(R0)))]
            if m:
                x = x * tw[m * Q0 + c]
            p = c + Q0 * m
            banks_ok &= conflict_free(p + (p >> ps), T, buf)
            s[p + (p >> ps)] = x
    # middle pass
    if P == 3:
        q = Q0 // R1
        assert q == Rl
        for a in range(E // R1):
            f = lane + T * a
            i = f % q
            base = (f // q) * Q0 + i
            for j in range(R1):
                p = base + q * j
                banks_ok &= conflict_free(p + (p >> ps), T, buf)
                v[:, a * R1 + j] = s[p + (p >> ps)]
            fft_reg(v[:, a * R1 : (a + 1) * R1])
            for m in range(R1):
                x = v[:, a * R1 + brev(m, int(math.log2(R1)))]
                if m:
                    x = x * tw[N + m * q + i]
                p = base + q * m
                s[p + (p >> ps)] = x
    # last pass
    for a in range(E // Rl):
        p0 = (lane + T * a) * Rl
        for j in range(Rl):
            addr = p0 + (p0 >> ps) + j
            banks_ok &= conflict_free(addr, T, buf)
            v[:, a * Rl + j] = s[addr]
        fft_reg(v[:, a * Rl : (a + 1) * Rl])
    assert not np.isnan(v).any()  # every position read was written
    if check_banks:
        assert banks_ok, "the exchange has a bank conflict"
    S = N // Rl
    mag2 = np.full(N, np.nan, np.float32)
    regs = np.zeros((T, E), np.float32)
    bins = np.zeros((T, E), np.int64)
    o = 0
    for m in range(Rl):
        for a in range(E // Rl):
            f = lane + T * a
            kb = np.array([c_eval(kb_rule, dict(env, f=int(x))) for x in f])
            k = kb + S * m
            x = v[:, a * Rl + brev(m, ps)]
            m2 = (x.real * x.real + x.imag * x.imag).astype(np.float32)
            if P == 2:
                # one store instruction: consecutive lanes, consecutive bins
                assert np.array_equal(np.diff(k), np.ones(T - 1, np.int64))
            mag2[k] = m2
            regs[:, o], bins[:, o] = m2, k
            o += 1
    assert not np.isnan(mag2).any()  # every bin stored exactly once
    assert sorted(bins.reshape(-1)) == list(range(N))
    return mag2, regs, bins, P


def peak_model(regs, bins, P):
    """The kernel's peak search: each thread over its registers in visiting
    order, then the xor butterfly over the team's lanes (whole warps first,
    then the warps in order).  -> (value, best, total)."""
    T, E = regs.shape
    best = np.full(T, -1.0, np.float32)
    bi = np.zeros(T, np.int64)
    tot = np.zeros(T, np.float32)
    for o in range(E):
        m2, k = regs[:, o], bins[:, o]
        take = (m2 > best) | ((m2 == best) & (k < bi) if P == 3 else False)
        best, bi = np.where(take, m2, best), np.where(take, k, bi)
        tot = tot + m2
    off = min(T, 32) // 2
    lane = np.arange(T)
    while off:
        ob, oi = best[lane ^ off], bi[lane ^ off]
        tot = tot + tot[lane ^ off]
        take = (ob > best) | ((ob == best) & (oi < bi))
        best, bi = np.where(take, ob, best), np.where(take, oi, bi)
        off //= 2
    b, k, t = best[0], bi[0], tot[0]
    for w in range(1, T // 32):
        ob, oi = best[32 * w], bi[32 * w]
        t = t + tot[32 * w]
        if ob > b or (ob == b and oi < k):
            b, k = ob, oi
    # every lane of a warp holds its warp's result
    for w in range(max(T // 32, 1)):
        blk = slice(32 * w, 32 * w + min(T, 32))
        assert len(set(bi[blk])) == 1 and len(set(best[blk])) == 1
    return int(k), np.float32(b), np.float32(t)


def detect_model(win, N, down=False, rot=None):
    """DetectOut of one window: value, power, noise, findex, and mag2."""
    mag2, regs, bins, P = window_model(win, N, down, rot)
    k, best, tot = peak_model(regs, bins, P)
    scale = np.float32(20.0 * np.log10(N))
    db = lambda a: np.float32(20.0) * np.log10(
        np.maximum(a, np.float32(1e-20))) - scale
    fund = np.sqrt(best)
    # the neighbours come from the one register that holds each
    left = np.sqrt(regs[bins == (k - 1) % N][0])
    right = np.sqrt(regs[bins == (k + 1) % N][0])
    denom = np.float32(2.0) * fund - right - left
    findex = np.float32(0) if denom == 0 else np.float32(0.5) * (
        right - left) / denom
    return k, db(fund), db(np.sqrt(np.maximum(tot - best, np.float32(0)))), \
        findex, mag2


def tone_window(rng, N, down):
    k = rng.integers(0, N) + rng.uniform(-0.3, 0.3)
    re, im = tables.dechirp_table_np(N, down)
    x = np.exp(2j * np.pi * k * np.arange(N) / N) / (re + 1j * im)
    x += 0.05 * (rng.standard_normal(N) + 1j * rng.standard_normal(N))
    return x.astype(np.complex64)


@pytest.mark.parametrize("N", SIZES)
def test_model_spectrum_matches_numpy_fft(N):
    """The passes, twiddles, exchange positions and bin map give the DFT of
    the dechirped window, every bin stored once in natural order."""
    rng = np.random.default_rng(N)
    win = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
        np.complex64)
    re, im = tables.dechirp_table_np(N, False)
    want = np.abs(np.fft.fft(win.astype(np.complex128) * (re + 1j * im))) ** 2
    mag2 = window_model(win, N)[0]
    assert np.abs(mag2 - want).max() <= 2e-6 * want.max()


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("mode", ["up", "up_fe", "down_fe"])
def test_model_matches_plain_detect(N, mode):
    """With and without the derotation, up and down: the model's outputs
    against ops/detect.dechirp_detect (values equal; dB and f_index within
    1e-3; mag2 within 1e-4 of the peak)."""
    rng = np.random.default_rng(N + len(mode))
    down = mode == "down_fe"
    for _ in range(3):
        win = tone_window(rng, N, down)
        fe = None if mode == "up" else np.float32(rng.uniform(-2.5, 2.5))
        rot = None if fe is None else np.float32(-2 * math.pi / N) * fe
        k, power, noise, findex, mag2 = detect_model(win, N, down, rot)
        want = det_ops.dechirp_detect(
            torch.as_tensor(win)[None], down,
            None if fe is None else torch.as_tensor([fe]), want_mag2=True)
        assert k == int(want.value[0])
        assert abs(power - float(want.power[0])) <= 1e-3
        assert abs(noise - float(want.noise[0])) <= 1e-3
        assert abs(findex - float(want.f_index[0])) <= 1e-3
        w2 = want.mag2[0].numpy()
        assert np.abs(mag2 - w2).max() <= 1e-4 * w2.max()


# float32 rounding of one complex product (Higham: sqrt(5) * 2^-24 relative)
# plus one more unit for sincosf's own rounding of the two factors
CMUL_EPS = (math.sqrt(5) + 1) * 2.0 ** -24


@pytest.mark.parametrize("N", SIZES)
def test_derotator_recurrence_error_bound(N):
    """The recurrence against exp(i*rot*n) in float64 at the float32 angle
    of its two factors: after j steps at most (j + 1) * CMUL_EPS away, 32
    steps at most, so 6.4e-6 at the window's end: a phase error far below
    the 1e-4 of a window's peak that the spectra are held to, and of the
    size of the plain version's own float32 angle rot*n at a CFO of a few
    bins (half an ulp of 2*pi*f, 4.8e-7 * f/2 rad)."""
    P, R0, R1, R2, T = plan(N)
    Q0 = N // R0
    rng = np.random.default_rng(N)
    worst = 0.0
    for f in (0.3, -2.4, 17.25, -250.0, rng.uniform(-40, 40)):
        rot = np.float32(np.float32(-2 * math.pi / N) * np.float32(f))
        for a in range(N // T // R0):
            c = np.arange(T) + T * a
            w, step = derotator_start(rot, c, Q0)
            a0 = (rot * c.astype(np.float32)).astype(np.float64)
            a1 = np.float64(rot * np.float32(Q0))
            assert rot * np.float32(Q0) == np.float64(rot) * Q0  # exact
            for j in range(R0):
                err = np.abs(w - np.exp(1j * (a0 + j * a1))).max()
                assert err <= (j + 1) * CMUL_EPS, (f, j, err)
                worst = max(worst, err)
                w = w * step
    assert R0 <= 32 and worst <= 33 * CMUL_EPS < 6.4e-6


@pytest.mark.parametrize("N", SIZES)
def test_model_ties_go_to_the_lowest_bin(N):
    """Equal largest bins in any lanes and registers: the search returns the
    lowest, as torch.argmax does (lora_tpu/ops/detect.py:64-91); an all-zero
    window, a tie of every bin, reads bin 0."""
    rng = np.random.default_rng(N)
    _, regs, bins, P = window_model(np.zeros(N, np.complex64), N)
    assert not regs.any()
    assert peak_model(regs, bins, P)[0] == 0
    for _ in range(20):
        spec = rng.integers(0, 50, N).astype(np.float32)
        top = rng.choice(N, size=rng.integers(2, 6), replace=False)
        spec[top] = 77.0
        k, best, tot = peak_model(spec[bins], bins, P)
        assert k == top.min() == int(torch.argmax(torch.as_tensor(spec)))
        assert best == 77.0 and tot == spec.sum()


@pytest.mark.parametrize("N", SIZES)
def test_team_layout(N):
    """Teams of at most four warps, at most 32 samples a thread, whole teams
    in a block of 256 threads; N <= 1024 crosses threads once."""
    P, R0, R1, R2, T = plan(N)
    assert T in (8, 16, 32, 64, 128) and 256 % T == 0
    assert N // T in (8, 16, 32)
    assert P == (2 if N <= 1024 else 3)
    assert all(r in (1, 8, 16, 32) for r in (R0, R1, R2))
