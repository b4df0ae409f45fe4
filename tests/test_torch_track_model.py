"""A CPU replay of kernel B's scan (lora_tpu_torch/csrc/track.cu) against
its plain version, ops/cuda_demod.track_plain.

The kernel gives each candidate to one team that walks its windows alone:
it detects window k, detects the lookahead window k + 1 only where the sync
test can still hold (unsquelched, previous nibble 0, this nibble the first
sync nibble), ends the scan at the sync, and then detects the downchirp
pair.  The plain version detects every pair of all 13 steps for the whole
batch.  `track_model` repeats the kernel's control flow candidate by
candidate over the plain detector, one window a call, so what is held here
is that control flow: all six outputs must be equal to track_plain's, bit
for bit, on banks with frames, without, with a squelched gap before the
preamble, and with K = 2 candidates a channel.  The kernel's own arithmetic
(the register FFT of detect.cuh) is held by tests/test_torch_fft_model.py
and, on the card, by tests/test_torch_cuda.py.
"""

import re

import numpy as np
import pytest
import torch

import lora_tpu_torch
from lora_tpu_torch.models import demodulator as dm
from lora_tpu_torch.models import modulator as tmod
from lora_tpu_torch.ops import _cuda, cuda_demod, tables
from lora_tpu_torch.ops import detect as det_ops

torch.set_num_threads(1)

TRACK_CU = (_cuda.CSRC / "track.cu").read_text()
# power less noise of a noise-only window is about -12 dB and of a preamble
# chirp at this noise above 0 dB: between them the squelch has work to do
THRESH = -6.0
FIELDS = ("synced", "k_sync", "freq_error", "fine_total", "power", "snr")


def track_model(x, t0, sync, thresh, N):
    """track.cu's scan, one candidate at a time.  x [B, T] complex64, t0 [B]
    or [B, K] -> (outputs as track_plain's, windows transformed [B, *K])."""
    n_scan = int(re.search(r"kScan = (\d+);", TRACK_CU).group(1))
    assert n_scan == tables.N_SCAN
    sync0, sync1 = sync >> 4, sync & 0xF
    thr = torch.tensor(thresh, dtype=torch.float32)
    lead = tuple(t0.shape)
    K = lead[1] if len(lead) == 2 else 1
    out = {f: [] for f in FIELDS}
    transformed = []

    def detect(b, start, w, down, ferr, findex):
        win = x[b, start + w * N : start + (w + 1) * N][None]
        return det_ops.dechirp_detect(win, down, ferr[None],
                                      want_f_index=findex)

    for m, start in enumerate(t0.reshape(-1).tolist()):
        b = m // K
        state, prev_q, k_sync = 0, 999, 0
        ferr = torch.zeros((), dtype=torch.float32)
        n_win = 0
        for k in range(n_scan):
            o = detect(b, start, k, False, ferr, True)
            n_win += 1
            squelched = bool((o.power[0] - o.noise[0]) < thr)
            q = (int(o.value[0]) + 4) // 8
            is_sync = False
            if not squelched and prev_q == 0 and q == sync0:
                o1 = detect(b, start, k + 1, False, ferr, False)
                n_win += 1
                is_sync = (int(o1.value[0]) + 4) // 8 == sync1
            if is_sync:
                state, k_sync = 1, k
                break
            ferr = torch.zeros_like(ferr) if squelched else ferr + o.f_index[0]
            prev_q = q
        d0 = detect(b, start, k_sync + 2, True, ferr, False)
        d1 = detect(b, start, k_sync + 3, True, ferr, False)
        n_win += 2
        v0, v1 = (int(d.value[0]) for d in (d0, d1))
        v0 = v0 - N if v0 > N // 2 else v0
        v1 = v1 - N if v1 > N // 2 else v1
        freq_error = int((v0 + v1) / 2)  # C division: toward zero
        out["synced"].append(state == 1)
        out["k_sync"].append(k_sync)
        out["freq_error"].append(freq_error)
        out["fine_total"].append(ferr + np.float32(int(freq_error / 2)))
        out["power"].append(d1.power[0])
        out["snr"].append(d1.power[0] - d1.noise[0])
        transformed.append(n_win)
    res = {
        "synced": torch.tensor(out["synced"]),
        "k_sync": torch.tensor(out["k_sync"], dtype=torch.int32),
        "freq_error": torch.tensor(out["freq_error"], dtype=torch.int32),
        "fine_total": torch.stack(out["fine_total"]),
        "power": torch.stack(out["power"]),
        "snr": torch.stack(out["snr"]),
    }
    return ({f: v.reshape(lead) for f, v in res.items()},
            torch.tensor(transformed).reshape(lead))


def bank(sf, rng, B):
    """B buffers: frames of random symbols at random delays with a CFO and
    noise; channel B - 2 holds noise only; channel B - 1 is scanned from two
    windows of noise before its preamble (squelched at THRESH)."""
    cfg = lora_tpu_torch.LoRaConfig(sf=sf, cr="4/8", ampl=1.0, mtu=8)
    N = cfg.N
    frames = tmod.modulate(torch.as_tensor(rng.integers(0, N, (B, cfg.mtu))),
                           cfg, device="cpu").numpy()
    T = dm.required_samples(cfg) + 8 * N
    x = np.zeros((B, T), np.complex64)
    delay = rng.integers(0, 3 * N, B)
    delay[B - 1] = 3 * N + 17
    for b in range(B):
        if b != B - 2:
            x[b, delay[b] : delay[b] + frames.shape[1]] = \
                frames[b, : T - delay[b]]
    cfo = rng.uniform(-2.3, 2.3, (B, 1))
    cfo[B - 1] = 0.3
    x *= np.exp(2j * np.pi * cfo * np.arange(T) / N)
    x += 0.2 * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    x = torch.as_tensor(x.astype(np.complex64))
    _, t0, _ = dm._align_frame(*dm._coarse_detect(x, cfg, False), cfg, T)
    t0[B - 1] = N + 17  # the scan starts in the noise, not where it aligned
    return cfg, x, t0


@pytest.mark.parametrize("n_cand", [1, 2])
@pytest.mark.parametrize("sf", [7, 8])
def test_scan_with_conditional_lookahead_equals_plain(sf, n_cand):
    rng = np.random.default_rng(10 * sf + n_cand)
    B = 8
    cfg, x, t0 = bank(sf, rng, B)
    N, T = cfg.N, x.shape[1]
    if n_cand == 2:
        # the second candidate of a channel starts a few windows on, inside
        # or behind the first one's preamble
        later = t0 + torch.as_tensor(rng.integers(1, 7, B) * N + 3,
                                     dtype=t0.dtype)
        t0 = torch.stack([t0, later.clamp(max=T - tables.TRACK_ROWS * N)], 1)
    want = cuda_demod.track_plain(x, t0, cfg.sync, THRESH, N)
    got, n_win = track_model(x, t0, cfg.sync, THRESH, N)
    first = want["synced"].reshape(B, -1)[:, 0]
    assert bool(first[: B - 2].all()) and bool(first[B - 1])
    assert not bool(first[B - 2])  # noise only
    assert int(want["k_sync"].reshape(B, -1)[B - 1, 0]) >= 10  # behind the noise
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        assert torch.equal(got[f], want[f]), f
    # a synced candidate transforms its scan up to the sync, the lookaheads
    # and the downchirp pair: far fewer than the 13 pairs + 2 of the plain scan
    synced = want["synced"]
    assert bool((n_win[synced] >= want["k_sync"][synced] + 4).all())
    assert bool((n_win[synced] <= want["k_sync"][synced] + 6).all())
    assert bool((n_win[~synced] >= tables.N_SCAN + 2).all())
    assert int(n_win.max()) <= 2 * tables.N_SCAN + 2


def test_kernel_b_has_no_block_barrier_in_its_scan():
    """One __syncthreads() in the whole source, after the block's twiddles
    and before the scan; one copy of the window routine; no shared scan
    state; no decision by one thread."""
    code = re.sub(r"//[^\n]*", "", TRACK_CU)
    assert code.count("__syncthreads()") == 1
    assert code.count("detect_window<") == 1
    assert code.index("__syncthreads()") < code.index("detect_window<")
    assert re.findall(r"__shared__ (\w+)", code) == ["float2"]  # smem[] alone
    assert "threadIdx.x == 0" not in code
