"""Kernels B (track, csrc/track.cu) and C (payload, csrc/payload.cu).

The port of lora_tpu/ops/pallas_demod.py.  Both kernels read each window at
its own sample offset in the channel buffer x [B, T], so one track kernel
covers the JAX package's `track` and `track_direct`, and one payload kernel
covers `payload_detect` (flat and tiled) and `payload_detect_direct`.

Each has its plain PyTorch version here: `track_plain` is the sync scan of
models/demodulator._scan_track over gathered, shifted windows, and
`payload_detect_plain` is the demodulator's fused="off" payload branch.
The wrappers take the plain version only for a tensor on the CPU; for a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import detect as det_ops
from . import shift as shift_ops
from .tables import N_SCAN, TRACK_ROWS, N_TRACK_WIN


def trunc_half(x: torch.Tensor) -> torch.Tensor:
    """C-style integer division by 2 (toward zero)."""
    return torch.div(x, 2, rounding_mode="trunc")


def _signed(v: torch.Tensor, N: int) -> torch.Tensor:
    return torch.where(v > N // 2, v - N, v)


# --------------------------------------------------------------------------
# track
# --------------------------------------------------------------------------

def track_plain(x: torch.Tensor, t0: torch.Tensor, sync: int, thresh: float,
                N: int) -> dict:
    """Sync scan + downchirp CFO from aligned starts t0 [B] in buffers
    x [B, T] (t0 <= T - TRACK_ROWS*N).  Returns synced, k_sync, freq_error,
    fine_total, power, snr [B] (lora_tpu/models/demodulator.py:198-278)."""
    B = x.shape[0]
    dev = x.device
    t0 = t0.to(torch.int64)
    xs = shift_ops.shift_windows(
        shift_ops.gather_rows(x, t0 // N, TRACK_ROWS, N), t0 % N, N_TRACK_WIN
    )
    thr = torch.tensor(thresh, dtype=torch.float32, device=dev)
    sync0, sync1 = sync >> 4, sync & 0xF
    state = torch.zeros(B, dtype=torch.int32, device=dev)
    ferr = torch.zeros(B, dtype=torch.float32, device=dev)
    prev_q = torch.full((B,), 999, dtype=torch.int32, device=dev)
    k_sync = torch.zeros(B, dtype=torch.int32, device=dev)
    for k in range(N_SCAN):
        d2 = det_ops.dechirp_detect(xs[:, k : k + 2], ferr=ferr[:, None])
        squelched = (d2.power[:, 0] - d2.noise[:, 0]) < thr
        q = (d2.value[:, 0] + 4) // 8
        q1 = (d2.value[:, 1] + 4) // 8
        searching = state == 0
        is_sync = searching & ~squelched & (prev_q == 0) & (q == sync0) & (
            q1 == sync1)
        state = torch.where(is_sync, 1, state)
        k_sync = torch.where(is_sync, k, k_sync)
        ferr = torch.where(
            searching & ~is_sync & ~squelched,
            ferr + d2.f_index[:, 0],
            torch.where(searching & squelched, 0.0, ferr),
        )
        prev_q = torch.where(searching, q, prev_q)
    idx = k_sync.long()[:, None] + torch.arange(2, 4, device=dev)
    rows_dc = torch.take_along_dim(xs, idx[:, :, None], dim=1)
    ddc = det_ops.dechirp_detect(rows_dc, down=True, ferr=ferr[:, None],
                                 want_f_index=False)
    freq_error = trunc_half(_signed(ddc.value[:, 0], N)
                            + _signed(ddc.value[:, 1], N)).to(torch.int32)
    return {
        "synced": state == 1,
        "k_sync": k_sync,
        "freq_error": freq_error,
        "fine_total": ferr + trunc_half(freq_error).to(torch.float32),
        "power": ddc.power[:, 1],
        "snr": ddc.power[:, 1] - ddc.noise[:, 1],
    }


def track(x: torch.Tensor, t0: torch.Tensor, sync: int, thresh: float,
          N: int) -> dict:
    """Kernel B wrapper: same contract as track_plain."""
    if x.device.type == "cpu":
        return track_plain(x, t0, sync, thresh, N)
    _cuda.check_buffer(x, "track")
    _cuda.check_window_size(N)
    B, T = x.shape
    if T < TRACK_ROWS * N:
        raise ValueError(f"track: buffer of {T} samples < {TRACK_ROWS} windows")
    dev = x.device
    t0 = _cuda.on_device(t0, torch.int32, dev, (B,), "t0")
    i32 = lambda: torch.empty(B, dtype=torch.int32, device=dev)
    f32 = lambda: torch.empty(B, dtype=torch.float32, device=dev)
    state, k_sync, freq_error = i32(), i32(), i32()
    fine_total, power, snr = f32(), f32(), f32()
    up, dn, tw, rot_scale, db_scale = _cuda.consts(N, dev)
    err = _cuda.library().lora_track(
        x.data_ptr(), x.stride(0), B, T, N, t0.data_ptr(), sync >> 4,
        sync & 0xF, float(thresh), up.data_ptr(), dn.data_ptr(),
        tw.data_ptr(), rot_scale, db_scale, state.data_ptr(),
        k_sync.data_ptr(), freq_error.data_ptr(), fine_total.data_ptr(),
        power.data_ptr(), snr.data_ptr(), _cuda.stream(dev),
    )
    _cuda.check(err, "lora_track")
    track.launches += 1
    return {
        "synced": state == 1,
        "k_sync": k_sync,
        "freq_error": freq_error,
        "fine_total": fine_total,
        "power": power,
        "snr": snr,
    }


track.launches = 0


# --------------------------------------------------------------------------
# payload
# --------------------------------------------------------------------------

def payload_detect_plain(x: torch.Tensor, data_start: torch.Tensor,
                         fine_total: torch.Tensor, mtu: int, N: int):
    """mtu windows per channel from data_start [B] in buffers x [B, T],
    dechirped, derotated by fine_total [B] and detected without the
    fractional bin -> (value, power, noise) [B, mtu]
    (lora_tpu/models/demodulator.py:560-578)."""
    ds = data_start.to(torch.int64)
    xd = shift_ops.shift_windows(
        shift_ops.gather_rows(x, ds // N, mtu + 1, N), ds % N, mtu
    )
    dd = det_ops.dechirp_detect(xd, ferr=fine_total[:, None],
                                want_f_index=False)
    return dd.value, dd.power, dd.noise


def payload_detect(x: torch.Tensor, data_start: torch.Tensor,
                   fine_total: torch.Tensor, mtu: int, N: int):
    """Kernel C wrapper: same contract as payload_detect_plain."""
    if x.device.type == "cpu":
        return payload_detect_plain(x, data_start, fine_total, mtu, N)
    _cuda.check_buffer(x, "payload_detect")
    _cuda.check_window_size(N)
    B, T = x.shape
    if T < (mtu + 1) * N:
        raise ValueError(f"payload_detect: buffer of {T} samples < mtu + 1 "
                         "windows")
    dev = x.device
    ds = _cuda.on_device(data_start, torch.int32, dev, (B,), "data_start")
    fe = _cuda.on_device(fine_total, torch.float32, dev, (B,), "fine_total")
    value = torch.empty((B, mtu), dtype=torch.int32, device=dev)
    power = torch.empty((B, mtu), dtype=torch.float32, device=dev)
    noise = torch.empty((B, mtu), dtype=torch.float32, device=dev)
    up, _, tw, rot_scale, db_scale = _cuda.consts(N, dev)
    err = _cuda.library().lora_payload(
        x.data_ptr(), x.stride(0), B, T, N, mtu, ds.data_ptr(), fe.data_ptr(),
        up.data_ptr(), tw.data_ptr(), rot_scale, db_scale, value.data_ptr(),
        power.data_ptr(), noise.data_ptr(), _cuda.stream(dev),
    )
    _cuda.check(err, "lora_payload")
    payload_detect.launches += 1
    return value, power, noise


payload_detect.launches = 0
