"""Critically-sampled polyphase DFT channelizer, wideband -> channel bank
(port of lora_tpu/ops/channelizer.py).

A wideband capture at rate K*BW splits into K channels at rate BW:

    y_k[m] = sum_p e^{+2 pi i p k / K} * sum_l h[lK+p] x[(m-l)K - p]

i.e. a flipped commutator Xrev[r, p] = xp[rK + K-1-p] over the
state-prepended stream xp, a per-phase FIR with the prototype's polyphase
components, then a K-point IDFT across phases.  Channel k is centred at
+k/K of the wideband rate (negative frequencies are K-k).

`channelize` runs the filterbank through kernel D (csrc/channelize.cu,
ops/cuda_channelize.filterbank) for a CUDA tensor and through its plain
version, the JAX package's block-Toeplitz matrix product, for a CPU
tensor.  Kernel D reads the filter history and the block through two
pointers: only the plain version concatenates them.  `synthesize` (the TX
combiner) is that same product with the synthesis matrix; the JAX package
computes both products in XLA, outside any Pallas kernel, and the port
leaves them to torch.matmul in full float32.  `upconvert` and
`synthesize_tone` build test vectors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..roadmap import no_counterpart, not_ported
from . import cplx, tables

IMPLS = ("auto", "xla", "fir", "pallas")


@functools.lru_cache(maxsize=None)
def _bank_matrix(synthesis: bool, K: int, taps_per_phase: int, G: int,
                 device: torch.device) -> torch.Tensor:
    """complex64 [(L+G-1)*K, G*K] analysis (tables.fir_idft_matrix) or
    synthesis (tables.fir_dft_syn_matrix) matrix on `device`."""
    build = tables.fir_dft_syn_matrix if synthesis else tables.fir_idft_matrix
    re, im = build(K, taps_per_phase, G)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def bank_product(z: torch.Tensor, synthesis: bool, K: int,
                 taps_per_phase: int, G: int) -> torch.Tensor:
    """Grouped rows z [..., Q, (L+G-1)*K] times the bank matrix."""
    w = _bank_matrix(synthesis, K, taps_per_phase, G, z.device)
    with cplx.full_float32():
        return torch.matmul(z, w)


def default_group(M: int) -> int:
    """Output samples G per grouped row of the plain product: the largest
    of 8, 4, 2, 1 that divides M (the JAX package's default)."""
    return next(g for g in (8, 4, 2, 1) if M % g == 0)


def _grouped_rows(a: torch.Tensor, K: int, taps_per_phase: int,
                  G: int) -> torch.Tensor:
    """[..., rows, K] -> [..., Q, R*K] grouped matmul operand:
    Z[q, r*K + p] = a[qG + r, p] (R = L + G - 1, Q = (rows - L + 1) // G),
    as a concat of ceil(R/G) contiguous reshaped views of `a`."""
    L = taps_per_phase
    R = L + G - 1
    Q = (a.shape[-2] - L + 1) // G
    lead = a.shape[:-2]
    pieces = []
    r0 = 0
    while r0 < R:
        w = min(G, R - r0) * K
        seg = a[..., r0 : r0 + Q * G, :]
        short = Q * G - seg.shape[-2]
        if short:  # missing tail rows land in lanes sliced off below
            seg = torch.cat([seg, seg.new_zeros((*lead, short, K))], -2)
        pieces.append(seg.reshape(*lead, Q, G * K)[..., :w])
        r0 += G
    return torch.cat(pieces, -1)


def channelize(x, K: int, taps_per_phase: int = 8, state=None,
               bf16: bool = False,
               impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Split wideband IQ [..., T] (T % K == 0) into K channels.

    Returns (y, new_state): y complex64 [..., K, T//K], channel k at
    baseband, and new_state [..., taps_per_phase*K - 1], the last samples
    of state ++ x, to pass as `state` with the next block.  With
    state=None the filter history starts at zero.

    impl: "auto" runs kernel D for a CUDA tensor and the plain version for
    a CPU tensor; "fir" and "pallas" (the JAX package's two filterbank
    kernels) both mean kernel D; "xla" is the plain version on any device.
    On a CUDA tensor a (K, taps_per_phase) that kernel D does not take
    raises ValueError.  The JAX package's `group`, a tuning knob of its
    plain product, is not taken: the plain version picks G itself.
    """
    if bf16:
        raise not_ported("bf16=True", 5)
    if impl in ("fir-interpret", "pallas-interpret"):
        raise no_counterpart(f"impl={impl!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    from . import cuda_channelize

    x = cplx.as_iq(x)
    T = x.shape[-1]
    if T % K:
        raise ValueError(f"block length {T} not divisible by K={K}")
    L = taps_per_phase
    hist = L * K - 1  # filter length minus one
    if state is not None:
        state = cplx.as_iq(state, x.device)
    if impl == "xla":
        y = cuda_channelize.filterbank_plain(prepended(x, state, hist), K, L,
                                             T // K)
    else:
        y = cuda_channelize.filterbank(x, K, L, state)
    return y, next_state(x, state, hist)


def prepended(x: torch.Tensor, state: torch.Tensor | None,
              hist: int) -> torch.Tensor:
    """state ++ x [..., hist + T], the stream the plain version reads; a
    state of None is `hist` zeros."""
    if state is None:
        state = x.new_zeros((*x.shape[:-1], hist))
    return torch.cat([state, x], -1)


def next_state(x: torch.Tensor, state: torch.Tensor | None,
               hist: int) -> torch.Tensor:
    """The last `hist` samples of state ++ x, from the tails alone."""
    T = x.shape[-1]
    if T >= hist:
        return x[..., T - hist:].clone()
    return prepended(x, state, hist)[..., T:].clone()


def synthesize(u, taps_per_phase: int = 8, state=None,
               bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthesis filterbank (TX combiner), the transpose of channelize:
    channels u [..., K, M] -> (x [..., M*K] wideband, new_state
    [..., K, L-1] tail channel samples for the next block).  The output is
    causal: the prototype's group delay is not compensated, so chunked
    calls concatenate exactly."""
    if bf16:
        raise not_ported("bf16=True", 5)
    u = cplx.as_iq(u)
    K, M = u.shape[-2], u.shape[-1]
    L = taps_per_phase
    if state is None:
        state = u.new_zeros((*u.shape[:-2], K, L - 1))
    else:
        state = cplx.as_iq(state, u.device)
    new_state = u[..., :, M - (L - 1):].clone() if L > 1 else state
    # rows[m, k]: the state's rows first, then the block's
    rows = torch.cat([state.transpose(-1, -2), u.transpose(-1, -2)], -2)
    G = default_group(M)
    x = bank_product(_grouped_rows(rows, K, L, G), True, K, L, G)
    return x.reshape(*u.shape[:-2], M * K), new_state


def synthesize_tone(T: int, freq_cycles_per_sample: float,
                    ampl: float = 1.0) -> torch.Tensor:
    """Test helper: complex exponential e^{2 pi i f n}, built in float64."""
    ang = 2 * np.pi * freq_cycles_per_sample * np.arange(T)
    return torch.complex(
        torch.from_numpy((ampl * np.cos(ang)).astype(np.float32)),
        torch.from_numpy((ampl * np.sin(ang)).astype(np.float32)),
    )


def upconvert(x, K: int, channel: int, T_out: int | None = None
              ) -> torch.Tensor:
    """Test helper: narrowband IQ [..., M] onto wideband channel `channel`
    of a K-channel grid by zero-stuffing, interpolation with K times the
    prototype (delay-compensated) and mixing to +channel/K.  O(K*L) per
    output sample: for test vectors and small banks."""
    x = cplx.as_iq(x)
    M = x.shape[-1]
    T = M * K if T_out is None else T_out
    lead = x.shape[:-1]
    z = x.new_zeros((*lead, M, K))
    z[..., :, 0] = x
    z = z.reshape(-1, 1, M * K)
    h = torch.from_numpy(tables.prototype(K) * K).to(x.device)
    L = h.shape[0]
    # full convolution with h; conv1d correlates, so the taps are flipped
    w = h.flip(0).reshape(1, 1, L)
    conv = lambda a: torch.nn.functional.conv1d(a, w, padding=L - 1)
    out = torch.complex(conv(z.real.contiguous()), conv(z.imag.contiguous()))
    out = out.reshape(*lead, M * K + L - 1)
    delay = (L - 1) // 2
    out = out[..., delay : delay + T]
    ang = 2 * np.pi * channel / K * np.arange(out.shape[-1])
    mix = torch.complex(torch.from_numpy(np.cos(ang).astype(np.float32)),
                        torch.from_numpy(np.sin(ang).astype(np.float32)))
    return out * mix.to(x.device)
