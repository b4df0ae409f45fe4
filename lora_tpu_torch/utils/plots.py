"""Visual observability: render the demodulator debug taps to a PNG (port of
lora_tpu/utils/plots.py; the tensors are read through `.cpu()`).

The reference wires its demod debug ports into live plotters — `raw` and
`dec` into spectral/waterfall views and `fft` into a logic-analyzer lane
(LoRaDemod.cpp:81-83, examples/rx_RN2483.pth).  `demodulate(...,
debug=True)` computes the same taps in one batched pass; this module is the
headless renderer: a committed artifact instead of a GUI.

Matplotlib is an optional dependency (present in dev images; the library
itself never imports this module).
"""

from __future__ import annotations

import numpy as np

from ..config import LoRaConfig
from ..ops.cplx import host

# chart tokens (validated default palette, light mode)
_SURFACE = "#fcfcfb"
_TEXT = "#0b0b0b"
_TEXT2 = "#52514e"
_GRID = "#e4e3df"
_S1 = "#2a78d6"  # series 1 (blue)
_S2 = "#eb6834"  # series 2 (orange)


def render_taps(dem, cfg: LoRaConfig, path: str, channel: int = 0) -> str:
    """Render one channel's debug taps (requires demodulate(debug=True)):

      * waterfall of the payload DFT spectra (fft tap, dB) — magnitude is
        a single-hue sequential ramp, symbol decisions overlaid
      * detected symbol values per window (the logic-analyzer lane)
      * raw tap: |input| sample magnitude of the aligned payload windows

    Returns `path`.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if dem.fft_mag2 is None or dem.raw is None:
        raise ValueError("taps missing: call demodulate(..., debug=True)")

    def chan(a):
        a = host(a)
        return a[channel] if a.ndim > 2 else a

    mag2 = chan(dem.fft_mag2)                      # [mtu, N]
    raw = chan(dem.raw)                            # complex64 [mtu, N]
    raw_re, raw_im = raw.real, raw.imag
    sym = host(dem.symbols)
    sym = sym[channel] if sym.ndim > 1 else sym
    count = int(host(dem.count).reshape(-1)[channel])
    mtu, N = mag2.shape

    db = 10.0 * np.log10(np.maximum(mag2, 1e-12))
    amp = np.hypot(raw_re, raw_im).reshape(-1)

    fig, axes = plt.subplots(
        3, 1, figsize=(9, 8), facecolor=_SURFACE,
        gridspec_kw={"height_ratios": [3, 1.2, 1.2]},
    )
    ax = axes[0]
    im = ax.imshow(
        db.T, aspect="auto", origin="lower", cmap="Blues",
        extent=(0, mtu, 0, N), interpolation="nearest",
    )
    ax.plot(
        np.arange(count) + 0.5, sym[:count], ".", color=_S2, markersize=5,
        label="detected symbol",
    )
    ax.set_ylabel("DFT bin", color=_TEXT, fontsize=9)
    ax.set_title(
        f"payload spectra (fft tap, dB) — SF{cfg.sf}, {count} symbols",
        color=_TEXT, fontsize=11,
    )
    ax.legend(frameon=False, fontsize=8, labelcolor=_TEXT)
    cb = fig.colorbar(im, ax=ax, pad=0.01)
    cb.ax.tick_params(colors=_TEXT2, labelsize=7)

    ax = axes[1]
    ax.step(
        np.arange(count), sym[:count], where="post", color=_S1, linewidth=2
    )
    ax.set_ylabel("symbol", color=_TEXT, fontsize=9)
    ax.set_xlim(0, max(count, 1))

    ax = axes[2]
    ax.plot(amp, color=_S1, linewidth=0.8)
    ax.set_ylabel("|raw|", color=_TEXT, fontsize=9)
    ax.set_xlabel(
        "sample (aligned payload windows, raw tap)", color=_TEXT2, fontsize=9
    )
    for a in axes:
        a.set_facecolor(_SURFACE)
        a.grid(True, color=_GRID, linewidth=0.6)
        a.tick_params(colors=_TEXT2, labelsize=8)
        for s in a.spines.values():
            s.set_color(_GRID)
    fig.tight_layout()
    fig.savefig(path, dpi=150, facecolor=_SURFACE, bbox_inches="tight")
    plt.close(fig)
    return path


def render_fm(re, im, path: str, max_samples: int = 200_000) -> str:
    """Render the FM-discriminated view of a capture burst: amplitude
    envelope + instantaneous frequency (hw.capture.fm_discriminate).

    The reference's reverse-engineering diagnostic (RN2483Capture.py:80-97):
    LoRa chirps appear as a frequency sawtooth whose reset positions read
    out the symbol values directly — the tool that derived the whitening
    tables.  Returns `path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..hw.capture import fm_discriminate

    re = host(re).reshape(-1)[:max_samples]
    im = host(im).reshape(-1)[:max_samples]
    freq, amp = fm_discriminate(re, im)
    # mask frequency where there is no signal (discriminated noise is
    # uniform in [-pi, pi) and would bury the sawtooth)
    floor = 4.0 * np.median(amp) + 1e-12
    fshow = np.where(amp > floor, freq, np.nan)

    fig, axes = plt.subplots(2, 1, figsize=(11, 5), sharex=True)
    ax = axes[0]
    ax.plot(amp, color=_S1, linewidth=0.7)
    ax.set_ylabel("|x|", color=_TEXT, fontsize=9)
    ax.set_title(
        "capture burst: amplitude + FM discriminator", color=_TEXT,
        fontsize=11,
    )
    ax = axes[1]
    ax.plot(fshow, color=_S2, linewidth=0.7)
    ax.set_ylabel("inst. freq (rad/sample)", color=_TEXT, fontsize=9)
    ax.set_xlabel("sample", color=_TEXT2, fontsize=9)
    ax.set_ylim(-np.pi, np.pi)
    for a in axes:
        a.set_facecolor(_SURFACE)
        a.grid(True, color=_GRID, linewidth=0.6)
        a.tick_params(colors=_TEXT2, labelsize=8)
        for s in a.spines.values():
            s.set_color(_GRID)
    fig.tight_layout()
    fig.savefig(path, dpi=150, facecolor=_SURFACE, bbox_inches="tight")
    plt.close(fig)
    return path
