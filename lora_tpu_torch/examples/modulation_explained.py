"""The LoRa PHY math, step by step (port of examples/modulation_explained.py,
itself the equivalent of the reference's modulation_explained_plots.py): an
independent NumPy model of modulate / dechirp / FFT-argmax, held against
the port's detector (ops/detect) on the same waveform.

    python -m lora_tpu_torch.examples.modulation_explained [--sf 8]
        [--plot [--out FILE]] [--device cpu]

--plot draws three panels with matplotlib (imported only then) into --out,
build/lora_tpu_torch/modulation_explained.png by default.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..tools import OUT_DIR, out_path, pick_device


def numpy_modulate(symbols, N):
    """Pure-NumPy CSS modulation: symbol s = upchirp cyclically shifted by
    s bins; instantaneous frequency sweeps one full bandwidth per symbol.
    The frequency steps *before* each sample is integrated: the reference
    generator's (i+1)*fStep convention (ChirpGenerator.hpp:36)."""
    out = []
    phase = 0.0
    for s in symbols:
        f = ((s + 1 + np.arange(N)) % N) / N - 0.5  # cycles/sample
        phase = phase + 2 * np.pi * np.cumsum(f)
        out.append(np.exp(1j * phase))
        phase = phase[-1]
    return np.concatenate(out)


def numpy_demodulate(x, N):
    """Dechirp by the conjugate base chirp, FFT, argmax."""
    f0 = ((1 + np.arange(N)) % N) / N - 0.5
    down = np.exp(-2j * np.pi * np.cumsum(f0))
    syms = []
    for i in range(len(x) // N):
        spec = np.fft.fft(x[i * N : (i + 1) * N] * down)
        syms.append(int(np.argmax(np.abs(spec))))
    return syms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lora_tpu_torch.examples.modulation_explained",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR / "modulation_explained.png"))
    ap.add_argument("--sf", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = pick_device(args.device, "modulation_explained")
    N = 1 << args.sf

    symbols = [0, 37, 200, N - 1]
    print(f"1. modulate symbols {symbols} at SF{args.sf} (N={N} chips)")
    x = numpy_modulate(symbols, N)
    print(f"   -> {x.size} complex samples, |x|=1 (constant envelope)")

    print("2. dechirp x conj(base upchirp): each symbol becomes a pure tone")
    got = numpy_demodulate(x, N)
    print(f"3. FFT argmax per window -> {got}")
    assert got == symbols, "numpy model must round-trip"

    # cross-check the port against the independent model
    import torch

    from ..ops import detect

    win = torch.from_numpy(
        x.reshape(4, N).astype(np.complex64)).to(device)
    res = detect.dechirp_detect(win)
    value = res.value.cpu().tolist()
    print(f"4. lora_tpu_torch detector on the numpy waveform -> {value}")
    if value != symbols:
        raise AssertionError(f"detector {value} != model {symbols}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 1, figsize=(10, 8))
        axes[0].plot(x.real[: 2 * N])
        axes[0].set_title("baseband (real), two symbols")
        inst_f = np.angle(x[1:] * np.conj(x[:-1])) / (2 * np.pi)
        axes[1].plot(inst_f)
        axes[1].set_title("instantaneous frequency: shifted sawtooth per symbol")
        f0 = (np.arange(N) % N) / N - 0.5
        down = np.exp(-2j * np.pi * np.cumsum(f0))
        spec = np.abs(np.fft.fft(x[N : 2 * N] * down))
        axes[2].plot(spec)
        axes[2].set_title(f"dechirped FFT: peak at bin {np.argmax(spec)}")
        fig.tight_layout()
        out = out_path(args.out)
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
