"""Kernel R's share of its roofline: the bound of every launch in the
traced window over the profiler's summed device time of the kernel's
launches.  The bound (`bound`): the [rows, T] channels read once and the
[rows, M] resampled channels written once, 8 bytes a complex64 sample, at
3.35 TB/s, or 4 * taps float32 operations an output (a complex-by-real
product and sum a tap) at 67 TFLOP/s, whichever is longer."""

from phybench.device import bound_s

KERNELS = ("lora::resample_kernel",)
C64 = 8  # bytes of a complex64 sample


def bound(rows: int, T: int, M: int, taps: int) -> float:
    """Seconds of kernel R's bound over [rows, T] -> [rows, M]."""
    return bound_s(rows * (T + M) * C64, 4 * taps * rows * M)


def read(ctx):
    ks = ctx.trace.kernels(KERNELS)
    shape = ctx.shapes.get("resample")
    if not ks or shape is None:
        return None
    return 100.0 * bound(*shape) * len(ks) / ctx.trace.seconds(ks)
