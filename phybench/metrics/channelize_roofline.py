"""Kernel D's share of its roofline: the bound of every launch in the
traced window (the wideband block read once and the [S, K, M] channels
written once at 3.35 TB/s, phybench/roofline.py) over the profiler's
summed device time of the kernel's launches, whichever of its three routes
ran."""

from phybench import roofline

KERNELS = ("channelize_fft_kernel", "channelize_kernel",
           "channelize_mma_kernel")


def read(ctx):
    ks = ctx.trace.kernels(KERNELS)
    shape = ctx.shapes.get("channelize")
    if not ks or shape is None:
        return None
    return (100.0 * roofline.channelize(*shape) * len(ks)
            / ctx.trace.seconds(ks))
