"""Kernel A's share of its roofline: the bound of every launch in the
traced window (the bank read once at 3.35 TB/s, phybench/roofline.py) over
the profiler's summed device time of the kernel's launches."""

from phybench import roofline

KERNELS = ("detect_kernel",)


def read(ctx):
    ks = ctx.trace.kernels(KERNELS)
    shape = ctx.shapes.get("detect")
    if not ks or shape is None:
        return None
    return 100.0 * roofline.detect(*shape) * len(ks) / ctx.trace.seconds(ks)
