"""Device milliseconds per call of api.decode: the device operations that
the host calls inside the harness's `phybench.decode` spans launched
(matched by correlation id: the captured graph's kernels, the copy of the
symbols into it, the clones of its outputs), over the number of spans."""

SPAN = "phybench.decode"


def read(ctx):
    spans = ctx.trace.spans(SPAN)
    ops = ctx.trace.launched_in(spans)
    if not spans or not ops:
        return None
    return 1e3 * ctx.trace.seconds(ops) / len(spans)
