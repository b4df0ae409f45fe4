"""Device milliseconds per call of the read-back: the copies of a call's
results into the harness's pinned host buffers that the host calls inside
the harness's `phybench.readback` spans launched (matched by correlation
id), over the number of spans.  It is the caller's cost, which no change
to the program removes; it shows what of the call the copies take."""

SPAN = "phybench.readback"


def read(ctx):
    spans = ctx.trace.spans(SPAN)
    ops = ctx.trace.launched_in(spans)
    if not spans or not ops:
        return None
    return 1e3 * ctx.trace.seconds(ops) / len(spans)
