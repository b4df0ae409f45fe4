"""Device milliseconds per call of api.decode, read from the program's own
`lora.decode` spans: the device operations that the host calls inside them
launched (matched by correlation id: the symbols copied into the captured
graph, its kernels, the clones of its outputs), over the spans in the
window.  The program-side twin of stage_ms.decode, which reads the
harness's span around the same call.  None for a program without the
span."""

SPAN = "lora.decode"


def read(ctx):
    spans = ctx.trace.spans(SPAN)
    ops = ctx.trace.launched_in(spans)
    if not spans or not ops:
        return None
    return 1e3 * ctx.trace.seconds(ops) / len(spans)
