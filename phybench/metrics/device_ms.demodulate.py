"""Device milliseconds per call of the demodulation: the device operations
that the host calls inside the program's own `lora.demodulate` and
`lora.channelized_demodulate` spans launched (matched by correlation id:
the captured graph's kernels, a bank copied into it, the clones of its
outputs), over the calls, a call being a `lora.decode` span in the window.
None for a program without those spans."""

SPANS = ("lora.demodulate", "lora.channelized_demodulate")
CALL = "lora.decode"


def read(ctx):
    calls = ctx.trace.spans(CALL)
    ops = ctx.trace.launched_in(
        [s for name in SPANS for s in ctx.trace.spans(name)])
    if not calls or not ops:
        return None
    return 1e3 * ctx.trace.seconds(ops) / len(calls)
