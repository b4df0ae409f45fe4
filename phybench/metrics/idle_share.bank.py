"""The device's idle share of the traced window of a bank cell: one minus
the union of its kernel, copy and set intervals over the window."""


def read(ctx):
    return ctx.trace.idle_share()
