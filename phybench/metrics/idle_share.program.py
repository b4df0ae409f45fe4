"""The share of the traced window in which the device is idle while the
host is inside one of the program's entry points (`lora.demodulate`,
`lora.channelized_demodulate`, `lora.decode` spans): the window's idle
time that the program's own host path holds, a part of idle_share.bank,
whose device intervals (kernels, copies, sets) it subtracts.  None for a
program without those spans."""

SPANS = ("lora.demodulate", "lora.channelized_demodulate", "lora.decode")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def _overlap(xs, ys):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    tr = ctx.trace
    inside = _union(
        [max(float(e["ts"]), tr.t0),
         min(float(e["ts"]) + float(e["dur"]), tr.t1)]
        for e in tr.events if e.get("cat") == "user_annotation"
        and e.get("name") in SPANS)
    if not inside or tr.idle_share() is None:
        return None
    held = sum(b - a for a, b in inside)
    busy = tr._busy()  # the intervals idle_share.bank merges
    return 100.0 * (held - _overlap(inside, busy)) / (tr.t1 - tr.t0)
