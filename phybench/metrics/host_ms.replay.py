"""Host milliseconds per call inside the captured programs' replays: the
summed length of the window's `lora.program:<fn>` spans (a program's call
on the card: its look-up, copies in, graph launch and output clones) that
hold no `lora.program.capture` span, over the calls, a call being a
`lora.decode` span.  None for a program without those spans."""

PROGRAM = "lora.program:"
CAPTURE = "lora.program.capture"
CALL = "lora.decode"


def read(ctx):
    tr = ctx.trace
    calls = tr.spans(CALL)
    caps = tr.spans(CAPTURE)

    def captured(p):
        a, b = float(p["ts"]), float(p["ts"]) + float(p["dur"])
        return any(c.get("tid") == p.get("tid") and a <= float(c["ts"]) <= b
                   for c in caps)

    replays = [e for e in tr.events if e.get("cat") == "user_annotation"
               and str(e.get("name", "")).startswith(PROGRAM)
               and tr.t0 <= float(e["ts"]) <= tr.t1 and not captured(e)]
    if not calls or not replays:
        return None
    return 1e-3 * sum(float(e["dur"]) for e in replays) / len(calls)
