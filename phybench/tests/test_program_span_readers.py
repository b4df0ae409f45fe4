"""The readers of the program's own spans (device_ms.demodulate,
device_ms.decode, host_ms.replay, idle_share.program) on a synthetic
Chrome trace whose values are counted by hand, and on the same trace
without the program's spans, as a program without them leaves it."""

from __future__ import annotations

import pytest

from phybench import harness
from phybench.trace import Trace

METRICS = ("device_ms.demodulate", "device_ms.decode", "host_ms.replay",
           "idle_share.program")


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _span(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def program_trace() -> list:
    """A window of 1000 us, two calls at t = 0 and 500, each:

    host (tid 1)                          device (tid 7)
    phybench.demodulate  t .. t+60
     lora.demodulate     t+1 .. t+59      detect kernel  t+30 .. t+130
      lora.program:_demod_whole t+5..t+55 clone copy     t+130 .. t+134
       lookup t+6..t+10, launch t+12..t+40 (cudaGraphLaunch, corr c),
       clone_out t+42..t+54 (cudaMemcpyAsync, corr c+3)
    phybench.decode      t+62 .. t+148
     lora.decode         t+65 .. t+145    copy in        t+134 .. t+139
      lora.program:_decode t+66..t+144    graph kernels  t+150 .. t+190
       lookup t+67..t+70, copy_in t+71..t+75 (cudaMemcpyAsync, corr c+1),
       launch t+76..t+140 (cudaGraphLaunch, corr c+2), clone_out
       t+141..t+143

    but the first call's demodulation is a capture: its program holds
    lora.program.capture t+12..t+54 in place of launch and clone_out."""
    ev = [_ev("spin_kernel", "kernel", -50, 10, tid=7),
          _span("phybench.window", 0, 1000)]
    for i, t in enumerate((0, 500)):
        c = 10 * i
        ev += [_span("phybench.demodulate", t, 60),
               _span("lora.demodulate", t + 1, 58),
               _span("lora.program:_demod_whole", t + 5, 50),
               _span("lora.program.lookup", t + 6, 4)]
        if i == 0:
            ev.append(_span("lora.program.capture", t + 12, 42))
        else:
            ev += [_span("lora.program.launch", t + 12, 28),
                   _span("lora.program.clone_out", t + 42, 12)]
        ev += [_ev("cudaGraphLaunch", "cuda_runtime", t + 20, 10, corr=c),
               _ev("cudaMemcpyAsync", "cuda_runtime", t + 45, 3,
                   corr=c + 3),
               _ev("void lora::detect_kernel<10, false>(float2 const*)",
                   "kernel", t + 30, 100, tid=7, corr=c),
               _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t + 130,
                   4, tid=7, corr=c + 3),
               _span("phybench.decode", t + 62, 86),
               _span("lora.decode", t + 65, 80),
               _span("lora.program:_decode", t + 66, 78),
               _span("lora.program.lookup", t + 67, 3),
               _span("lora.program.copy_in", t + 71, 4),
               _ev("cudaMemcpyAsync", "cuda_runtime", t + 72, 2,
                   corr=c + 1),
               _span("lora.program.launch", t + 76, 64),
               _ev("cudaGraphLaunch", "cuda_runtime", t + 78, 60,
                   corr=c + 2),
               _span("lora.program.clone_out", t + 141, 2),
               _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t + 134,
                   5, tid=7, corr=c + 1),
               _ev("void at::native::k1()", "kernel", t + 150, 20, tid=7,
                   corr=c + 2),
               _ev("void at::native::k2()", "kernel", t + 170, 20, tid=7,
                   corr=c + 2)]
    return ev


def _read(metric, events):
    return harness.reader(metric)(harness.Reading(Trace(events), {}))


def test_every_reader_has_its_benchmark_entry():
    bench = {m["name"]: m for m in harness.Cell("sf10-bank-4096").per_layer}
    for m in METRICS:
        assert bench[m]["source"] == "device_trace"
        assert bench[m]["moves"] == "msamples_per_s"


@pytest.mark.parametrize("metric, want", [
    # detect 100 us and the clone 4 us a call
    ("device_ms.demodulate", 0.104),
    # the copy in 5 us and the graph's kernels 20 + 20 us a call
    ("device_ms.decode", 0.045),
    # replays only: _decode 78 us twice and the second _demod_whole 50 us
    ("host_ms.replay", (78 + 78 + 50) * 1e-3 / 2),
    # idle inside lora.demodulate t+1..t+30 (29 us) and inside
    # lora.decode t+139..t+145 (6 us), twice, over 1000 us
    ("idle_share.program", 100 * 2 * (29 + 6) / 1000),
])
def test_a_reader_reads_its_hand_counted_value(metric, want):
    assert _read(metric, program_trace()) == pytest.approx(want)


def test_program_idle_is_a_part_of_the_banks():
    ev = program_trace()
    tr = Trace(ev)
    # busy t+30..t+139 and t+150..t+190 a call: 149 us twice
    assert tr.idle_share() == pytest.approx(100 * (1000 - 298) / 1000)
    assert _read("idle_share.program", ev) < tr.idle_share()
    # the gap under decode's graph launch is named by the program's span
    gaps = dict((round(d * 1e6), name) for name, d in
                tr.breakdown()["idle_gaps"])
    assert gaps[11] == "lora.program.launch"


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_the_spans_reads_none(metric):
    parent = [e for e in program_trace()
              if not e["name"].startswith("lora.")]
    assert _read(metric, parent) is None
