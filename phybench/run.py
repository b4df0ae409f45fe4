"""Run one cell of the benchmark of lora_tpu_torch on the card it starts on.

    python3 -m phybench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
that decided `correct`, each beside its limit.  Without a CUDA card, or
with fewer than the cell asks for, the run exits non-zero and prints no
result.  See PERF.md for the cells and their metrics.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="phybench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
