"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] [--seconds S]

For each seed, one run of the cell with the control in the program's place
and a short window (the window always reaches the moves whose search trees
are checked) prints, as one JSON line, each compared number, its limit and
whether the run came out correct. The control is the reference net with
an fp8 trunk (``reference/net.py``) as the search's ``evaluate``; the
program's search, kernels and host loop run as in the cell, and the cell's
own comparison judges the result. The lower end of a limit is the largest
reading of the program's own runs over a dozen seeds or more; the upper
end the smallest of the control's. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench  # noqa: E402  (puts benchmark/ and the root on sys.path)
import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    a = ap.parse_args(argv)
    ctx = harness.load_cell(a.workload)
    harness.require_cards(ctx["cell"]["chips"])
    for seed in a.seeds:
        t0 = time.perf_counter()
        r = bench.measure(ctx, seed, a.seconds, False, "cuda", t0, control=True)
        out = r["out"]
        print(json.dumps({
            "workload": a.workload, "seed": seed, "control": True, "correct": r["correct"],
            "checks": out["checks"], "notes": out["check_extra"]["notes"], "moves": out["moves"],
            "check_s": out["check_s"], "run_s": time.perf_counter() - t0,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
