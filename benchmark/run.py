"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
and the window runs under ``torch.profiler``'s device trace for the card's
busy seconds; with ``--trace 1`` its per-layer metrics, from a window run
untraced, read after the window from the
spans, the program's counters and a ``torch.profiler`` trace of a few
moves more. Every run judges what its window produced (``correct``) and
prints each compared number beside its limit, last, on standard error and
under the line's ``checks`` key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Build and kernel caches at fixed paths inside the checkout. The program
# builds its own kernels into its package's ``_kernels/``, also inside it.
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(ctx: dict, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, control: bool = False) -> dict:
    """One run of the cell on ``device``: the runner's outcome and the
    result line's parts (metrics, device, checks, breakdown)."""
    import torch

    out = ctx["runner"].run(ctx, seed, seconds, bool(trace), device, t_start, control=control)
    dev = torch.device(device)
    info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": ctx["cell"]["chips"],
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    run = out["run"]
    run["peak"] = harness.peaks(info["kind"])
    metrics, bd = {}, None
    if trace:
        for m in ctx["per_layer"]:
            value = harness.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = run["trace"]
        lo, hi = t["window"]
        info["busy_s"] = harness.union_seconds([(d[2], d[3]) for d in t["device"]], lo, hi)
        info["window_s"] = (hi - lo) / 1e6
        bd = harness.breakdown(t)
    else:
        for m in ctx["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in out["checks"].values())
    return {"out": out, "correct": correct, "metrics": metrics, "device": info, "breakdown": bd}


def main(argv=None) -> int:
    a = parse(argv)
    ctx = harness.load_cell(a.workload)
    try:
        harness.require_cards(ctx["cell"]["chips"])
    except harness.NoCard as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 2
    r = measure(ctx, a.seed, a.seconds, a.trace, "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; no result", file=sys.stderr)
        return 3
    out = r["out"]
    for note in out["check_extra"]["notes"]:
        print(f"fault: {note}", file=sys.stderr)
    moves_s = [round(e - s, 3) for s, e in out["run"]["spans"]["move"]]
    print(f"move seconds {moves_s}", file=sys.stderr)
    print(f"resignation at the record's threshold would have ended "
          f"{out['resign']['would_resign']} games; {out['resign']['games_ended']} ended in the "
          "run's moves", file=sys.stderr)
    busy = ("not traced" if out["busy_s"] is None else
            f"{out['busy_s']:.4f} s over {out['traced_events']} traced events (step kernels: "
            f"{out['step_kernels'][0]} traced, {out['step_kernels'][1]} launched)")
    print(f"window {out['window_s']:.3f} s, {out['moves']} moves "
          f"({out['positions'] / out['window_s']:.4f} positions/s), card busy {busy}, "
          f"setup {out['setup_s']:.3f} s, check {out['check_s']:.3f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(r["correct"], out["attempted"], out["failed"], r["metrics"],
                              r["device"], out["checks"], r["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
