"""Summarize a training run's metrics.jsonl: per-phase aggregates and a
compact text table of the learning trajectory.

The port's own copy of the root ``scripts/summarize_run.py`` (it prints the
same bytes on the same log)::

    python -m alphazeroforhnefatafl_tpu_torch.scripts.summarize_run runs/copenhagen_r4 [--every 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="summarize_run")
    p.add_argument("run_dir")
    p.add_argument("--every", type=int, default=5, help="table row stride")
    return p


def main(argv=None) -> int:
    p = build_parser()
    a = p.parse_args(argv)

    path = os.path.join(a.run_dir, "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(l) for l in f if l.strip()]
    rows = [r for r in rows if "selfplay/games" in r]
    if not rows:
        print("no iterations logged")
        return 0

    total_games = sum(r["selfplay/games"] for r in rows)
    total_pos = sum(r["selfplay/positions"] for r in rows)
    wall_h = rows[-1]["t"] / 3600  # time since logger creation, incl. compile
    print(
        f"{len(rows)} iterations | {int(total_games)} games | "
        f"{int(total_pos)} positions | {wall_h:.2f} h wall"
    )
    hdr = (
        f"{'iter':>4} {'loss':>6} {'p_loss':>6} {'v_loss':>6} {'att%':>5} "
        f"{'def%':>5} {'draw%':>5} {'len':>5} {'g/h':>6}"
    )
    print(hdr)
    for r in rows[:: a.every] + ([rows[-1]] if (len(rows) - 1) % a.every else []):
        print(
            f"{r['step']:>4} {r.get('train/loss', float('nan')):>6.3f} "
            f"{r.get('train/policy_loss', float('nan')):>6.3f} "
            f"{r.get('train/value_loss', float('nan')):>6.3f} "
            f"{100 * r['selfplay/attacker_win_rate']:>5.1f} "
            f"{100 * r['selfplay/defender_win_rate']:>5.1f} "
            f"{100 * r['selfplay/draw_rate']:>5.1f} "
            f"{r['selfplay/avg_length']:>5.0f} "
            f"{r['selfplay/games_per_hour']:>6.0f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
