"""The readers of the program's own spans (``level_syncs_per_wave``,
``sync_wait_share``, ``traverse_idle_share``): their arithmetic on a
synthetic trace, nothing read from a program without the spans or from a
run without a trace, and a whole ``--trace 1`` run on the CPU that reports
all three."""

import math

import harness
import pytest

from conftest import tiny_cell

SEED = 2**31 + 2020
NEW = ("level_syncs_per_wave.selfplay", "sync_wait_share.selfplay",
       "traverse_idle_share.selfplay")

# Window [0, 100] us. Two waves in it and one after it; three syncs in it.
HOST = [("bench/traced", 0.0, 100.0), ("bench/move", 0.0, 100.0),
        ("mcts/wave", 10.0, 50.0), ("mcts/traverse", 10.0, 30.0),
        ("mcts/level_sync", 20.0, 22.0), ("mcts/level_sync", 28.0, 30.0),
        ("mcts/wave", 60.0, 90.0), ("mcts/traverse", 60.0, 70.0),
        ("mcts/level_sync", 65.0, 66.0),
        ("mcts/wave", 120.0, 130.0), ("mcts/traverse", 120.0, 125.0),
        ("mcts/level_sync", 121.0, 125.0)]
# Busy over [0, 15], [25, 40], [65, 68], [95, 100] of the window.
DEVICE = [("conv_fprop", "kernel", 0.0, 15.0), ("x", "gpu_memcpy", 25.0, 35.0),
          ("y", "kernel", 30.0, 40.0), ("z", "kernel", 65.0, 68.0),
          ("w", "gpu_memset", 95.0, 110.0)]


def _run(host=HOST, device=DEVICE):
    return {"trace": {"window": (0.0, 100.0), "host": list(host), "device": list(device),
                      "kernel_rows": {"step": 0, "mask": 0}}}


@pytest.mark.parametrize("name, want", [
    ("level_syncs_per_wave.selfplay", 3 / 2),
    ("sync_wait_share.selfplay", 100 * (2 + 2 + 1) / (40 + 30)),
    # Idle [15, 25], [40, 65], [68, 95]: 62 us, of which the walks
    # [10, 30] and [60, 70] overlap 10 + 5 + 2.
    ("traverse_idle_share.selfplay", 100 * 17 / 62),
])
def test_span_readers(name, want):
    assert harness.metric_reader(name)(_run()) == pytest.approx(want)


def test_with_no_device_event_the_whole_window_is_idle():
    got = harness.metric_reader("traverse_idle_share.selfplay")(_run(device=[]))
    assert got == pytest.approx(100 * 30 / 100)


def test_a_card_busy_through_the_window_has_no_idle_share():
    busy = [("k", "kernel", -5.0, 105.0)]
    assert harness.metric_reader("traverse_idle_share.selfplay")(_run(device=busy)) is None


@pytest.mark.parametrize("name", NEW)
def test_span_readers_with_nothing_to_read_return_nothing(name):
    read = harness.metric_reader(name)
    # A program without the spans: only the benchmark's own in the trace.
    parent = [h for h in HOST if h[0].startswith("bench/")]
    assert read(_run(host=parent)) is None
    assert read(_run(host=[])) is None
    assert read({"trace": None}) is None
    # A trace with the program's spans outside the window alone.
    assert read(_run(host=[h for h in HOST if h[1] >= 120.0])) is None


def test_a_traced_run_reports_the_span_metrics():
    import run

    r = run.measure(tiny_cell(), SEED, 0.0, True, "cpu", 0.0)
    assert r["correct"]
    for name in NEW:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name
    assert r["metrics"]["level_syncs_per_wave.selfplay"]["value"] >= 2
    assert 0 < r["metrics"]["sync_wait_share.selfplay"]["value"] < 100
    assert r["metrics"]["traverse_idle_share.selfplay"]["value"] <= 100
    # Every span of the move and the search is in the trace (a replay
    # write only where a game ended in the traced moves).
    names = {h[0] for h in r["out"]["run"]["trace"]["host"]}
    assert {"selfplay/move", "selfplay/root_mask", "selfplay/tail", "mcts/search", "mcts/wave",
            "mcts/traverse", "mcts/level_sync", "mcts/leaf_step", "mcts/evaluate",
            "mcts/expand", "mcts/backup"} <= names


def test_an_untraced_run_still_runs():
    import run

    r = run.measure(tiny_cell(), SEED, 0.0, False, "cpu", 0.0)
    assert r["correct"]
    assert not set(NEW) & set(r["metrics"])
    assert r["metrics"]["setup_s"]["value"] >= 0
