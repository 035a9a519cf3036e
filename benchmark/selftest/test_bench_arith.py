"""The benchmark's frozen arithmetic: the union of device intervals, FLOPs
of an evaluation, kernel bytes a row and the per-layer readers."""

import harness
import pytest


def test_union_counts_overlaps_once_and_clips_to_the_window():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (90, 120)]
    assert harness.union_seconds(iv, 0, 100) == pytest.approx(40e-6)
    assert harness.union_seconds(iv, 8, 32) == pytest.approx(14e-6)
    assert harness.union_seconds([], 0, 100) == 0.0


def test_flops_of_the_flagship_evaluation():
    # stem + 12 trunk convs + policy 3x3 + policy 1x1 + value 1x1 + dense.
    assert harness.net_flops_per_eval(11, 6, 64, 6, 128) == 117_801_984.0


def _run(**kw):
    run = {"n": 11, "num_actions": 4840, "peak": harness.peaks("NVIDIA H100 80GB HBM3"),
           "positions": 1000, "evals_per_position": 129, "flops_per_eval": 117_801_984.0,
           "window_s": 2.0, "chips": 1, "waves_per_move": 64,
           "spans": {"move": [(0.0, 1.0), (1.0, 2.5)], "search": [(0.1, 0.9), (1.1, 2.3)]},
           "trace": {"window": (0.0, 1e6),
                     "device": [("_Z16tafl_step_kernelPKa", "kernel", 0.0, 100.0),
                                ("tafl_legal_mask_kernel", "kernel", 200.0, 250.0),
                                ("void conv_fprop", "kernel", 240.0, 400.0)],
                     "kernel_rows": {"step": 1024, "mask": 512}}}
    run.update(kw)
    return run


@pytest.mark.parametrize("name, want", [
    ("step_kernel_roofline.selfplay", 100 * 1024 * 5341 / 3.35e12 / 100e-6),
    ("legal_mask_roofline.selfplay", 100 * 512 * 4965 / 3.35e12 / 50e-6),
    ("mfu.selfplay", 100 * 1000 * 129 * 117_801_984.0 / (2.0 * 989.4e12)),
    ("idle_share.selfplay", 100 * (1 - 300e-6 / 1.0)),
    ("move_overhead_ms.selfplay", 1e3 * ((1.0 - 0.8) + (1.5 - 1.2)) / 2),
    ("search_ms_per_wave.selfplay", 1e3 * 2.0 / (2 * 64)),
    ("positions_per_s.selfplay", 1000 / 2.0),
])
def test_readers(name, want):
    assert harness.metric_reader(name)(_run()) == pytest.approx(want)


def test_kernel_bytes_a_row_are_the_kernel_tables():
    # 5,341 and 4,965 bytes a Copenhagen row (PERF.md's kernel table).
    run = _run()
    got = harness.metric_reader("step_kernel_roofline.selfplay")(run)
    assert got * 3.35e12 * 100e-6 / 100 / 1024 == pytest.approx(5341)
    got = harness.metric_reader("legal_mask_roofline.selfplay")(run)
    assert got * 3.35e12 * 50e-6 / 100 / 512 == pytest.approx(4965)


@pytest.mark.parametrize("name", ["step_kernel_roofline.selfplay", "legal_mask_roofline.selfplay",
                                  "idle_share.selfplay"])
def test_readers_with_nothing_to_read_return_nothing(name):
    empty = _run(trace={"window": (0.0, 1e6), "device": [], "kernel_rows": {"step": 0, "mask": 0}})
    assert harness.metric_reader(name)(empty) is None
    assert harness.metric_reader(name)(_run(trace=None)) is None


def test_no_peak_for_an_unknown_card():
    assert harness.peaks("cpu") is None
    assert harness.metric_reader("mfu.selfplay")(_run(peak=None)) is None


def test_breakdown_labels_gaps_by_the_host_span():
    trace = {"window": (0.0, 100.0),
             "device": [("conv_fprop", "kernel", 0.0, 10.0), ("x", "gpu_memcpy", 60.0, 70.0)],
             "host": [("bench/traced", 0.0, 100.0), ("bench/move", 0.0, 100.0),
                      ("bench/search", 5.0, 50.0)]}
    bd = harness.breakdown(trace)
    assert bd["device_ops"] == [["conv", 10e-6], ["copy/cast/fill", 10e-6]]
    assert bd["idle_gaps"][0] == ["bench/search", 50e-6]
    assert ["bench/move", 30e-6] in bd["idle_gaps"]
