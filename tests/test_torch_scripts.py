"""The port's run drivers (``alphazeroforhnefatafl_tpu_torch/scripts/``)
against the root ``scripts/`` they port, on the CPU at tiny sizes.

- ``train_run``: the JAX script itself, loaded by path with its
  ``run_loop`` captured, and the port's, on the default flags and on every
  record of the committed runs' ``config.jsonl``: the same loop, search and
  self-play fields, and the same ``config.jsonl`` record;
- the TPU mechanism flags: a notice on stderr, and the config of 0;
- ``summarize_run``: the JAX script's bytes on the committed run, and a run
  the port's own loop logged;
- one chain ``train_run`` -> ``summarize_run`` -> ``eval_run`` (a foreign
  checkpoint planted and skipped; anchors) -> ``cross_ladder`` ->
  ``search_ab`` (brandubh, 8 channels x 1 block, 4 simulations), each
  ladder entry holding its own checkpoint's parameters;
- the pure pieces against the JAX scripts' expressions; ``analyze_trace``
  on a synthetic trace and on ``profile_wave``'s CPU trace; ``bench_mcts``;
  the experiment drivers' command lines against the JAX ones.
"""

import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import re
import shlex
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig as JaxMCTSConfig
from alphazeroforhnefatafl_tpu_torch.models.network import make_network
from alphazeroforhnefatafl_tpu_torch.scripts import (
    analyze_trace,
    bench_mcts,
    cross_ladder,
    eval_run,
    profile_wave,
    search_ab,
    note_tpu_flags,
    summarize_run,
    train_run,
)
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu_torch.train.checkpoint import CheckpointManager
from alphazeroforhnefatafl_tpu_torch.train.learner import init_train_state
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
RUN_RECORDS = [
    json.loads(line)
    for run in ("copenhagen_r4ab_puct", "copenhagen_cfg4_800sim")
    for line in (ROOT / "runs" / run / "config.jsonl").read_text().splitlines()
    if line.strip()
]
#: The JAX SelfPlayConfig's TPU transport knobs, which the port has not.
JAX_ONLY_FIELDS = {"selfplay.search_chunk", "selfplay.scan_moves"}
#: The port's loop fields the JAX loop has not, with the value every JAX
#: record maps to (the JAX package has no squeeze-excitation net).
PORT_ONLY_FIELDS = {"se_ratio": 0}


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def flat_fields(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            out.update(flat_fields(value, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = value
    return out


def captured_loop(monkeypatch, module):
    """Replace ``module.run_loop`` by a stub that records its arguments."""
    seen = {}

    def fake_run_loop(env, cfg, log=None, deadline=None):
        seen.update(env=env, cfg=cfg, deadline=deadline)
        return SimpleNamespace(step=7)

    monkeypatch.setattr(module, "run_loop", fake_run_loop)
    return seen


def run_both_train_runs(monkeypatch, tmp_path, argv):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_mod = load_jax_script("train_run")
    jax_seen = captured_loop(monkeypatch, jax_mod)
    monkeypatch.chdir(jax_dir)
    monkeypatch.setattr(sys, "argv", ["train_run.py", *argv])
    jax_mod.main()
    port_seen = captured_loop(monkeypatch, train_run)
    monkeypatch.chdir(port_dir)
    assert train_run.main([*argv, "--device", "cpu"]) == 0
    return jax_seen, port_seen, jax_dir, port_dir


@pytest.mark.parametrize(
    "rec", [{"name": "defaults"}] + RUN_RECORDS,
    ids=["defaults"] + [f"{r['name']}-{i}" for i, r in enumerate(RUN_RECORDS)],
)
def test_train_run_maps_every_flag_as_the_jax_script(monkeypatch, tmp_path, capsys, rec):
    argv = train_run.record_argv(rec)
    jax_seen, port_seen, jax_dir, port_dir = run_both_train_runs(monkeypatch, tmp_path, argv)
    jax_fields, port_fields = flat_fields(jax_seen["cfg"]), flat_fields(port_seen["cfg"])
    assert JAX_ONLY_FIELDS <= set(jax_fields)
    assert set(jax_fields) - JAX_ONLY_FIELDS == set(port_fields) - set(PORT_ONLY_FIELDS)
    for key, value in port_fields.items():
        assert value == PORT_ONLY_FIELDS.get(key, jax_fields.get(key)), key
    assert (jax_seen["deadline"] is None) == (port_seen["deadline"] is None)
    if port_seen["deadline"] is not None:
        assert abs(port_seen["deadline"] - jax_seen["deadline"]) < 60
    assert port_seen["env"].device.type == "cpu" and port_seen["env"].n == jax_seen["env"].n
    # The run directory is relative to the working directory, and the
    # config record is the JAX one plus the port's device.
    name = rec["name"]
    jax_rec = json.loads((jax_dir / "runs" / name / "config.jsonl").read_text())
    port_rec = json.loads((port_dir / "runs" / name / "config.jsonl").read_text())
    assert port_rec.pop("device") == "cpu"
    assert port_rec == jax_rec
    assert (port_dir / "runs" / name / "metrics.jsonl").exists()
    assert capsys.readouterr().out.splitlines()[-1] == "done: step=7"


def test_train_run_ignores_the_tpu_flags_with_a_notice(monkeypatch, tmp_path, capsys):
    seen = captured_loop(monkeypatch, train_run)
    monkeypatch.chdir(tmp_path)
    base = ["--name", "r", "--preset", "brandubh", "--device", "cpu"]
    train_run.main(base)
    plain = seen["cfg"]
    assert "notice" not in capsys.readouterr().err
    train_run.main(base + ["--search-chunk", "32", "--scan-moves", "8"])
    err = capsys.readouterr().err
    assert "--search-chunk 32 is ignored" in err and "--scan-moves 8 is ignored" in err
    assert seen["cfg"] == plain


@pytest.mark.parametrize("module", [profile_wave, bench_mcts], ids=["profile_wave", "bench_mcts"])
def test_chunk_is_ignored_with_a_notice(capsys, module):
    p = module.build_parser()
    plain, chunked = p.parse_args([]), p.parse_args(["--chunk", "100"])
    assert module.search_config(chunked) == module.search_config(plain)
    note_tpu_flags(p, plain, "chunk")
    assert capsys.readouterr().err == ""
    note_tpu_flags(p, chunked, "chunk")
    assert "--chunk 100 is ignored" in capsys.readouterr().err


@pytest.mark.parametrize(
    "module, argv",
    [
        (train_run, ["--name", "r"]),
        (eval_run, ["--ckpt", "c"]),
        (cross_ladder, []),
        (search_ab, ["--ckpt", "c"]),
        (profile_wave, []),
        (bench_mcts, []),
    ],
    ids=["train_run", "eval_run", "cross_ladder", "search_ab", "profile_wave", "bench_mcts"],
)
def test_drivers_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path, module, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        module.main(argv)
    assert not (tmp_path / "runs").exists()  # nothing written before the check


def jax_summary(monkeypatch, run_dir, *flags):
    jax_mod = load_jax_script("summarize_run")
    monkeypatch.setattr(sys, "argv", ["summarize_run.py", str(run_dir), *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_mod.main()
    return out.getvalue()


def port_summary(run_dir, *flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert summarize_run.main([str(run_dir), *flags]) == 0
    return out.getvalue()


def test_summarize_run_prints_the_jax_bytes_on_the_committed_run(monkeypatch):
    run_dir = ROOT / "runs" / "copenhagen_r4ab_puct"
    want = jax_summary(monkeypatch, run_dir)
    assert want.startswith("249 iterations |")
    assert port_summary(run_dir) == want


# ---------------------------------------------------------------- the chain

TINY_NET = ["--channels", "8", "--blocks", "1"]
TINY_MATCH = ["--preset", "brandubh", "--sims", "4", "--children", "8", "--max-game-len", "8",
              *TINY_NET, "--cpu"]


def run_main(module, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert module.main(argv) == 0
    return out.getvalue(), err.getvalue()


def captured_ladder(monkeypatch, module):
    """Wrap ``module.ladder`` so that the entries it is given are kept."""
    seen = {}
    real = module.ladder

    def ladder(env, named, *args, **kw):
        seen["named"] = list(named)
        return real(env, named, *args, **kw)

    monkeypatch.setattr(module, "ladder", ladder)
    return seen


def saved_net(ckpt_dir, it):
    path = Path(ckpt_dir) / f"ckpt_{it:08d}.pt"
    return torch.load(path, map_location="cpu", weights_only=True)["train_state"]["net"]


def same_params(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_the_run_drivers_chain_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out, _ = run_main(train_run, [
        "--name", "tiny", "--preset", "brandubh", "--iterations", "2", "--games", "4",
        "--selfplay-batch", "4", "--max-game-len", "8", "--sims", "4", "--children", "8",
        "--train-steps", "2", "--batch", "16", "--min-replay", "8", "--replay-capacity", "512",
        *TINY_NET, "--arena-games", "4", "--arena-sims", "4", "--arena-max-len", "8",
        "--arena-every", "1", "--checkpoint-every", "1", "--cpu",
    ])
    run_dir = tmp_path / "runs" / "tiny"
    ckpt = run_dir / "ckpt"
    assert out.splitlines()[-1] == "done: step=4"
    assert len((run_dir / "config.jsonl").read_text().splitlines()) == 1
    rows = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    read = ("selfplay/games", "selfplay/positions", "selfplay/attacker_win_rate",
            "selfplay/defender_win_rate", "selfplay/draw_rate", "selfplay/avg_length",
            "selfplay/games_per_hour", "train/loss", "train/policy_loss", "train/value_loss",
            "t", "step")
    assert all(k in r for r in rows for k in read)
    assert CheckpointManager(ckpt).all_iterations() == [0, 1]

    # summarize_run on the port's own log, row stride 1.
    summary = port_summary(run_dir, "--every", "1").splitlines()
    assert summary[0].startswith("2 iterations | ") and summary[1].split()[0] == "iter"
    assert [line.split()[0] for line in summary[2:]] == ["0", "1"]
    assert port_summary(run_dir, "--every", "1") == jax_summary(monkeypatch, run_dir, "--every", "1")

    # eval_run over a copy of the checkpoints with a foreign one planted.
    mixed = tmp_path / "mixed"
    shutil.copytree(ckpt, mixed)
    foreign = init_train_state(make_network(7, channels=16, blocks=1),
                               torch.Generator().manual_seed(1), "cpu")
    CheckpointManager(mixed, max_to_keep=10).save(5, foreign, None, torch.Generator())
    seen = captured_ladder(monkeypatch, eval_run)
    out, err = run_main(eval_run, ["--ckpt", str(mixed), "--games", "2",
                                   "--anchors", "uniform,random", *TINY_MATCH])
    assert "skip step 5: ValueError" in err
    res = json.loads(out)
    names = ["init", "iter000", "iter001", "anchor_uniform", "anchor_random"]
    assert list(res["ratings"]) == names and res["ratings"]["anchor_uniform"] == 0.0
    assert np.array(res["wins"]).shape == (5, 5)
    entries = dict(seen["named"])
    params = {n: entries[n].state_dict() for n in ("init", "iter000", "iter001")}
    # Each entry holds its own checkpoint's parameters (the restore loads in
    # place, so entries that shared one net would all be the last one).
    assert same_params(params["iter000"], saved_net(ckpt, 0))
    assert same_params(params["iter001"], saved_net(ckpt, 1))
    assert not same_params(params["iter000"], params["iter001"])
    assert not same_params(params["init"], params["iter000"])

    # cross_ladder with latest and mid entries, anchors by default.
    seen = captured_ladder(monkeypatch, cross_ladder)
    out, err = run_main(cross_ladder, [
        "--entry", f"last={ckpt}:latest", "--entry", f"middle={ckpt}:mid",
        "--entry", f"first={ckpt}:0", "--games", "2", "--out", "cross.json", *TINY_MATCH,
    ])
    res = json.loads(out)
    assert set(res) == {"ratings", "score_matrix", "games_matrix", "config"}
    assert list(res["ratings"]) == ["init", "last", "middle", "first",
                                    "anchor_uniform", "anchor_random"]
    assert res["ratings"]["init"] == 0.0
    assert all(round(v, 1) == v for v in res["ratings"].values())
    assert np.array(res["games_matrix"]).sum() == 2 * 6 * 5
    assert res["config"] == {"games_per_pair": 2, "sims": 4, "children": 8, "max_game_len": 8}
    assert (tmp_path / "cross.json").read_text() == out
    assert f"loaded last <- {ckpt}:1" in err and f"loaded middle <- {ckpt}:1" in err
    entries = dict(seen["named"])
    for name, it in (("last", 1), ("middle", 1), ("first", 0)):
        assert same_params(entries[name].state_dict(), saved_net(ckpt, it)), name

    # search_ab: one net, two search configs; --out appends.
    for _ in range(2):
        out, err = run_main(search_ab, [
            "--ckpt", str(ckpt), "--games", "2", "--a", "leaves=2,recall=0.9",
            "--b", "leaves=1,recall=0.99", "--out", "ab.jsonl", *TINY_MATCH,
        ])
    res = json.loads(out)
    assert f"loaded {ckpt}:1" in err
    assert {k: res[k] for k in ("a", "b", "sims", "ckpt_step")} == {
        "a": "leaves=2,recall=0.9", "b": "leaves=1,recall=0.99", "sims": 4, "ckpt_step": 1}
    assert res["games"] == 2 and {"score", "elo_delta", "decisive_wilson_lb"} <= set(res)
    assert (tmp_path / "ab.jsonl").read_text().splitlines() == [out.strip()] * 2


# ---------------------------------------------------------------- pure pieces


def test_eval_run_selects_steps_as_the_jax_script():
    for n in range(31):
        steps = list(range(100, 100 + 3 * n, 3))
        for max_steps in range(1, 11):
            want = steps
            if len(steps) > max_steps:  # eval_run.py:67-75
                idx = np.unique(np.round(np.linspace(0, len(steps) - 1, max_steps)).astype(int))
                want = [steps[i] for i in idx]
            assert eval_run.select_steps(steps, max_steps) == want


def jax_entry(spec):
    """cross_ladder.py:70-78's split and check."""
    name, eq, loc = spec.partition("=")
    ckpt_dir, colon, step = loc.rpartition(":")
    if not (eq and colon and name and ckpt_dir and step):
        return None
    return name, ckpt_dir, step


@pytest.mark.parametrize(
    "spec, want",
    [("a=d:3", ("a", "d", "3")), ("a=d:latest", ("a", "d", "latest")),
     ("a=d:mid", ("a", "d", "mid")), ("a=c:/x:7", ("a", "c:/x", "7")),
     ("=d:1", None), ("a=d", None), ("a", None)],
)
def test_cross_ladder_entry_specs(tmp_path, capsys, spec, want):
    assert cross_ladder.parse_entry(spec) == jax_entry(spec) == want
    if want is None:
        with pytest.raises(SystemExit) as e:
            cross_ladder.main(["--entry", spec, "--cpu"])
        assert e.value.code == 2
        assert "expected name=ckpt_dir:step" in capsys.readouterr().err


def test_cross_ladder_resolves_latest_and_mid(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=10)
    state = init_train_state(make_network(7, channels=8, blocks=1),
                             torch.Generator().manual_seed(0), "cpu")
    for it in (2, 5, 9):
        mgr.save(it, state, None, torch.Generator())
    assert [cross_ladder.resolve_step(mgr, s) for s in ("latest", "mid", "5")] == [9, 5, 5]


SPECS_WITH_VLOSS = ["leaves=2,recall=0.9,vloss=0.25", "leaves=1,recall=0.99,vloss=1.0",
                    "vloss=0.5", "leaves=4,vloss=2"]


@pytest.mark.parametrize("spec", SPECS_WITH_VLOSS)
def test_search_ab_parse_cfg_equals_the_jax_one_when_vloss_is_named(spec):
    jax_cfg = load_jax_script("search_ab").parse_cfg(spec, 64, 16)
    port_cfg = search_ab.parse_cfg(spec, 64, 16)
    jax_fields = dataclasses.asdict(jax_cfg)
    for key, value in dataclasses.asdict(port_cfg).items():
        assert value == jax_fields[key], key


def test_search_ab_parse_cfg_differs_from_jax_on_purpose():
    jax_parse = load_jax_script("search_ab").parse_cfg
    # Without vloss the JAX script takes 1.0 (a known fault of the
    # reference); the port keeps MCTSConfig's default, 0.25.
    assert jax_parse("leaves=2", 64, 16).virtual_loss == 1.0
    assert search_ab.parse_cfg("leaves=2", 64, 16).virtual_loss == 0.25 == MCTSConfig().virtual_loss
    # Leftover keys: JAX passes the raw string; the port takes the field's type.
    assert jax_parse("max_depth=16", 64, 16).max_depth == "16"
    cfg = search_ab.parse_cfg("max_depth=16,cpuct=2.5,root_selection=gumbel,"
                              "dirichlet_alpha_scale=10", 64, 16)
    assert (cfg.max_depth, cfg.cpuct, cfg.root_selection, cfg.dirichlet_alpha_scale) == (
        16, 2.5, "gumbel", 10.0)
    assert type(cfg.max_depth) is int and type(cfg.cpuct) is float
    assert search_ab.parse_cfg("dirichlet_alpha_scale=None", 8, 8).dirichlet_alpha_scale is None
    for bad in ("leafs=2", "num_simulations=8", "leaves=2,bogus=1"):
        with pytest.raises(ValueError, match="unknown key"):
            search_ab.parse_cfg(bad, 64, 16)
    assert set(dataclasses.asdict(JaxMCTSConfig())) == set(dataclasses.asdict(MCTSConfig()))


def jax_metric(batch, sims, children, chunk, node_read, unroll, norm, leaves, max_depth, recall):
    """bench_mcts.py:82-88."""
    return (f"mcts_sims_per_s_11x11_b{batch}_s{sims}_k{children}"
            + (f"_c{chunk}" if chunk else "")
            + f"_{node_read}_u{unroll}"
            + (f"_L{leaves}" if leaves > 1 else "")
            + (f"_r{recall}" if recall != 0.99 else "")
            + (f"_d{max_depth}" if max_depth != 64 else "")
            + ("_nf" if norm == "none" else ""))


def test_bench_mcts_prints_the_jax_line_on_the_cpu(capsys):
    cases = [(1024, 128, 128, 0, "auto", 4, "group", 1, 64, 0.99),
             (512, 800, 128, 100, "dot", 2, "none", 4, 32, 0.9)]
    for case in cases:
        assert bench_mcts.metric_name(*case) == jax_metric(*case)
    assert bench_mcts.main(["--batch", "2", "--sims", "4", "--children", "8", "--iters", "2",
                            "--leaves", "2", "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert list(rec) == ["metric", "value", "unit", "compile_s", "best_ms_per_search",
                         "mean_ms_per_search", "iter_ms"]
    assert rec["metric"] == jax_metric(2, 4, 8, 0, "auto", 4, "group", 2, 64, 0.99)
    assert rec["unit"] == "sims/s" and rec["value"] > 0 and len(rec["iter_ms"]) == 2


# ---------------------------------------------------------------- traces


def synthetic_trace():
    """A torch Chrome trace: host ops, a search region, and device events on
    a GPU process's stream tracks."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        {"ph": "M", "name": "thread_name", "pid": 100, "tid": 100, "args": {"name": "thread 100"}},
    ]
    host = [
        {"ph": "X", "cat": "user_annotation", "name": analyze_trace.SEARCH_REGION, "pid": 100,
         "tid": 100, "ts": 1000.0, "dur": 1000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 100, "tid": 100,
         "ts": 1010.0, "dur": 500.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 100, "tid": 100,
         "ts": 1020.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": analyze_trace.SEARCH_REGION, "pid": 0,
         "tid": 7, "ts": 1000.0, "dur": 990.0},
    ]
    dev = [
        ("kernel", "void tafl_step_kernel<11>(StepArgs)", 1100.0, 100.0),
        ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 1150.0, 200.0),
        ("kernel", "void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>(...)", 1400.0, 50.0),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1500.0, 30.0),
        ("gpu_memset", "Memset (Device)", 1600.0, 20.0),
        ("kernel", "void mystery_kernel(int)", 2500.0, 40.0),  # outside the region
    ]
    dev_events = [{"ph": "X", "cat": c, "name": n, "pid": 0, "tid": 7, "ts": ts, "dur": d}
                  for c, n, ts, d in dev]
    return {"schemaVersion": 1, "traceEvents": meta + host + dev_events}


def test_analyze_trace_on_a_synthetic_trace(tmp_path, capsys):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "host_1.pt.trace.json").write_text(json.dumps(synthetic_trace()))
    s = analyze_trace.analyze(synthetic_trace()["traceEvents"], "GPU|stream")
    assert s["device_events"] == 6 and s["off_track_device_events"] == 0
    assert s["families"] == pytest.approx({
        "ported-kernel": 0.1, "conv": 0.2, "layout nchw/nhwc": 0.05,
        "copy/cast/fill": 0.05, "other": 0.04})
    assert s["total_ms"] == pytest.approx(0.44)
    assert s["tracks"] == pytest.approx({"GPU 0/stream 7": 0.44})
    assert s["other"] == pytest.approx({"void mystery_kernel(int)": 0.04})
    # Busy in the region's window [1000, 2000] us: [1100, 1350] is one
    # stretch (the step and the overlapping conv), then 50, 30 and 20 us.
    assert s["window_ms"] == pytest.approx(1.0)
    assert s["busy_ms"] == pytest.approx(0.35)
    assert s["busy_share"] == pytest.approx(0.35)
    assert list(s["ops"])[0].startswith("sm90_xmma_fprop")
    assert analyze_trace.main([str(tmp_path), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "device-track total: 0.4 ms" in out and "== by op family ==" in out
    assert "== top 3 ops ==" in out and "mystery_kernel" in out and "35.0%" in out
    # Host events never count: a regex that matches only the host track
    # finds no device event.
    s = analyze_trace.analyze(synthetic_trace()["traceEvents"], "python3")
    assert s["device_events"] == 0 and s["off_track_device_events"] == 6


def test_analyze_trace_puts_idle_time_down_to_the_innermost_span(tmp_path, capsys):
    # The synthetic search region with the program's spans inside it. Idle
    # in [1000, 2000] us: [1000, 1100] (middle in the level sync), [1350,
    # 1400] (in the evaluation), [1450, 1500] (in the wave alone), [1530,
    # 1600] and [1620, 2000] (after the wave).
    trace = synthetic_trace()
    for name, ts, dur in (("mcts/wave", 1000.0, 500.0), ("mcts/traverse", 1000.0, 120.0),
                          ("mcts/level_sync", 1040.0, 40.0), ("mcts/evaluate", 1340.0, 120.0)):
        trace["traceEvents"].append({"ph": "X", "cat": "user_annotation", "name": name,
                                     "pid": 100, "tid": 100, "ts": ts, "dur": dur})
    s = analyze_trace.analyze(trace["traceEvents"], "GPU|stream")
    assert s["busy_ms"] == pytest.approx(0.35)
    assert list(s["idle_by_span"]) == ["outside any span", "mcts/level_sync", "mcts/evaluate",
                                       "mcts/wave"]
    assert {k: (pytest.approx(ms), n) for k, (ms, n) in s["idle_by_span"].items()} == {
        "outside any span": (0.45, 2), "mcts/level_sync": (0.1, 1), "mcts/evaluate": (0.05, 1),
        "mcts/wave": (0.05, 1)}
    # The idle time by span adds up to the region's idle time.
    assert sum(ms for ms, _ in s["idle_by_span"].values()) == pytest.approx(1.0 - 0.35)
    # Without the program's spans every gap is outside any span.
    bare = analyze_trace.analyze(synthetic_trace()["traceEvents"], "GPU|stream")
    assert list(bare["idle_by_span"]) == ["outside any span"]
    (tmp_path / "host_1.pt.trace.json").write_text(json.dumps(trace))
    assert analyze_trace.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "by innermost host span" in out
    assert re.search(r"0\.100 ms +15\.4% +x1 +mcts/level_sync", out)


@pytest.mark.parametrize(
    "name, fam",
    [
        ("void tafl_step_kernel<11>(StepArgs)", "ported-kernel"),
        ("void tafl_legal_mask_kernel<4>(MaskArgs)", "ported-kernel"),
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x64x64",
         "conv"),
        ("void cudnn::cnn::implicit_convolve_sgemm<float, float, 128, 5, 5>", "conv"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64", "gemm"),
        ("void gemv2T_kernel_val<int, int, float, float, float, 128>", "gemm"),
        ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float>", "layout nchw/nhwc"),
        ("void cudnn::ops::nhwcToNchwKernel<float, float, float, true>", "layout nchw/nhwc"),
        ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>", "groupnorm"),
        ("void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel<float, float>",
         "groupnorm"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)"
         "::GroupNormKernelImplInternal<float, float>(...)::{lambda(float, float, float)#1}>",
         "groupnorm"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::bfloat16_copy_kernel_cuda"
         "(at::TensorIteratorBase&)::{lambda(float)#1}>", "copy/cast/fill"),
        ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(...)>",
         "copy/cast/fill"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>>",
         "copy/cast/fill"),
        ("void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<"
         "at::native::index_kernel_impl<at::native::OpaqueType<4> >(...)>", "gather/index"),
        ("void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<"
         "at::native::index_put_kernel_impl<at::native::OpaqueType<4> >(...)>", "scatter"),
        ("void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::"
         "_cuda_scatter_gather_internal_kernel<true, float>::operator()<at::native::ReduceAdd>>",
         "scatter"),
        ("void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::"
         "_cuda_scatter_gather_internal_kernel<false, float>::operator()<at::native::TensorAssign>>",
         "gather/index"),
        ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, long, unsigned int>",
         "gather/index"),
        ("void cub::DeviceRadixSortOnesweepKernel<cub::DeviceRadixSortPolicy<float, long>>",
         "sort/topk"),
        ("void at::native::radixSortKVInPlace<-2, -1, 32, 4, float, long>", "sort/topk"),
        ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>", "sort/topk"),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
         "at::native::ArgMaxOps<float>, unsigned int, long, 4> >", "reduce"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)"
         "::where_kernel_impl(at::TensorIterator&)::{lambda(bool, float, float)#1}>",
         "where/elementwise"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
         "where/elementwise"),
        ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<"
         "float, 4, at::native::templates::cuda::uniform_and_transform<...>>", "rng"),
        ("void at::native::gamma_cuda_kernel<float>(...)", "rng"),
        ("Memcpy HtoD (Pageable -> Device)", "copy/cast/fill"),
        ("void some_unknown_thing(int)", "other"),
    ],
)
def test_analyze_trace_families(name, fam):
    cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
    assert analyze_trace.family(name, cat) == fam


def test_profile_wave_on_the_cpu_writes_a_trace_analyze_trace_reads(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert profile_wave.main(["--cpu", "--batch", "2", "--sims", "4", "--children", "8",
                              "--chunk", "100", "--trace-dir", str(trace_dir)]) == 0
    captured = capsys.readouterr()
    assert "--chunk 100 is ignored" in captured.err
    lines = captured.out.splitlines()
    assert re.fullmatch(rf"traced one search in [0-9.]+s -> {re.escape(str(trace_dir))}", lines[-2])
    rec = json.loads(lines[-1])
    assert rec["trace"] == analyze_trace.find_trace(str(trace_dir)) and rec["trace_mb"] > 0
    events = analyze_trace.load_events(rec["trace"])
    assert any(e.get("name") == analyze_trace.SEARCH_REGION for e in events)
    assert analyze_trace.main([str(trace_dir)]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("no device events")


# ---------------------------------------------------------------- experiments


def shell_commands(path):
    """The ``python`` command lines of a driver script, continuation lines
    joined and its variables expanded (loop variables by their own name)."""
    text = path.read_text().replace("\\\n", " ")
    env = {name: " ".join(value.split())
           for name, value in re.findall(r'^(\w+)="((?:[^"\\$]|\n)*)"', text, re.M)}
    env.update(HOURS="3.0", NORM="group")
    commands = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("python "):
            continue
        line = re.sub(r'"?\$\{?(\w+)\}?"?', lambda m: env.get(m.group(1), m.group(1)), line)
        commands.append(shlex.split(line.split(">")[0]))
    return commands


DRIVERS = ("norm_ab.sh", "gumbel_wc_ab.sh", "flagship_r4_ab.sh")


@pytest.mark.parametrize("driver", DRIVERS)
def test_experiment_drivers_run_the_jax_command_lines(driver):
    jax_cmds = shell_commands(ROOT / "scripts" / "experiments" / driver)
    port_cmds = shell_commands(ROOT / "alphazeroforhnefatafl_tpu_torch" / "scripts" / "experiments"
                               / driver)
    assert len(port_cmds) == len(jax_cmds) >= 2
    for jax_cmd, port_cmd in zip(jax_cmds, port_cmds):
        assert port_cmd[:2] == ["python", "-m"]
        package, _, name = port_cmd[2].rpartition(".")
        assert package == "alphazeroforhnefatafl_tpu_torch.scripts"
        assert jax_cmd[1] == f"scripts/{name}.py"
        jax_flags = jax_cmd[2:]
        if "--scan-moves" in jax_flags:  # a TPU mechanism, dropped
            i = jax_flags.index("--scan-moves")
            del jax_flags[i:i + 2]
        assert port_cmd[3:] == jax_flags
        module = importlib.import_module(port_cmd[2])
        module.build_parser().parse_args(port_cmd[3:])
