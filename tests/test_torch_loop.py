"""The port's training loop on the CPU: iterate, checkpoint, resume, gate.

Held to what ``tests/test_loop.py`` holds the JAX loop to, at tiny settings
(7x7 Brandubh, 8 channels x 1 block, 4 simulations). Everything compared
across a save and a restore is compared exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.train.arena import ArenaResult as JaxArenaResult
from alphazeroforhnefatafl_tpu_torch import cli
from alphazeroforhnefatafl_tpu_torch.core.env import make_env
from alphazeroforhnefatafl_tpu_torch.models.network import make_network
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu_torch.train import loop as tloop
from alphazeroforhnefatafl_tpu_torch.train.arena import ArenaResult
from alphazeroforhnefatafl_tpu_torch.train.checkpoint import CheckpointManager
from alphazeroforhnefatafl_tpu_torch.train.learner import init_train_state
from alphazeroforhnefatafl_tpu_torch.train.loop import LoopConfig, gate_passes, run_loop
from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayConfig
from alphazeroforhnefatafl_tpu_torch.utils.metrics import MetricsLogger
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)

GATED = dict(arena_games=4, arena_sims=2, arena_every=1, arena_max_game_len=6)


def tiny_config(ckpt_dir, iterations, **changes):
    cfg = LoopConfig(
        preset="brandubh",
        iterations=iterations,
        games_per_iteration=4,
        train_steps_per_iteration=3,
        train_batch_size=16,
        min_replay_size=16,
        replay_capacity=500,
        channels=8,
        blocks=1,
        arena_games=0,
        seed=3,
        checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
        mcts=MCTSConfig(num_simulations=4, max_children=8, max_depth=8),
        selfplay=SelfPlayConfig(batch_size=4, temp_threshold=4, max_game_len=10, policy_k=8),
    )
    return dataclasses.replace(cfg, **changes)


def new_replay(env, cfg):
    return ReplayBuffer(env, cfg.replay_capacity, cfg.selfplay.policy_k)


def run(env, cfg, path, replay=None):
    """Run the loop; returns (train state, the metrics lines it logged)."""
    log = MetricsLogger(jsonl_path=str(path))
    state = run_loop(env, cfg, log=log, replay=replay)
    log.close()
    return state, [json.loads(line) for line in open(path)]


def fresh_state(env, cfg, seed=99, **net_args):
    args = dict(channels=cfg.channels, blocks=cfg.blocks, norm=cfg.norm)
    args.update(net_args)
    return init_train_state(make_network(env.n, **args), torch.Generator().manual_seed(seed),
                            "cpu")


def assert_same_tree(a, b, ctx=""):
    """Nested dicts/lists of tensors and plain values, exactly equal."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a.cpu(), b.cpu()), ctx
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), ctx
        for k in a:
            assert_same_tree(a[k], b[k], f"{ctx}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{ctx}/{i}")
    else:
        assert a == b, ctx


@pytest.fixture(scope="module")
def env():
    return make_env("brandubh", "cpu")


@pytest.fixture(scope="module")
def gated_run(env, tmp_path_factory):
    """Two gated iterations whose gate can never pass, so the incumbent
    stays what the net was initialized to."""
    d = tmp_path_factory.mktemp("gated")
    cfg = tiny_config(d / "ckpt", 2, gate_threshold=2.0, **GATED)
    replay = new_replay(env, cfg)
    state, lines = run(env, cfg, d / "m.jsonl", replay)
    return dict(dir=d, cfg=cfg, replay=replay, state=state, lines=lines)


def test_loop_runs_and_checkpoints(gated_run):
    cfg, state, lines = gated_run["cfg"], gated_run["state"], gated_run["lines"]
    assert len(lines) == 2 and [l["step"] for l in lines] == [0, 1]
    assert state.step == 6  # 2 iterations x 3 steps
    for key in ("selfplay/games", "selfplay/games_per_hour", "selfplay/prior_fallback_rate",
                "train/loss", "train/policy_loss", "train/value_loss", "train/value_mean",
                "train/grad_norm", "arena/games", "arena/truncated", "arena/decisive_score",
                "arena/elo_delta", "arena/promoted", "time/selfplay_s", "time/train_s",
                "replay/size"):
        assert key in lines[-1], key
    assert lines[0]["selfplay/games"] >= 4 and lines[-1]["arena/games"] == 4
    assert lines[-1]["arena/promoted"] == 0.0
    assert "arena/gate_wilson_lb" not in lines[-1]  # the score gate logs no bound
    mgr = CheckpointManager(cfg.checkpoint_dir)
    assert mgr.all_iterations() == [0, 1] and mgr.latest_iteration() == 1
    assert mgr.saved_extra_keys() == ("incumbent_params",)


def test_resume_restores_everything_exactly(env, gated_run, tmp_path):
    cfg, state, replay = gated_run["cfg"], gated_run["state"], gated_run["replay"]
    # Nothing left to do at iterations=2: the call restores and returns.
    replay2 = new_replay(env, cfg)
    state2, lines = run(env, cfg, tmp_path / "m2.jsonl", replay2)
    assert lines == [] or "selfplay/games" not in lines[-1]
    assert state2 is not state and state2.step == state.step == 6
    assert_same_tree(state.state_dict(), state2.state_dict(), "train_state")
    moments = state2.optimizer.state_dict()["state"]
    assert moments and all(float(m["exp_avg_sq"].sum()) > 0 for m in moments.values())
    assert state2.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"] > 0
    for name in ("board", "side", "reps", "policy_idx", "policy_p", "value"):
        np.testing.assert_array_equal(getattr(replay2, name), getattr(replay, name), err_msg=name)
    assert (replay2.write, replay2.size, replay2.total_added) == (
        replay.write, replay.size, replay.total_added)
    assert replay.size >= 16

    # The incumbent on disk is the initialization, not the trained net.
    mgr = CheckpointManager(cfg.checkpoint_dir)
    _, _, rng_state, extra = mgr.restore(fresh_state(env, cfg), None)
    incumbent = extra["incumbent_params"]
    init = fresh_state(env, cfg, seed=cfg.seed).net  # as run_loop initializes
    assert_same_tree(incumbent, dict(init.state_dict()), "incumbent")
    trained = state.net.state_dict()
    assert any(not torch.equal(incumbent[k], trained[k]) for k in trained)
    assert rng_state.dtype == torch.uint8


def test_resume_continues_at_the_next_iteration(env, gated_run, tmp_path):
    """A copy of the run's checkpoints resumes at iteration 2, trains on,
    and still carries the incumbent it was saved with."""
    import shutil

    cfg = gated_run["cfg"]
    ckpt = tmp_path / "ckpt"
    shutil.copytree(cfg.checkpoint_dir, ckpt)
    before = CheckpointManager(str(ckpt)).restore(fresh_state(env, cfg), None)[3]["incumbent_params"]
    cfg3 = dataclasses.replace(cfg, iterations=3, checkpoint_dir=str(ckpt))
    state3, lines = run(env, cfg3, tmp_path / "m3.jsonl")
    assert [l for l in lines if "resume/iteration" in l][0]["resume/iteration"] == 2.0
    assert not any("resume/incumbent_missing" in l for l in lines)
    resumed = [l for l in lines if "selfplay/games" in l]
    assert len(resumed) == 1 and resumed[0]["step"] == 2
    assert state3.step == 9 and resumed[0]["replay/size"] > gated_run["replay"].size
    mgr = CheckpointManager(str(ckpt))
    assert mgr.latest_iteration() == 2
    after = mgr.restore(fresh_state(env, cfg), None)[3]["incumbent_params"]
    assert_same_tree(before, after, "incumbent across the resume")


def test_promotion_copies_the_net_and_does_not_alias_it(env, tmp_path):
    # A gate that always passes: after each arena the incumbent equals the
    # net as it was then; the second iteration's training must not move it.
    cfg = tiny_config(tmp_path / "ckpt", 1, gate_on="score", gate_threshold=0.0, **GATED)
    state, lines = run(env, cfg, tmp_path / "m.jsonl")
    assert lines[-1]["arena/promoted"] == 1.0
    mgr = CheckpointManager(cfg.checkpoint_dir)
    promoted = mgr.restore(fresh_state(env, cfg), None)[3]["incumbent_params"]
    assert_same_tree(promoted, dict(state.net.state_dict()), "promoted incumbent")
    # Train on with the arena off for that iteration (every 5th): the
    # incumbent stays, the net moves on.
    cfg2 = dataclasses.replace(cfg, iterations=2, arena_every=5)
    state2, _ = run(env, cfg2, tmp_path / "m2.jsonl")
    kept = mgr.restore(fresh_state(env, cfg), None)[3]["incumbent_params"]
    assert mgr.latest_iteration() == 1
    assert_same_tree(promoted, kept, "incumbent after more training")
    assert any(not torch.equal(kept[k], v) for k, v in state2.net.state_dict().items())


def test_resume_across_gating_toggle(env, tmp_path):
    cfg = tiny_config(tmp_path / "ckpt", 1)
    run(env, cfg, tmp_path / "m.jsonl")  # ungated: extra payload saved empty
    assert CheckpointManager(cfg.checkpoint_dir).saved_extra_keys() == ()
    gated = tiny_config(tmp_path / "ckpt", 2, gate_on="wilson", gate_threshold=0.5, **GATED)
    _, lines = run(env, gated, tmp_path / "mg.jsonl")
    assert any(l.get("resume/incumbent_missing") == 1.0 for l in lines)
    row = [l for l in lines if "arena/games" in l][-1]
    assert "arena/truncated" in row and "arena/decisive_score" in row
    assert row["arena/promoted"] in (0.0, 1.0)
    # The Wilson gate logs its bound beside the decision.
    assert 0.0 <= row["arena/gate_wilson_lb"] < 1.0
    assert row["arena/promoted"] == float(row["arena/gate_wilson_lb"] > 0.5)
    assert CheckpointManager(cfg.checkpoint_dir).saved_extra_keys() == ("incumbent_params",)


@pytest.mark.parametrize("arena, want_incumbent", [(dict(arena_games=4, arena_every=0), False),
                                                   (dict(arena_games=0, arena_every=1), False),
                                                   (GATED, True)])
def test_who_generates_self_play(env, tmp_path, monkeypatch, arena, want_incumbent):
    """Without an arena (``arena_every <= 0`` or ``arena_games == 0``)
    self-play follows the net in training; gated, it follows the incumbent."""
    seen = []

    class Recording(tloop.SelfPlayActor):
        def play(self, *args, **kw):
            seen.append(self.evaluate)
            return super().play(*args, **kw)

    monkeypatch.setattr(tloop, "SelfPlayActor", Recording)
    cfg = tiny_config(None, 2, **arena)
    state, lines = run(env, cfg, tmp_path / "m.jsonl")
    assert state.step > 0 and len(seen) == 2
    assert any("arena/games" in l for l in lines) == want_incumbent
    if want_incumbent:
        assert all(e is not state.net and isinstance(e, torch.nn.Module) for e in seen)
        assert not any(p.requires_grad for p in seen[0].parameters())
    else:
        assert all(e is state.net for e in seen)


def test_params_only_restore(env, gated_run, tmp_path):
    cfg, state = gated_run["cfg"], gated_run["state"]
    mgr = CheckpointManager(cfg.checkpoint_dir)
    base = fresh_state(env, cfg)
    step, restored, rng, extra = mgr.restore(base, None)  # gated checkpoint
    assert step == mgr.latest_iteration() == 1 and restored is base
    assert_same_tree(dict(base.net.state_dict()), dict(state.net.state_dict()), "params")
    assert base.step == 6
    base0 = fresh_state(env, cfg)
    assert mgr.restore(base0, None, iteration=0)[0] == 0 and base0.step == 3

    ungated = tiny_config(tmp_path / "ckpt", 1)
    state_u, _ = run(env, ungated, tmp_path / "m.jsonl")
    base_u = fresh_state(env, ungated)
    _, _, _, extra_u = CheckpointManager(ungated.checkpoint_dir).restore(base_u, None)
    assert extra_u == {}
    assert_same_tree(dict(base_u.net.state_dict()), dict(state_u.net.state_dict()), "params")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(base_u, None)


@pytest.mark.parametrize("other", [dict(channels=16), dict(blocks=2), dict(norm="none")])
def test_restore_into_another_architecture_raises(env, gated_run, other):
    cfg = gated_run["cfg"]
    wrong = fresh_state(env, cfg, **other)
    before = {k: v.clone() for k, v in wrong.net.state_dict().items()}
    with pytest.raises(ValueError, match="different architecture.*--channels/--blocks/--norm"):
        CheckpointManager(cfg.checkpoint_dir).restore(wrong, None)
    assert_same_tree(before, dict(wrong.net.state_dict()), "nothing was loaded")


def test_max_to_keep_prunes_and_files_load_weights_only(env, tmp_path):
    cfg = tiny_config(tmp_path / "ckpt", 3, checkpoint_keep=2, train_steps_per_iteration=1)
    run(env, cfg, tmp_path / "m.jsonl")
    mgr = CheckpointManager(cfg.checkpoint_dir, max_to_keep=2)
    assert mgr.all_iterations() == [1, 2]
    files = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert files == ["ckpt_00000001.pt", "ckpt_00000002.pt"]  # no temporary file left
    payload = torch.load(tmp_path / "ckpt" / files[-1], weights_only=True)
    assert payload["iteration"] == 2
    assert set(payload) == {"iteration", "train_state", "rng", "extra", "replay"}
    assert payload["replay"]["board"].dtype == torch.int8


def test_deadline_stops_and_forces_a_checkpoint(env, tmp_path):
    cfg = tiny_config(tmp_path / "ckpt", 5, checkpoint_every=4)
    log = MetricsLogger(jsonl_path=str(tmp_path / "m.jsonl"))
    run_loop(env, cfg, log=log, deadline=0.0)  # already past
    lines = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert [l for l in lines if "selfplay/games" in l][-1]["step"] == 0
    assert lines[-1].get("stop/deadline_reached") == 1.0
    assert CheckpointManager(cfg.checkpoint_dir).all_iterations() == [0]


RESULTS = [
    dict(games=64, candidate_wins=9, incumbent_wins=3, draws=52),
    dict(games=64, candidate_wins=36, incumbent_wins=12, draws=16),
    dict(games=4, candidate_wins=0, incumbent_wins=0, draws=4),
    dict(games=20, candidate_wins=3, incumbent_wins=1, draws=2, truncated=14),
    dict(games=20, candidate_wins=11, incumbent_wins=9, draws=0),
    dict(games=10, candidate_wins=2, incumbent_wins=1, draws=7),
    dict(games=10, candidate_wins=1, incumbent_wins=6, draws=3),
]


@pytest.mark.parametrize("gate", [
    dict(gate_on="score", gate_threshold=0.55),
    dict(gate_on="score", gate_threshold=0.5),
    dict(gate_on="decisive", gate_threshold=0.55, gate_min_decisive=4),
    dict(gate_on="decisive", gate_threshold=0.6, gate_min_decisive=1),
    dict(gate_on="wilson", gate_threshold=0.5, gate_z=1.0),
    dict(gate_on="wilson", gate_threshold=0.5, gate_z=1.96),
], ids=lambda g: "-".join(str(v) for v in g.values()))
def test_gates_decide_as_the_jax_loop(gate):
    config = dataclasses.replace(LoopConfig(), **gate)
    decisions = []
    for counts in RESULTS:
        r = JaxArenaResult(**counts)
        # The JAX loop's expressions (train/loop.py:311-323).
        if config.gate_on == "decisive":
            want = (r.decisive_score >= config.gate_threshold
                    and r.decisive_games >= config.gate_min_decisive)
        elif config.gate_on == "wilson":
            want = r.decisive_wilson_lb(config.gate_z) > config.gate_threshold
        else:
            want = r.score >= config.gate_threshold
        assert gate_passes(config, ArenaResult(**counts)) == want, counts
        decisions.append(want)
    assert len(set(decisions)) == 2  # the table holds both verdicts for every gate
    with pytest.raises(ValueError, match="unknown gate_on"):
        gate_passes(dataclasses.replace(config, gate_on="elo"), ArenaResult(**RESULTS[0]))


def test_loop_config_has_the_jax_fields_and_defaults():
    from alphazeroforhnefatafl_tpu.train.loop import LoopConfig as JaxLoopConfig

    mine = {f.name: f for f in dataclasses.fields(LoopConfig)}
    for f in dataclasses.fields(JaxLoopConfig):
        assert f.name in mine, f.name
        if f.name in ("mcts", "selfplay"):
            continue
        assert getattr(LoopConfig(), f.name) == getattr(JaxLoopConfig(), f.name), f.name
    # The port's one field more: the SE net's ratio, off by default (the JAX
    # package has no squeeze-excitation net).
    port_only = {"se_ratio": 0}
    assert set(mine) == {f.name for f in dataclasses.fields(JaxLoopConfig)} | set(port_only)
    assert all(getattr(LoopConfig(), k) == v for k, v in port_only.items())
    assert LoopConfig().mcts == MCTSConfig(num_simulations=64)
    assert LoopConfig().selfplay == SelfPlayConfig()


TRAIN_ARGS = ["train", "--preset", "brandubh", "--iterations", "1", "--games", "2",
              "--train-steps", "2", "--batch", "8", "--min-replay", "8", "--sims", "2",
              "--selfplay-batch", "2", "--channels", "8", "--blocks", "1"]


def test_cli_train_on_cpu(capsys, tmp_path):
    assert not cli.main(TRAIN_ARGS + ["--cpu", "--checkpoint-dir", str(tmp_path / "c"),
                                      "--arena-games", "2", "--alpha-scale", "10"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[-1]["step"] == 0 and "selfplay/games" in lines[-1]
    assert CheckpointManager(str(tmp_path / "c")).latest_iteration() == 0


def test_cli_train_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(TRAIN_ARGS)


def test_cli_train_gumbel_is_not_ported_and_says_so(capsys, tmp_path):
    """The name is from when ``--gumbel`` raised ``NotImplementedError``.
    Gumbel root selection is ported: the flag trains and checkpoints."""
    assert not cli.main(TRAIN_ARGS + ["--cpu", "--gumbel", "--checkpoint-dir", str(tmp_path / "c")])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[-1]["step"] == 0 and lines[-1]["selfplay/games"] >= 2
    assert np.isfinite(lines[-1]["train/loss"])
    assert CheckpointManager(str(tmp_path / "c")).latest_iteration() == 0


def test_cli_train_flags_match_the_jax_cli():
    import argparse

    from alphazeroforhnefatafl_tpu import cli as jcli

    def train_defaults(module):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None):
            seen["args"] = real(self, argv)
            raise KeyboardInterrupt  # stop before the command runs

        argparse.ArgumentParser.parse_args = grab
        try:
            module.main(["train"])
        except KeyboardInterrupt:
            pass
        finally:
            argparse.ArgumentParser.parse_args = real
        d = vars(seen["args"])
        d.pop("fn"), d.pop("cmd")
        return d

    want, got = train_defaults(jcli), train_defaults(cli)
    assert got.pop("device") == "cuda"
    assert got.pop("se_ratio") == 0  # the SE net's ratio: the JAX CLI has no such net
    assert got == want
