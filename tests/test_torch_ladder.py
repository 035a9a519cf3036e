"""What judges a run, in the port against the JAX package: the
config-against-config arena, the Elo ladder, the net-free anchors and the
``ladder`` command; and the loop and the arena under the search variants.

``play_config_match`` is held ply by ply with the deterministic fake net of
tests/test_mcts.py: the port's own function plays the match, every
half-batch search it makes is recorded before the pick (the two packages
break argmax ties with different generators), and the JAX searches of the
same configurations on the same states must give equal ``action_probs``.
The ladder's fit is held to JAX's on fixed match results (1e-9), the
``uniform`` and ``material`` anchors to JAX's on the same planes (1e-6).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.search.mcts import MCTS as JaxMCTS
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig as JaxConfig
from alphazeroforhnefatafl_tpu.train import anchors as janchors
from alphazeroforhnefatafl_tpu.train import arena as jarena
from alphazeroforhnefatafl_tpu_torch import cli
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTS, MCTSConfig
from alphazeroforhnefatafl_tpu_torch.train import anchors as tanchors
from alphazeroforhnefatafl_tpu_torch.train import arena as tarena
from alphazeroforhnefatafl_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_mcts import make_fake_evaluate
from tests.test_torch_env import STATE_FIELDS, assert_same, jax_fns, to_jax
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_loop import assert_same_tree, run, tiny_config
from tests.test_torch_mcts import playout_positions, torch_fake_evaluate


@pytest.fixture(scope="module")
def env():
    return tenv.make_env("brandubh", "cpu")


# --------------------------- play_config_match ---------------------------


def test_config_match_agrees_with_jax_ply_by_ply(env, monkeypatch):
    """Candidate: two leaves a wave; incumbent: the serial search; one net."""
    jax_env = jenv.make_env("brandubh")
    B, plies = 4, 8
    base = dict(num_simulations=16, max_children=16, dirichlet_eps=0.0, max_depth=16)
    cfg_c, cfg_i = dict(base, leaves_per_wave=2), dict(base)

    plies_seen = []  # per ply: [(config, states, legal, action_probs), ...] in batch order

    def recording_pick(mcts, result, legal, generator):
        plies_seen[-1].append((mcts.config, legal.clone(), result.action_probs.clone()))
        return result.action_probs.argmax(-1).to(torch.int32)

    real_mask = env.legal_mask_many
    halves = []

    def recording_mask(states):
        if states.batch_size == B // 2:
            if not plies_seen or len(plies_seen[-1]) == 2:
                plies_seen.append([])
                halves.append([])
            halves[-1].append(states)
        return real_mask(states)

    monkeypatch.setattr(tarena, "_pick_actions", recording_pick)
    # Through the instance's dict: undone, it leaves no attribute on the
    # env, which make_env shares with every later test.
    monkeypatch.setitem(vars(env), "legal_mask_many", recording_mask)
    fake = torch_fake_evaluate(env)
    res = tarena.play_config_match(env, fake, fake, MCTSConfig(**cfg_c), MCTSConfig(**cfg_i),
                                   num_games=B, max_game_len=plies)
    monkeypatch.undo()
    assert (res.games, res.truncated) == (B, B) and len(plies_seen) == plies

    jfake = make_fake_evaluate(jax_env)
    jsearch = {}
    for name, cfg in (("c", cfg_c), ("i", cfg_i)):
        jm = JaxMCTS(jax_env, jfake, JaxConfig(**cfg))
        jsearch[name] = jax.jit(lambda s, l, jm=jm: jm.search(
            None, s, l, jax.random.PRNGKey(0), add_noise=False).action_probs)
    jstep, jmask, _ = jax_fns(jax_env)

    jstates = jax_env.reset_batch(B)
    differed = False
    for ply, (seen, states) in enumerate(zip(plies_seen, halves)):
        side = (int(env.rules.starting_side) + ply) % 2
        # The candidate owns the first half exactly when the attacker moves.
        owners = ("c", "i") if side == 0 else ("i", "c")
        actions = []
        for k, (owner, (config, legal, probs)) in enumerate(zip(owners, seen)):
            assert config.leaves_per_wave == (2 if owner == "c" else 1), f"ply {ply} half {k}"
            part = slice(0, B // 2) if k == 0 else slice(B // 2, None)
            jhalf = jax.tree_util.tree_map(lambda x: x[part], jstates)
            assert_same(jhalf, states[k], STATE_FIELDS, f"ply {ply} half {k}")
            jlegal = jmask(jhalf.board, jhalf.side_to_play) & ~jhalf.terminated[:, None]
            np.testing.assert_array_equal(legal.numpy(), np.asarray(jlegal))
            want = jsearch[owner](jhalf, jlegal)
            np.testing.assert_array_equal(probs.numpy(), np.asarray(want), err_msg=f"ply {ply} half {k}")
            other = jsearch["i" if owner == "c" else "c"](jhalf, jlegal)
            differed |= not np.array_equal(np.asarray(other), np.asarray(want))
            actions.append(probs.argmax(-1))
        jstates, _ = jstep(jstates, jnp.asarray(torch.cat(actions).numpy().astype(np.int32)))
    assert differed  # the two configurations do search differently


def test_config_match_counts_and_odd_batch(env):
    fake = torch_fake_evaluate(env)
    small = dict(num_simulations=4, max_children=8, dirichlet_eps=0.0, max_depth=8)
    res = tarena.play_config_match(
        env, fake, fake, MCTSConfig(leaves_per_wave=2, **small),
        MCTSConfig(root_selection="gumbel", **small), num_games=4, max_game_len=4)
    assert (res.games, res.truncated, res.score) == (4, 4, 0.5)
    with pytest.raises(ValueError, match="even"):
        tarena.play_config_match(env, fake, fake, MCTSConfig(**small), MCTSConfig(**small), num_games=3)


def test_play_match_plays_the_halving_winner_under_gumbel(env, monkeypatch):
    picked = []
    real_search = MCTS.search

    def recording_search(self, *args, **kw):
        result = real_search(self, *args, **kw)
        picked.append(result.best_action.clone())
        return result

    def no_sampling(*args, **kw):
        raise AssertionError("select_actions was called under gumbel")

    stepped = []
    real_step = env.step_many

    def recording_step(states, actions):
        if states.batch_size == 4 and len(stepped) < len(picked):
            stepped.append(actions.clone())
        return real_step(states, actions)

    monkeypatch.setattr(MCTS, "search", recording_search)
    monkeypatch.setattr(tarena, "select_actions", no_sampling)
    monkeypatch.setitem(vars(env), "step_many", recording_step)
    fake = torch_fake_evaluate(env)
    cfg = MCTSConfig(num_simulations=4, max_children=8, max_depth=8, root_selection="gumbel")
    res = tarena.play_match(env, fake, fake, cfg, num_games=4, max_game_len=3)
    assert res.truncated == 4 and len(picked) == 3
    # The root moves are the steps made with a full batch right after a search.
    assert all(torch.equal(a, b) for a, b in zip(picked, stepped))


# --------------------------- ladder ---------------------------

FIXED = [  # candidate_wins, incumbent_wins, draws, truncated of the three matches
    (9, 3, 2, 2), (12, 1, 3, 0), (5, 5, 0, 6),
]


def test_ladder_fit_matches_jax_on_fixed_results(env, monkeypatch):
    def fixed_match(module):
        calls = []

        def play_match(*args, **kw):
            cw, iw, d, t = FIXED[len(calls)]
            calls.append((args, kw))
            return module.ArenaResult(games=16, candidate_wins=cw, incumbent_wins=iw, draws=d, truncated=t)

        monkeypatch.setattr(module, "play_match", play_match)
        return calls

    jcalls, tcalls = fixed_match(jarena), fixed_match(tarena)
    names = ["init", "iter0", "iter1"]
    want_r, want_w, want_g = jarena.ladder(
        jenv.make_env("brandubh"), None, [(n, i) for i, n in enumerate(names)], JaxConfig(),
        games_per_pair=16)
    evs = [(n, object()) for n in names]
    got_r, got_w, got_g = tarena.ladder(env, evs, MCTSConfig(), games_per_pair=16)

    assert list(got_r) == list(want_r) == names and got_r["init"] == 0.0
    for n in names:
        assert got_r[n] == pytest.approx(want_r[n], abs=1e-9)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_g, want_g)
    assert got_r["iter1"] < got_r["iter0"] < 0  # as the fixed results rank them
    # Every unordered pair once, first entry as the candidate.
    assert len(tcalls) == len(jcalls) == 3
    pairs = [(args[1], args[2]) for args, _ in tcalls]
    assert pairs == [(evs[0][1], evs[1][1]), (evs[0][1], evs[2][1]), (evs[1][1], evs[2][1])]
    assert all(kw["num_games"] == 16 for _, kw in tcalls)


def test_ladder_over_a_net_and_two_anchors(env):
    entries = [("fake", torch_fake_evaluate(env))] + [
        (name, tanchors.make_anchored_evaluate(env, tanchors.ANCHOR_CODES[name]))
        for name in ("uniform", "random")]
    cfg = MCTSConfig(num_simulations=4, max_children=8, dirichlet_eps=0.0, max_depth=8)
    ratings, wins, games = tarena.ladder(env, entries, cfg, games_per_pair=4, max_game_len=12,
                                         generator=torch.Generator().manual_seed(0))
    assert list(ratings) == ["fake", "uniform", "random"] and ratings["fake"] == 0.0
    assert all(np.isfinite(v) for v in ratings.values())
    np.testing.assert_array_equal(games, 4 * (1 - np.eye(3)))
    np.testing.assert_array_equal(wins + wins.T, games)


# --------------------------- anchors ---------------------------


def test_anchor_codes_match_jax():
    assert tanchors.ANCHOR_CODES == janchors.ANCHOR_CODES
    for name in ("ANCHOR_NET", "ANCHOR_UNIFORM", "ANCHOR_MATERIAL", "ANCHOR_RANDOM"):
        assert getattr(tanchors, name) == getattr(janchors, name)


@pytest.mark.parametrize("preset", ["brandubh", "copenhagen"])
@pytest.mark.parametrize("name", ["uniform", "material"])
def test_anchor_matches_jax(preset, name):
    torch_env, jax_env = tenv.make_env(preset, "cpu"), jenv.make_env(preset)
    states = playout_positions(torch_env, plies=(0, 7, 16, 31))
    # Material must differ between the positions: take some pieces off.
    board = states.board.clone()
    board[1][board[1] == 1] = 0
    board[2, :3][board[2, :3] == 2] = 0
    obs = torch_env.observe(states.replace(board=board))
    code = tanchors.ANCHOR_CODES[name]

    A = jax_env.num_actions
    jev = janchors.make_anchored_evaluate(
        lambda p, o: (jnp.ones((o.shape[0], A)), jnp.ones((o.shape[0],))), jax_env)
    want_l, want_v = jev(janchors.anchor_params(None, code), jnp.asarray(obs.numpy()))
    got_l, got_v = tanchors.make_anchored_evaluate(torch_env, code)(obs)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-6)
    assert got_l.shape == (4, A) and not got_l.any()
    if name == "material":
        assert len(set(got_v.tolist())) > 1 and float(got_v.abs().max()) < 1.0
    else:
        assert not got_v.any()


def test_net_anchor_is_the_net_and_bad_codes_raise(env):
    fake = torch_fake_evaluate(env)
    assert tanchors.make_anchored_evaluate(env, tanchors.ANCHOR_NET, fake) is fake
    with pytest.raises(ValueError, match="needs a net"):
        tanchors.make_anchored_evaluate(env, tanchors.ANCHOR_NET)
    with pytest.raises(ValueError, match="unknown anchor"):
        tanchors.make_anchored_evaluate(env, 7)


def test_random_anchor_is_a_deterministic_function_of_the_position(env):
    ev = tanchors.make_anchored_evaluate(env, tanchors.ANCHOR_RANDOM)
    obs = env.observe(playout_positions(env, plies=(0, 3, 9)))
    obs = torch.cat([obs, obs[1:2]])  # 1 and 3 are one position
    logits, value = ev(obs)
    assert not value.any() and logits.dtype == torch.float32
    assert float(logits.min()) >= 0.0 and float(logits.max()) < 1e4
    assert torch.equal(logits[1], logits[3])
    assert not torch.equal(logits[0], logits[1]) and not torch.equal(logits[1], logits[2])
    again, _ = ev(obs.flip(0))
    assert torch.equal(again.flip(0), logits)  # whatever the batch around it
    # Spread like uniform draws, per position.
    assert 0.45e4 < float(logits.mean()) < 0.55e4 and float(logits[0].std()) > 0.25e4
    # The hash is an exact integer: three times the JAX package's weighted sum.
    h = tanchors.position_hash(obs)
    flat = obs.reshape(4, -1).double()
    want = (flat * torch.arange(1, flat.shape[1] + 1).double()).sum(-1) * 3
    assert h.dtype == torch.int64 and torch.equal(h, want.round().long())


def test_search_plays_the_random_anchors_masked_argmax(env):
    ev = tanchors.make_anchored_evaluate(env, tanchors.ANCHOR_RANDOM)
    states = playout_positions(env, plies=(0, 4, 9))
    legal = env.legal_mask_many(states)
    cfg = MCTSConfig(num_simulations=16, max_children=16, dirichlet_eps=0.0, max_depth=8)
    res = MCTS(env, ev, cfg).search(states, legal, add_noise=False)
    want = torch.where(legal, ev(env.observe(states))[0], -1.0).argmax(-1)
    assert torch.equal(res.best_action.long(), want)
    assert legal[torch.arange(3), res.best_action.long()].all()


# --------------------------- the loop and the CLI ---------------------------


@pytest.mark.parametrize("variant", [dict(leaves_per_wave=2), dict(root_selection="gumbel")],
                         ids=["L2", "gumbel"])
def test_loop_runs_checkpoints_and_resumes_under_the_variant(env, tmp_path, variant):
    mcts = MCTSConfig(num_simulations=4, max_children=8, max_depth=8, **variant)
    cfg = tiny_config(tmp_path / "ckpt", 2, mcts=mcts, arena_games=4, arena_sims=2,
                      arena_every=1, arena_max_game_len=4)
    state, lines = run(env, cfg, tmp_path / "m.jsonl")
    assert state.step == 6 and [l["step"] for l in lines] == [0, 1]
    assert lines[-1]["arena/games"] == 4 and np.isfinite(lines[-1]["train/loss"])
    assert CheckpointManager(cfg.checkpoint_dir).all_iterations() == [0, 1]

    # A second call with nothing left to do restores the same state.
    again, _ = run(env, cfg, tmp_path / "m2.jsonl")
    assert_same_tree(state.state_dict(), again.state_dict(), "train_state")
    # One more iteration resumes at 2.
    state3, lines3 = run(env, dataclasses.replace(cfg, iterations=3), tmp_path / "m3.jsonl")
    assert [l for l in lines3 if "resume/iteration" in l][0]["resume/iteration"] == 2.0
    assert state3.step == 9 and CheckpointManager(cfg.checkpoint_dir).latest_iteration() == 2


def test_cli_ladder_on_cpu(capsys, tmp_path):
    net = ["--preset", "brandubh", "--channels", "8", "--blocks", "1"]
    ckpt = str(tmp_path / "c")
    assert not cli.main(["train", *net, "--cpu", "--iterations", "2", "--games", "2",
                         "--train-steps", "2", "--batch", "8", "--min-replay", "8", "--sims", "2",
                         "--selfplay-batch", "2", "--checkpoint-dir", ckpt])
    capsys.readouterr()
    assert CheckpointManager(ckpt).all_iterations() == [0, 1]
    assert not cli.main(["ladder", *net, "--cpu", "--ckpt", ckpt, "--games", "2", "--sims", "2"])
    ratings = json.loads(capsys.readouterr().out)["ratings"]
    assert list(ratings) == ["init", "iter0", "iter1"] and ratings["init"] == 0.0
    assert all(np.isfinite(v) for v in ratings.values())


def test_cli_ladder_flags_match_the_jax_cli(monkeypatch):
    import argparse

    from alphazeroforhnefatafl_tpu import cli as jcli

    def ladder_defaults(module):
        seen = {}

        def grab(self, argv=None):
            seen["args"] = argparse.ArgumentParser.parse_known_args(self, argv)[0]
            raise KeyboardInterrupt  # stop before the command runs

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(KeyboardInterrupt):
            module.main(["ladder", "--ckpt", "x"])
        monkeypatch.undo()
        d = vars(seen["args"])
        d.pop("fn"), d.pop("cmd")
        return d

    want, got = ladder_defaults(jcli), ladder_defaults(cli)
    assert got.pop("device") == "cuda"
    assert got.pop("se_ratio") == 0  # the SE net's ratio: the JAX CLI has no such net
    assert got == want


def test_cli_ladder_defaults_to_the_card_and_raises_without_one(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["ladder", "--ckpt", str(tmp_path)])
