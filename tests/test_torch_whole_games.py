"""Whole games: the port's self-play and arena played to the end of every
game, against the JAX package and the port's oracle (Brandubh, the
deterministic fake net of ``tests/test_mcts.py``, root noise off).

The two packages cannot draw the same random numbers, so both break argmax
ties by one fixed table of a number per game and action (``TIE``): each
package's ``select_actions`` is replaced, in its self-play and its arena
module, by the same rule, the most visited legal action with the largest
table entry among them. That rule keeps the games of a batch apart, so they
end at different plies and restart (self-play) or freeze (arena) while the
others play on.

- Whole games against JAX: both actors' ``play()`` with temperature off and
  resignation on for every game, to a cap of 96 plies: the replay arrays
  and the stats are equal, and the games end by a rule and by resignation,
  not at the cap.
- Staggered games in the port: temperature on, so games end at different
  plies and their rows restart; each game's transcript replays through the
  port's oracle to the same positions, replay rows, result and last board
  (``chip_smoke.GameRecorder``, the recorder of ``chip_smoke.py`` phase 19,
  sees the moves).
- Frozen games against JAX: a full-length match between two fake nets ply
  by ply (every state, the result and its counts), and the step of the
  match's terminated states, state and info, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig as JaxMCTSConfig
from alphazeroforhnefatafl_tpu.train import arena as jarena
from alphazeroforhnefatafl_tpu.train import selfplay as jselfplay
from alphazeroforhnefatafl_tpu.train.replay import ReplayBuffer as JaxReplay
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu_torch.train import arena as tarena
from alphazeroforhnefatafl_tpu_torch.train import selfplay as tselfplay
from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
from tests.test_mcts import make_fake_evaluate
from tests.test_torch_env import INFO_FIELDS, STATE_FIELDS, assert_same, jax_fns, to_jax
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_mcts import torch_fake_evaluate

B, CAP = 4, 96
A = 7 * 7 * 4 * 6  # Brandubh's actions
TIE = np.random.RandomState(5).rand(B, A).astype(np.float32)
SEARCH = dict(num_simulations=8, max_children=8, dirichlet_eps=0.0)
REPLAY_FIELDS = ("board", "side", "reps", "policy_idx", "policy_p", "value")


def jax_pick(probs, legal, temperature, rng):
    is_max = (probs >= jnp.max(probs, -1, keepdims=True)) & legal
    return jnp.argmax(is_max * (1.0 + jnp.asarray(TIE)), -1).astype(jnp.int32)


def torch_pick(probs, legal, temperature, generator):
    is_max = (probs >= probs.max(-1, keepdim=True).values) & legal
    return (is_max * (1.0 + torch.from_numpy(TIE))).argmax(-1).to(torch.int32)


def test_whole_games_match_jax(monkeypatch):
    monkeypatch.setattr(jselfplay, "select_actions", jax_pick)
    monkeypatch.setattr(tselfplay, "select_actions", torch_pick)
    sp = dict(batch_size=B, max_game_len=CAP, temp_threshold=0, resign_disable_frac=0.0,
              resign_threshold=0.5, resign_min_moves=40)
    jax_env, torch_env = jenv.make_env("brandubh"), tenv.make_env("brandubh", "cpu")
    jactor = jselfplay.SelfPlayActor(jax_env, make_fake_evaluate(jax_env),
                                     JaxMCTSConfig(**SEARCH), jselfplay.SelfPlayConfig(**sp))
    jreplay = JaxReplay(jax_env, 1024, 128)
    want = jactor.play(None, jreplay, jax.random.PRNGKey(0), 2 * B)
    actor = tselfplay.SelfPlayActor(torch_env, torch_fake_evaluate(torch_env),
                                    MCTSConfig(**SEARCH), tselfplay.SelfPlayConfig(**sp))
    replay = ReplayBuffer(torch_env, 1024, 128)
    got = actor.play(replay, torch.Generator().manual_seed(0), 2 * B)

    assert got.as_dict() == want.as_dict()
    assert (got.games, got.positions) == (want.games, want.positions) == (9, 315)
    for name in REPLAY_FIELDS:
        np.testing.assert_array_equal(getattr(replay, name), getattr(jreplay, name), name)
    assert (replay.write, replay.size, replay.total_added) == (
        jreplay.write, jreplay.size, jreplay.total_added)
    # Ended by a rule and by resignation, none at the cap.
    assert 0 < got.resigned < got.attacker_wins + got.defender_wins and got.truncated == 0


def test_staggered_games_agree_with_the_oracle():
    env = tenv.make_env("brandubh", "cpu")
    cap = 64
    cfg = tselfplay.SelfPlayConfig(batch_size=B, max_game_len=cap, temp_threshold=cap)
    actor = tselfplay.SelfPlayActor(env, torch_fake_evaluate(env),
                                    MCTSConfig(num_simulations=4, max_children=8), cfg)
    replay = ReplayBuffer(env, 1024, cfg.policy_k)
    rec = chip_smoke.GameRecorder()
    with rec.installed():
        stats = actor.play(replay, torch.Generator().manual_seed(3), B + 2)
    games = chip_smoke.selfplay_games(rec, cap)
    assert len(games) == stats.games >= B + 2
    # Games end at different plies, and rows restart while others play on.
    assert len({len(g["actions"]) for g in games}) > 2
    assert len({g["first_move"] for g in games}) > 2
    chip_smoke.check_selfplay_replay(rec, games)
    assert chip_smoke.check_oracle("brandubh", games, "self-play") == stats.positions
    for g, (_, (board, side, reps, _, _, _)) in zip(games, rec.adds):
        ref = chip_smoke.oracle_replay(("brandubh", g["actions"]))
        np.testing.assert_array_equal(board, ref["boards"])
        np.testing.assert_array_equal(side, ref["sides"])
        np.testing.assert_array_equal(reps, ref["reps"])
        np.testing.assert_array_equal(g["last"]["board"], ref["final"]["board"])
        assert (int(g["last"]["result"]), int(g["last"]["reason"])) == (
            ref["final"]["result"], ref["final"]["reason"])


def test_frozen_games_match_jax(monkeypatch):
    """Candidate: the fake net; incumbent: the same with its logits doubled
    and its value halved (as tests/test_torch_arena.py)."""
    monkeypatch.setattr(jarena, "select_actions", jax_pick)
    monkeypatch.setattr(tarena, "select_actions", torch_pick)
    jax_env, torch_env = jenv.make_env("brandubh"), tenv.make_env("brandubh", "cpu")
    jfake = make_fake_evaluate(jax_env)

    def jax_net(scale, obs):  # scale: 0 candidate, 1 incumbent
        logits, value = jfake(None, obs)
        return logits * (1.0 + scale), value * (1.0 - 0.5 * scale)

    jplies = []
    real_move_fn = jarena._match_move_fn

    def recording_move_fn(*args):
        move = real_move_fn(*args)

        def recorded(*margs):
            out = move(*margs)
            jplies.append(out[0])
            return out
        return recorded

    monkeypatch.setattr(jarena, "_match_move_fn", recording_move_fn)
    search = dict(SEARCH, num_simulations=4)
    want = jarena.play_match(jax_env, jax_net, jnp.float32(0.0), jnp.float32(1.0),
                             JaxMCTSConfig(**search), num_games=B, max_game_len=CAP,
                             rng=jax.random.PRNGKey(0))

    tfake = torch_fake_evaluate(torch_env)

    def incumbent(obs):
        logits, value = tfake(obs)
        return logits * 2.0, value * 0.5

    rec = chip_smoke.GameRecorder()
    with rec.installed():
        got = tarena.play_match(torch_env, tfake, incumbent, MCTSConfig(**search),
                                num_games=B, max_game_len=CAP,
                                generator=torch.Generator().manual_seed(0))
    steps = rec.steps["arena"]
    assert len(steps) == len(jplies)
    for ply, (st, jstate) in enumerate(zip(steps, jplies)):
        after = tenv.EnvState(**{f: torch.from_numpy(v) for f, v in st["after"].items()})
        assert_same(jstate, after, STATE_FIELDS, f"ply {ply}")
    for name in ("games", "candidate_wins", "incumbent_wins", "draws", "truncated",
                 "prior_fallback_rate"):
        assert getattr(got, name) == getattr(want, name), name
    # Games ended at different plies, and the ended ones were stepped on.
    games, frozen = chip_smoke.arena_games(rec, CAP)
    assert frozen > 0 and got.truncated < B
    assert len({len(g["actions"]) for g in games}) > 1

    # The step of terminated states: unchanged, info.invalid set, as JAX's.
    last = tenv.EnvState(**{f: torch.from_numpy(v) for f, v in steps[-1]["after"].items()})
    ended = last.terminated.numpy()
    assert ended.any()
    jstep, _, _ = jax_fns(jax_env)
    for seed in range(3):
        actions = np.random.RandomState(seed).randint(0, A, size=B).astype(np.int32)
        jnew, jinfo = jstep(to_jax(last), jnp.asarray(actions))
        new, info = torch_env.step_many(last, torch.from_numpy(actions))
        assert_same(jnew, new, STATE_FIELDS, f"actions {seed} state")
        assert_same(jinfo, info, INFO_FIELDS, f"actions {seed} info")
        assert info.invalid.numpy()[ended].all()
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(getattr(new, f).numpy()[ended],
                                          getattr(last, f).numpy()[ended], f)
