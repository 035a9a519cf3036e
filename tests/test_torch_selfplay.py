"""One self-play move of the port against the JAX actor, and a whole
``play()`` run of the port with a converted net.

The two packages' RNGs cannot agree, so the move runs with root noise off
and temperature 0, and the port's step is fed the JAX move's actions; the
port's own greedy choice must lie in the JAX policy's argmax set.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.models.network import PolicyValueNet as FlaxNet
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig as JaxMCTSConfig
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayActor as JaxActor
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayConfig as JaxSPConfig
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.models.convert import params_from_flax
from alphazeroforhnefatafl_tpu_torch.models.network import make_network
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig, select_actions
from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig
from tests.test_mcts import make_fake_evaluate
from tests.test_torch_env import INFO_FIELDS, STATE_FIELDS, assert_same, to_jax
from tests.test_torch_mcts import playout_positions, torch_fake_evaluate

MCTS_CFG = dict(num_simulations=32, max_children=32, dirichlet_eps=0.0)


@pytest.mark.parametrize("preset", ["brandubh"])
def test_one_move_matches_jax(preset):
    torch_env, jax_env = tenv.make_env(preset, "cpu"), jenv.make_env(preset)
    states = playout_positions(torch_env, plies=(0, 4, 9, 16))
    B = states.batch_size
    jstates = to_jax(states)

    jactor = JaxActor(
        jax_env, make_fake_evaluate(jax_env), JaxMCTSConfig(**MCTS_CFG), JaxSPConfig(batch_size=B)
    )
    temps = jnp.zeros((B,), jnp.float32)
    j_new, j_actions, j_info, j_top_a, j_top_p, j_root_v, _, _ = jactor._move(
        None, jstates, temps, jax.random.PRNGKey(0)
    )
    j_legal = np.asarray(jax.vmap(jax_env.legal_mask)(jstates))

    actor = SelfPlayActor(torch_env, torch_fake_evaluate(torch_env), MCTSConfig(**MCTS_CFG),
                          SelfPlayConfig(batch_size=B))
    gen = torch.Generator().manual_seed(0)
    legal = torch_env.legal_mask_many(states)
    np.testing.assert_array_equal(j_legal, legal.numpy())
    res = actor.mcts.search(states, legal, gen, add_noise=True)  # eps=0: no noise
    top_a, top_p = actor.policy_target(res.action_probs)
    np.testing.assert_array_equal(np.asarray(j_top_a), top_a.numpy())
    np.testing.assert_array_equal(np.asarray(j_top_p), top_p.numpy())
    np.testing.assert_array_equal(np.asarray(j_root_v), res.root_value.numpy())

    # The JAX move's actions through the port's step.
    t_new, t_info = torch_env.step_many(states, torch.from_numpy(np.array(j_actions)))
    assert_same(j_new, t_new, STATE_FIELDS, "stepped state")
    assert_same(j_info, t_info, INFO_FIELDS, "step info")

    # The port's own greedy choice is one of the JAX policy's argmaxes.
    mine = select_actions(res.action_probs, legal, torch.zeros(B), gen).numpy()
    probs = res.action_probs.numpy()
    for b in range(B):
        assert probs[b, mine[b]] == probs[b].max()
        assert mine[b] in np.flatnonzero(probs[b] == probs[b].max())
    _, actions, info, _, _ = actor.move_tail(states, legal, res.action_probs, torch.zeros(B), gen)
    assert not info.invalid.any()
    for b, a in enumerate(actions.tolist()):
        assert probs[b, a] == probs[b].max()


def test_play_fills_replay_with_converted_net():
    env = tenv.make_env("copenhagen", "cpu")
    n = env.n
    fnet = FlaxNet(board_size=n, channels=8, blocks=1, dtype=jnp.float32)
    params = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1, n, n, 6), jnp.float32))
    net = make_network(n, channels=8, blocks=1, dtype=torch.float32)
    net.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    net.eval()

    B, L = 4, 6
    cfg = SelfPlayConfig(batch_size=B, max_game_len=L)
    actor = SelfPlayActor(env, net, MCTSConfig(num_simulations=8, max_children=16), cfg)
    replay = ReplayBuffer(env, 64, cfg.policy_k)
    stats = actor.play(replay, torch.Generator().manual_seed(0), num_games=B)

    assert stats.games == B
    assert stats.attacker_wins + stats.defender_wins + stats.draws == B
    assert replay.size == B * L == stats.positions
    assert np.isin(replay.value[: replay.size], (-1.0, 0.0, 1.0)).all()
    np.testing.assert_allclose(replay.policy_p[: replay.size].sum(1), 1.0, rtol=1e-5)
    assert (replay.policy_idx[: replay.size, 0] >= 0).all()
    d = stats.as_dict()
    assert all(np.isfinite(v) for v in d.values())
    assert actor.moves_played == L


@pytest.mark.parametrize(
    "disable_frac, min_moves, want",
    [
        # Every root value is below -threshold: the attacker resigns on its
        # second move, the third of the game.
        (0.0, 0, dict(resigned=4, defender_wins=4, positions=12, resign_checked=0)),
        # Not before move 4: the defender resigns on its second move.
        (0.0, 4, dict(resigned=4, attacker_wins=4, positions=16, resign_checked=0)),
        # The whole cohort plays on: flagged games reach the length cap as
        # draws, each a resignation false positive.
        (1.0, 0, dict(resigned=0, truncated=4, draws=4, positions=24, resign_checked=4,
                      resign_false_positive=4)),
    ],
)
def test_resignation(disable_frac, min_moves, want):
    env = tenv.make_env("brandubh", "cpu")
    cfg = SelfPlayConfig(batch_size=4, max_game_len=6, resign_threshold=-2.0, resign_consecutive=2,
                         resign_disable_frac=disable_frac, resign_min_moves=min_moves)
    actor = SelfPlayActor(env, torch_fake_evaluate(env), MCTSConfig(num_simulations=4, max_children=8), cfg)
    replay = ReplayBuffer(env, 64, cfg.policy_k)
    stats = actor.play(replay, torch.Generator().manual_seed(0), num_games=4)
    assert stats.games == 4
    for name, value in want.items():
        assert getattr(stats, name) == value, name
    winner = 1 if stats.defender_wins else 0
    value = replay.value[: replay.size]
    if stats.resigned:
        np.testing.assert_array_equal(value, np.where(replay.side[: replay.size] == winner, 1.0, -1.0))
    else:
        assert not value.any()


def test_replay_ring_and_sample_match_jax():
    """Wrap-around eviction, policy rows narrower and wider than ``policy_k``,
    and seeded sampling, against the JAX buffer on the same numpy data."""
    from alphazeroforhnefatafl_tpu.train.replay import ReplayBuffer as JaxReplay

    n, cap, k = 7, 10, 4
    bufs = [ReplayBuffer(tenv.make_env("brandubh", "cpu"), cap, k), JaxReplay(jenv.make_env("brandubh"), cap, k)]
    rng = np.random.RandomState(0)
    for m, width in [(4, 3), (5, 6), (3, 4)]:
        batch = (
            rng.randint(0, 4, size=(m, n, n)).astype(np.int8),
            rng.randint(0, 2, size=m).astype(np.int8),
            rng.randint(0, 3, size=m).astype(np.int8),
            rng.randint(-1, 100, size=(m, width)).astype(np.int32),
            rng.rand(m, width).astype(np.float32),
            rng.choice([-1.0, 0.0, 1.0], size=m).astype(np.float32),
        )
        for buf in bufs:
            buf.add(*batch)
    mine, ref = bufs
    assert (mine.write, mine.size, mine.total_added) == (ref.write, ref.size, ref.total_added) == (2, 10, 12)
    for name in ("board", "side", "reps", "policy_idx", "policy_p", "value"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
        got = getattr(mine.sample(np.random.RandomState(1), 16), name)
        np.testing.assert_array_equal(got, getattr(ref.sample(np.random.RandomState(1), 16), name))


def test_cli_selfplay_on_cpu(capsys):
    from alphazeroforhnefatafl_tpu_torch import cli

    cli.main(["selfplay", "--preset", "brandubh", "--device", "cpu", "--games", "2",
              "--batch", "2", "--sims", "4", "--channels", "8", "--blocks", "1"])
    out = json.loads(capsys.readouterr().out)
    assert out["games"] >= 2 and out["positions"] > 0 and out["device"] == "cpu"


def test_cli_cuda_without_cuda_raises(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["selfplay", "--device", "cuda"])
