"""The port's arena against the JAX package's.

``ArenaResult`` arithmetic on a table of counts (1e-12); the pair evaluate
with two different converted nets (1e-5: two float32 forwards); and a match
held ply by ply with a deterministic fake net on each side and root noise
off: both packages search the same states, ``action_probs`` agree exactly,
both are advanced with the same actions, and the states agree field for
field to the end. The two packages break argmax ties with different
generators, so the comparison is made before the pick, not after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.search.mcts import MCTS as JaxMCTS
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig as JaxConfig
from alphazeroforhnefatafl_tpu.train import arena as jarena
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig, select_actions
from alphazeroforhnefatafl_tpu_torch.train import arena as tarena
from tests.test_mcts import make_fake_evaluate
from tests.test_torch_env import STATE_FIELDS, assert_same, jax_fns, to_jax
from tests.test_torch_learner import nets, single_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_mcts import torch_fake_evaluate

COUNTS = [
    # games, candidate_wins, incumbent_wins, draws, truncated, fallback rate
    (20, 12, 6, 2, 0, 0.0),
    (10, 5, 5, 0, 0, 0.25),
    (20, 3, 1, 2, 14, 0.0),
    (4, 0, 0, 4, 0, 0.0),  # no decisive game
    (64, 9, 3, 52, 0, 0.5),
    (64, 36, 12, 16, 0, 0.0),
    (8, 8, 0, 0, 0, 0.0),  # the score clamps at 1 - 1e-3 for the Elo
    (8, 0, 8, 0, 0, 0.0),
    (0, 0, 0, 0, 0, 0.0),
    (6, 0, 0, 0, 6, 0.125),
]


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: "-".join(map(str, c[:5])))
def test_arena_result_arithmetic_matches_jax(counts):
    g, cw, iw, d, t, fb = counts
    kw = dict(games=g, candidate_wins=cw, incumbent_wins=iw, draws=d, truncated=t,
              prior_fallback_rate=fb)
    got, want = tarena.ArenaResult(**kw), jarena.ArenaResult(**kw)
    assert got.decisive_games == want.decisive_games
    for name in ("score", "decisive_score", "elo_delta"):
        assert getattr(got, name) == pytest.approx(getattr(want, name), abs=1e-12), name
    for z in (1.0, 1.64, 1.96):
        assert got.decisive_wilson_lb(z) == pytest.approx(want.decisive_wilson_lb(z), abs=1e-12)
    gd, wd = got.as_dict(), want.as_dict()
    assert list(gd) == list(wd)
    for k in wd:
        assert gd[k] == pytest.approx(wd[k], abs=1e-12), k


@pytest.mark.parametrize("i0", [0, 1])
def test_pair_evaluate_matches_jax(i0):
    fnet, params_c, tnet_c = nets(seed=3)
    _, params_i, tnet_i = nets(seed=4)
    obs = np.random.RandomState(i0).rand(6, 7, 7, 6).astype(np.float32)
    stacked = jax.tree_util.tree_map(lambda c, i: jnp.stack([c, i]), params_c, params_i)
    jev = jarena._pair_evaluate(lambda p, o: fnet.apply(p, o))
    want_l, want_v = jev((stacked, jnp.int32(i0)), jnp.asarray(obs))
    with torch.no_grad():
        got_l, got_v = tarena._pair_evaluate(tnet_c, tnet_i)(i0, torch.from_numpy(obs))
        first, second = (tnet_c, tnet_i) if i0 == 0 else (tnet_i, tnet_c)
        assert torch.equal(got_l[:3], first(torch.from_numpy(obs[:3]))[0])
        assert torch.equal(got_l[3:], second(torch.from_numpy(obs[3:]))[0])
        assert not torch.allclose(got_l[:3], second(torch.from_numpy(obs[:3]))[0], atol=1e-3)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5, rtol=1e-5)


def test_match_agrees_with_jax_ply_by_ply():
    """Candidate: the fake net of tests/test_mcts.py. Incumbent: the same
    with its logits doubled and its value halved (exact in float32), so the
    two sides search differently and a swapped half would show."""
    torch_env, jax_env = tenv.make_env("brandubh", "cpu"), jenv.make_env("brandubh")
    B, plies = 4, 10
    cfg = dict(num_simulations=16, max_children=16, dirichlet_eps=0.0, max_depth=16)

    jfake = make_fake_evaluate(jax_env)

    def jax_net(scale, obs):  # scale: 0 candidate, 1 incumbent
        logits, value = jfake(None, obs)
        return logits * (1.0 + scale), value * (1.0 - 0.5 * scale)

    jm = JaxMCTS(jax_env, jarena._pair_evaluate(jax_net), JaxConfig(**cfg))
    jsearch = jax.jit(lambda i0, s, l: jm.search(
        (jnp.asarray([0.0, 1.0]), i0), s, l, jax.random.PRNGKey(0), add_noise=False).action_probs)
    jstep, jmask, _ = jax_fns(jax_env)

    tfake = torch_fake_evaluate(torch_env)

    def incumbent(obs):
        logits, value = tfake(obs)
        return logits * 2.0, value * 0.5

    searches = tarena._match_searches(torch_env, tfake, incumbent, MCTSConfig(**cfg))
    assert searches[0].evaluate.args == (0,) and searches[1].evaluate.args == (1,)

    gen = torch.Generator().manual_seed(0)
    states = torch_env.reset_batch(B)
    jstates = jax_env.reset_batch(B)
    differed = False
    for ply in range(plies):
        side = (int(torch_env.rules.starting_side) + ply) % 2
        legal = torch_env.legal_mask_many(states)
        jlegal = jmask(jstates.board, jstates.side_to_play) & ~jstates.terminated[:, None]
        np.testing.assert_array_equal(legal.numpy(), np.asarray(jlegal))
        got = searches[side].search(states, legal, add_noise=False).action_probs
        want = jsearch(jnp.int32(side), jstates, jlegal)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"ply {ply}")
        # The two halves are searched by different nets.
        differed |= not torch.equal(got[0], got[B // 2])
        actions = select_actions(got, legal, torch.zeros(B), gen)
        states, _ = torch_env.step_many(states, actions)
        jstates, _ = jstep(jstates, jnp.asarray(actions.numpy()))
        assert_same(jstates, states, STATE_FIELDS, f"ply {ply}")
    assert differed


def test_play_match_counts_and_truncation():
    env = tenv.make_env("brandubh", "cpu")
    fake = torch_fake_evaluate(env)
    cfg = MCTSConfig(num_simulations=4, max_children=8, dirichlet_eps=0.0, max_depth=8)
    gen = torch.Generator().manual_seed(1)
    # A net against itself under a 4-ply cap: no game can end.
    res = tarena.play_match(env, fake, fake, cfg, num_games=4, max_game_len=4, generator=gen)
    assert (res.games, res.truncated) == (4, 4)
    assert res.candidate_wins == res.incumbent_wins == res.draws == 0
    assert res.score == 0.5 and res.decisive_wilson_lb() == 0.0
    assert res.prior_fallback_rate == 0.0
    with pytest.raises(ValueError, match="even"):
        tarena.play_match(env, fake, fake, cfg, num_games=3, max_game_len=4, generator=gen)


def test_play_match_plays_games_to_their_end():
    """Long enough for Brandubh games to end: the counts add up, and only
    the searches of running games count towards the fallback rate."""
    env = tenv.make_env("brandubh", "cpu")
    fake = torch_fake_evaluate(env)

    def flat(obs):  # every legal logit underflows: the uniform fallback fires
        return torch.full((obs.shape[0], env.num_actions), -2e30), torch.zeros(obs.shape[0])

    cfg = MCTSConfig(num_simulations=2, max_children=4, dirichlet_eps=0.0, max_depth=4)
    res = tarena.play_match(env, fake, flat, cfg, num_games=6, max_game_len=60,
                            generator=torch.Generator().manual_seed(2))
    assert res.games == 6
    assert res.candidate_wins + res.incumbent_wins + res.draws + res.truncated == 6
    assert res.truncated < 6
    assert 0.0 < res.prior_fallback_rate < 1.0
