"""The port's search variants against the JAX search: multi-leaf
virtual-loss waves and Gumbel root selection with sequential halving.

Both sides use the deterministic fake network of tests/test_mcts.py with
its logits sharpened on every other position (times 64, exact in float32):
a sharp prior makes a wave's later traversals claim the edge an earlier one
claimed, so the demotion of duplicate claims is on the tested path. Root
noise is off, 32 simulations and 32 children.

Tolerances. Multi-leaf: every integer field of the tree, ``root_visits``,
``best_action``, ``action_probs`` and ``prior_fallback_rate`` equal, and so
are ``child_W`` and ``root_value``: the port sums a wave's backed-up values
in the JAX search's order (scattering the leaves' paths straight into
``child_W`` instead moves it by up to 8e-6 on these positions, and by less
than 1e-6 on some, so a tolerance would not tell the two apart). Gumbel (noise off, and with
JAX's own Gumbel draw in place of the port's): root ``child_N`` and
``best_action`` equal, ``action_probs`` and ``root_value`` within 1e-5 (a
log and a softmax of either library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.search import mcts as jmcts
from alphazeroforhnefatafl_tpu_torch.core import actions as A
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.core import fen as F
from alphazeroforhnefatafl_tpu_torch.search import mcts as tmcts
from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig
from tests.test_mcts import make_fake_evaluate
from tests.test_torch_env import to_jax
from tests.test_torch_mcts import playout_positions, torch_fake_evaluate
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)

CFG = dict(num_simulations=32, max_children=32, cpuct=1.5, dirichlet_eps=0.0, max_depth=16)


def jax_sharp_evaluate(env):
    fake = make_fake_evaluate(env)

    def evaluate(params, obs):
        logits, value = fake(params, obs)
        att = jnp.sum(obs[..., 0], axis=(1, 2)).astype(jnp.int32)
        sharp = (att + obs[:, 0, 0, 4].astype(jnp.int32)) % 2
        return logits * (1.0 + 63.0 * sharp[:, None].astype(jnp.float32)), value

    return evaluate


def torch_sharp_evaluate(env):
    fake = torch_fake_evaluate(env)

    def evaluate(obs):
        logits, value = fake(obs)
        sharp = (obs[..., 0].sum((1, 2)).long() + obs[:, 0, 0, 4].long()) % 2
        return logits * (1.0 + 63.0 * sharp[:, None].float()), value

    return evaluate


_POSITIONS = {}


def positions(preset):
    """(torch env, jax env, torch states, torch legal), made once per preset."""
    if preset not in _POSITIONS:
        torch_env = tenv.make_env(preset, "cpu")
        states = playout_positions(torch_env, plies=(0, 5, 8, 13))
        _POSITIONS[preset] = (torch_env, jenv.make_env(preset), states,
                              torch_env.legal_mask_many(states))
    return _POSITIONS[preset]


def jax_search(jax_env, states, legal, key=0, add_noise=False, **changes):
    jm = jmcts.MCTS(jax_env, jax_sharp_evaluate(jax_env), jmcts.MCTSConfig(**{**CFG, **changes}))
    return jax.jit(lambda s, l, r: jm.search(None, s, l, r, add_noise=add_noise))(
        to_jax(states), jnp.asarray(legal.numpy()), jax.random.PRNGKey(key)
    )


def torch_search(torch_env, states, legal, generator=None, add_noise=False, **changes):
    tm = tmcts.MCTS(torch_env, torch_sharp_evaluate(torch_env), tmcts.MCTSConfig(**{**CFG, **changes}))
    return tm.search(states, legal, generator, add_noise=add_noise)


@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("preset", ["brandubh", "copenhagen"])
def test_multi_leaf_matches_jax(preset, L):
    torch_env, jax_env, states, legal = positions(preset)
    want = jax_search(jax_env, states, legal, leaves_per_wave=L)
    got = torch_search(torch_env, states, legal, leaves_per_wave=L)

    for name in ("child_N", "child_node", "child_action", "expanded", "terminal"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want.tree, name)), getattr(got.tree, name).numpy(), err_msg=name)
    for name in ("root_visits", "best_action", "action_probs", "prior_fallback_rate"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, name)), getattr(got, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(got.tree.child_W.numpy(), np.asarray(want.tree.child_W))
    np.testing.assert_array_equal(got.root_value.numpy(), np.asarray(want.root_value))
    # The softmax of the sharpened logits differs in the last digits.
    np.testing.assert_allclose(
        got.tree.child_prior.numpy(), np.asarray(want.tree.child_prior), rtol=0, atol=1e-5)

    assert (got.root_visits == CFG["num_simulations"]).all()
    # Two leaves of a wave claimed the same edge and the second was demoted:
    # fewer nodes are linked than simulations were run. (The 7x7 board's
    # sharpened priors are peaked enough for that; the 11x11 board's, over
    # some hundred legal moves, are not.)
    linked = (got.tree.child_node >= 0).sum((1, 2))
    if preset == "brandubh":
        assert int(linked.min()) < CFG["num_simulations"], linked.tolist()
    assert (linked > 0).all()
    # Every linked slot lies in the span of a wave, and is linked once.
    for b in range(states.batch_size):
        ids = got.tree.child_node[b][got.tree.child_node[b] >= 0]
        assert len(set(ids.tolist())) == len(ids) and int(ids.max()) <= CFG["num_simulations"]


def test_single_leaf_wave_is_the_serial_search():
    """``leaves_per_wave=1`` never takes the virtual-loss branch: the search
    with the sharpened net equals JAX's exactly, values included."""
    torch_env, jax_env, states, legal = positions("brandubh")
    want = jax_search(jax_env, states, legal)
    got = torch_search(torch_env, states, legal)
    for name in ("child_N", "child_node", "child_W"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want.tree, name)), getattr(got.tree, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(want.root_value), got.root_value.numpy())
    # Serial waves link one node per simulation unless a walk ends at a
    # terminal node.
    assert int((got.tree.child_node >= 0).sum((1, 2)).max()) == CFG["num_simulations"]


@pytest.mark.parametrize("noise", ["off", "jax_draw"])
@pytest.mark.parametrize("preset", ["brandubh", "copenhagen"])
def test_gumbel_matches_jax(preset, noise, monkeypatch):
    torch_env, jax_env, states, legal = positions(preset)
    add_noise = noise == "jax_draw"
    want = jax_search(jax_env, states, legal, key=5, add_noise=add_noise, root_selection="gumbel")
    if add_noise:
        # The JAX root setup splits its key once and draws [B, K] Gumbels.
        g_key = jax.random.split(jax.random.PRNGKey(5))[1]
        draw = np.asarray(jax.random.gumbel(g_key, (states.batch_size, CFG["max_children"])))
        monkeypatch.setattr(tmcts, "_gumbel", lambda shape, generator, device: torch.from_numpy(draw.copy()))
    got = torch_search(torch_env, states, legal, torch.Generator().manual_seed(0),
                       add_noise=add_noise, root_selection="gumbel")

    np.testing.assert_array_equal(np.asarray(want.tree.child_N[:, 0]), got.tree.child_N[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(want.tree.child_action[:, 0]), got.tree.child_action[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(want.best_action), got.best_action.numpy())
    np.testing.assert_array_equal(np.asarray(want.root_visits), got.root_visits.numpy())
    np.testing.assert_allclose(got.action_probs.numpy(), np.asarray(want.action_probs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.root_value.numpy(), np.asarray(want.root_value), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(want.prior_fallback_rate), got.prior_fallback_rate.numpy())

    probs = got.action_probs
    np.testing.assert_allclose(probs.sum(1).numpy(), 1.0, rtol=1e-5)
    assert float(probs[~legal].sum()) == 0.0
    assert legal[torch.arange(states.batch_size), got.best_action.long()].all()
    # Halving spreads the visits: no root slot holds them all.
    assert int(got.tree.child_N[:, 0].max()) < CFG["num_simulations"]


def test_gumbel_noise_comes_from_the_generator_only():
    torch_env, _, states, legal = positions("brandubh")
    cfg = dict(root_selection="gumbel", num_simulations=16)

    def run(seed, add_noise=True):
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        return torch_search(torch_env, states, legal, gen, add_noise=add_noise, **cfg)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a.best_action, b.best_action) and torch.equal(a.action_probs, b.action_probs)
    assert not torch.equal(a.tree.child_N[:, 0], c.tree.child_N[:, 0])
    quiet = run(None, add_noise=False)
    assert torch.equal(quiet.action_probs, run(9, add_noise=False).action_probs)
    with pytest.raises(ValueError, match="generator"):
        run(None)
    # No Dirichlet noise under Gumbel: the root priors are the net's.
    noisy_eps = torch_search(torch_env, states, legal, torch.Generator().manual_seed(3),
                             add_noise=True, dirichlet_eps=0.25, **cfg)
    assert torch.equal(noisy_eps.tree.child_prior[:, 0], a.tree.child_prior[:, 0])
    assert torch.equal(noisy_eps.best_action, a.best_action)


def test_gumbel_draw_is_standard_gumbel():
    g = tmcts._gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert abs(float(g.mean()) - 0.5772) < 0.01  # Euler's constant
    assert abs(float(g.var()) - np.pi**2 / 6) < 0.03


@pytest.mark.parametrize("sims", [1, 7, 16, 24, 64, 128, 800])
@pytest.mark.parametrize("m0", [1, 2, 3, 5, 16, 32])
def test_halving_schedule_matches_jax(sims, m0):
    got = tmcts._sh_considered_schedule(sims, m0)
    assert got == jmcts._sh_considered_schedule(sims, m0)
    assert len(got) == sims and all(a >= b for a, b in zip(got, got[1:]))


def test_config_mode_validation():
    """The JAX ``MCTS.__init__`` checks, with its exception type; and no
    value the JAX config accepts raises in the port."""
    torch_env, jax_env, _, _ = positions("brandubh")
    tev, jev = torch_fake_evaluate(torch_env), make_fake_evaluate(jax_env)
    for bad in (dict(node_read="gahter"), dict(topk="fast"), dict(backup="sparse"),
                dict(root_selection="ucb")):
        with pytest.raises(ValueError):
            jmcts.MCTS(jax_env, jev, jmcts.MCTSConfig(num_simulations=4, **bad))
        with pytest.raises(ValueError, match=next(iter(bad))):
            tmcts.MCTS(torch_env, tev, tmcts.MCTSConfig(num_simulations=4, **bad))
    for good in (dict(node_read="dot", topk="exact", backup="scatter"),
                 dict(node_read="gather", topk="approx", backup="dense", root_selection="gumbel"),
                 dict(topk="approx", leaves_per_wave=2),
                 dict()):
        jmcts.MCTS(jax_env, jev, jmcts.MCTSConfig(num_simulations=4, **good))
        tmcts.MCTS(torch_env, tev, tmcts.MCTSConfig(num_simulations=4, **good))


def test_multi_leaf_validation():
    torch_env, jax_env, _, _ = positions("brandubh")
    tev, jev = torch_fake_evaluate(torch_env), make_fake_evaluate(jax_env)
    for bad in (dict(leaves_per_wave=3), dict(leaves_per_wave=0), dict(leaves_per_wave=-2),
                dict(leaves_per_wave=2, root_selection="gumbel")):
        with pytest.raises(ValueError):
            jmcts.MCTS(jax_env, jev, jmcts.MCTSConfig(num_simulations=16, **bad))
        with pytest.raises(ValueError):
            tmcts.MCTS(torch_env, tev, tmcts.MCTSConfig(num_simulations=16, **bad))


def test_config_has_the_jax_fields_and_defaults():
    import dataclasses

    mine = {f.name: f.default for f in dataclasses.fields(tmcts.MCTSConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jmcts.MCTSConfig)}
    assert mine == theirs


@pytest.mark.parametrize("changes", [
    dict(topk="approx"), dict(node_read="gather", backup="scatter", traverse_unroll=1, topk_recall=0.5),
], ids=["approx", "layout_knobs"])
def test_tpu_layout_knobs_change_nothing(changes):
    """``topk="approx"`` runs the exact top-k, and the other layout knobs have
    one form in the port: the search is the same search."""
    torch_env, _, states, legal = positions("brandubh")
    base = torch_search(torch_env, states, legal, num_simulations=8)
    got = torch_search(torch_env, states, legal, num_simulations=8, **changes)
    assert torch.equal(base.tree.child_N, got.tree.child_N)
    assert torch.equal(base.action_probs, got.action_probs)


# --------------------------- tactics ---------------------------


def tactical(fen, side, **changes):
    env = tenv.make_env("brandubh", "cpu")
    board = torch.as_tensor(np.asarray(F.board_from_fen(fen)), dtype=torch.int8)
    s = env.reset_batch(1).replace(
        board=board[None], side_to_play=torch.tensor([side], dtype=torch.int32))
    cfg = tmcts.MCTSConfig(num_simulations=64, max_children=64, dirichlet_eps=0.0, max_depth=32, **changes)
    res = tmcts.MCTS(env, torch_fake_evaluate(env), cfg).search(
        s, env.legal_mask_many(s), add_noise=False)
    return res, res.action_probs[0].numpy()


ESCAPES = {A.encode_from_tiles(7, (0, 2), (0, 0)), A.encode_from_tiles(7, (0, 2), (0, 6))}


def test_multi_leaf_finds_king_escape():
    """Defender to move, king one step from a corner, L=4: virtual-loss
    waves must not break tactics."""
    res, probs = tactical("2K4/7/3t3/7/7/3T3/7", 1, leaves_per_wave=4)
    assert int(res.best_action[0]) in ESCAPES
    assert float(res.root_value[0]) > 0.3


def test_gumbel_finds_king_escape():
    res, probs = tactical("2K4/7/3t3/7/7/3T3/7", 1, root_selection="gumbel")
    assert int(res.best_action[0]) in ESCAPES and int(probs.argmax()) in ESCAPES
    # The halving winner's completed Q, not the mean over refuted candidates.
    assert float(res.root_value[0]) > 0.3


def test_gumbel_finds_king_capture():
    """Attacker to move, king capturable in one move."""
    res, probs = tactical("7/7/7/7/7/3tK1t/7", 0, root_selection="gumbel")
    win = A.encode_from_tiles(7, (5, 6), (5, 5))
    assert int(res.best_action[0]) == win and probs[win] == probs.max()
    assert float(res.root_value[0]) > 0.3


# --------------------------- self-play's move tail ---------------------------


def test_move_tail_plays_the_halving_winner_under_gumbel():
    env, _, states, legal = positions("brandubh")
    B = states.batch_size
    cfg = tmcts.MCTSConfig(**{**CFG, "num_simulations": 8, "root_selection": "gumbel"})
    gen = torch.Generator().manual_seed(1)
    res = tmcts.MCTS(env, torch_sharp_evaluate(env), cfg).search(states, legal, gen)
    probs, best = res.action_probs, res.best_action
    ones = torch.ones(B)

    actor = SelfPlayActor(env, torch_sharp_evaluate(env), cfg, SelfPlayConfig(batch_size=B))
    for temps in (ones, torch.zeros(B)):
        _, actions, info, top_a, top_p = actor.move_tail(states, legal, probs, temps, gen, best)
        assert torch.equal(actions, best) and not info.invalid.any()
    # The policy target is the improved policy, whatever was played.
    want_a, want_p = actor.policy_target(probs)
    assert torch.equal(top_a, want_a) and torch.equal(top_p, want_p)

    # With the sampling option: sampled from the improved policy while the
    # temperature is on, the winner after.
    sampler = SelfPlayActor(env, torch_sharp_evaluate(env), cfg,
                            SelfPlayConfig(batch_size=B, gumbel_sample_temp_moves=True))
    temps = torch.tensor([1.0, 0.0, 1.0, 0.0])
    seen = set()
    for _ in range(24):
        _, actions, _, _, _ = sampler.move_tail(states, legal, probs, temps, gen, best)
        assert torch.equal(actions[temps == 0], best[temps == 0])
        assert (probs[torch.arange(B), actions.long()] > 0).all()
        seen.add(tuple(actions[temps > 0].tolist()))
    assert len(seen) > 1

    # Under PUCT the option changes nothing: the visit-count policy is sampled.
    puct = SelfPlayActor(env, torch_sharp_evaluate(env), tmcts.MCTSConfig(**CFG),
                         SelfPlayConfig(batch_size=B, gumbel_sample_temp_moves=True))
    _, actions, _, _, _ = puct.move_tail(states, legal, probs, torch.zeros(B), gen, best)
    assert (probs[torch.arange(B), actions.long()] == probs.max(1).values).all()


def test_selfplay_config_has_the_gumbel_field_of_the_jax_config():
    from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayConfig as JaxSPConfig

    assert SelfPlayConfig().gumbel_sample_temp_moves is JaxSPConfig().gumbel_sample_temp_moves is False


@pytest.mark.parametrize("changes", [dict(leaves_per_wave=2), dict(root_selection="gumbel")],
                         ids=["L2", "gumbel"])
def test_actor_plays_whole_games_with_the_variant(changes):
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer

    env = tenv.make_env("brandubh", "cpu")
    cfg = SelfPlayConfig(batch_size=4, max_game_len=6, policy_k=16)
    actor = SelfPlayActor(env, torch_fake_evaluate(env),
                          tmcts.MCTSConfig(num_simulations=8, max_children=16, **changes), cfg)
    replay = ReplayBuffer(env, 64, cfg.policy_k)
    stats = actor.play(replay, torch.Generator().manual_seed(0), num_games=4)
    assert stats.games == 4 and replay.size == stats.positions == 24
    np.testing.assert_allclose(replay.policy_p[: replay.size].sum(1), 1.0, rtol=1e-5)
