"""The port's D4 symmetry against the JAX package's, exactly.

``transform_board`` on an asymmetric board for all 8 transforms;
``random_symmetry_batch`` with JAX's own drawn transforms injected into the
port (the two packages' random draws cannot agree); and the property that
pins board transform and action permutation together,
``mask(T(board)) == perm_T(mask(board))``, through the port's plain mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import symmetry as jsym
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.core import symmetry as tsym
from alphazeroforhnefatafl_tpu_torch.core.rules import PRESETS
from tests.test_env_golden import random_dense_board


@pytest.mark.parametrize("t", range(8))
def test_transform_board_matches_jax(t):
    assert tsym.NUM_TRANSFORMS == jsym.NUM_TRANSFORMS == 8
    board = np.arange(2 * 5 * 5, dtype=np.int8).reshape(2, 5, 5)  # no symmetry at all
    want = np.asarray(jsym.transform_board(jnp.asarray(board), t))
    got = tsym.transform_board(torch.from_numpy(board), t).numpy()
    np.testing.assert_array_equal(got, want)
    flip, rot = divmod(t, 4)
    by_numpy = np.rot90(board, rot, axes=(-2, -1))
    np.testing.assert_array_equal(got, np.flip(by_numpy, -2) if flip else by_numpy)
    stack = tsym.all_board_transforms(torch.from_numpy(board))
    np.testing.assert_array_equal(stack[t].numpy(), want)


@pytest.mark.parametrize("n", [7, 11])
def test_action_permutations_match_jax(n):
    got, want = tsym.action_permutations(n), jsym.action_permutations(n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for t in range(8):
        np.testing.assert_array_equal(np.sort(got[t]), np.arange(got.shape[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_symmetry_batch_matches_jax_with_its_draw(seed):
    n, B, K = 7, 16, 6
    rng = np.random.RandomState(seed)
    boards = np.stack([random_dense_board(rng, n) for _ in range(B)]).astype(np.int8)
    idx = rng.randint(0, n * n * 4 * (n - 1), size=(B, K)).astype(np.int32)
    idx[rng.rand(B, K) < 0.3] = -1  # pads anywhere in a row
    idx[0] = -1
    key = jax.random.PRNGKey(seed)
    want_b, want_i = jsym.random_symmetry_batch(key, jnp.asarray(boards), jnp.asarray(idx))
    draw = np.array(jax.random.randint(key, (B,), 0, 8))
    assert len(set(draw.tolist())) > 3
    got_b, got_i = tsym.random_symmetry_batch(
        None, torch.from_numpy(boards), torch.from_numpy(idx), transforms=torch.from_numpy(draw)
    )
    assert got_b.dtype == torch.int8 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i.numpy()[idx < 0] == -1).all() and (got_i.numpy()[idx >= 0] >= 0).all()


def test_random_symmetry_batch_draws_from_its_generator():
    boards = torch.arange(64 * 49, dtype=torch.int32).reshape(64, 7, 7).to(torch.int8)
    idx = torch.arange(64 * 3, dtype=torch.int32).reshape(64, 3)
    a = tsym.random_symmetry_batch(torch.Generator().manual_seed(5), boards, idx)
    b = tsym.random_symmetry_batch(torch.Generator().manual_seed(5), boards, idx)
    c = tsym.random_symmetry_batch(torch.Generator().manual_seed(6), boards, idx)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # Each sample is one of the 8 transforms of its own board, with the
    # matching permutation of its indices.
    variants = tsym.all_board_transforms(boards)
    perms = tsym.action_permutations(7)
    used = set()
    for s in range(64):
        ts = [t for t in range(8) if torch.equal(variants[t, s], a[0][s])]
        assert ts, s
        assert any(np.array_equal(perms[t][idx[s].numpy()], a[1][s].numpy()) for t in ts)
        used.add(ts[0])
    assert len(used) >= 6


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_mask_commutes_with_symmetry(preset):
    env = tenv.make_env(preset, "cpu")
    n = env.n
    board = torch.from_numpy(random_dense_board(np.random.RandomState(5), n).astype(np.int8))
    perms = tsym.action_permutations(n)
    variants = tsym.all_board_transforms(board)  # [8, N, N]
    for side in (0, 1):
        sides = torch.full((8,), side, dtype=torch.int32)
        masks = env.legal_mask_many(
            env.reset_batch(8).replace(board=variants, side_to_play=sides)
        ).numpy()
        assert masks[0].any()
        for t in range(8):
            expect = np.zeros_like(masks[0])
            expect[perms[t]] = masks[0]
            assert np.array_equal(masks[t], expect), f"t={t} side={side}"
