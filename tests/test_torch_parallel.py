"""The port's ranks (``parallel/``, the multi-rank loop) on the CPU over gloo.

Two ranks are spawned (the ``spawn`` start method) and meet in a
``FileStore`` under the test's temporary directory. One spawn runs every
rank-side scenario in turn and saves what each rank saw; the tests read
those files. Tolerances: a 2-rank step on halves against JAX's
``make_train_step`` on the whole batch, parameters within 1e-5 and loss
metrics within 1e-4 relative (as ``test_five_train_steps_match_jax``);
against the port's own 1-rank step on the whole batch, the loss metrics
within 1e-4 relative and the gradient the optimizer is given within 1e-6;
the ranks' parameters and gradients bit-identical; a rank's slice of the augmented global batch
exactly equal to those rows of the 1-rank batch.
"""

import dataclasses
import hashlib
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from alphazeroforhnefatafl_tpu.train import learner as jlearner
from alphazeroforhnefatafl_tpu_torch.core.env import make_env
from alphazeroforhnefatafl_tpu_torch.models.convert import params_from_flax
from alphazeroforhnefatafl_tpu_torch.models.network import make_network
from alphazeroforhnefatafl_tpu_torch.parallel import launch
from alphazeroforhnefatafl_tpu_torch.parallel.dryrun import dryrun_multichip
from alphazeroforhnefatafl_tpu_torch.scripts import train_run
from alphazeroforhnefatafl_tpu_torch.train import learner as tlearner
from alphazeroforhnefatafl_tpu_torch.train.checkpoint import CheckpointManager
from alphazeroforhnefatafl_tpu_torch.train.loop import augment_slice, run_loop
from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer, make_batch_builder
from alphazeroforhnefatafl_tpu_torch.utils.metrics import MetricsLogger
from tests.test_torch_learner import CHANNELS, BLOCKS, N, as_jax, as_torch, batches, nets, sample
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_loop import GATED, tiny_config

WORLD = 2
STEPS = 3  # train steps of the step scenarios, on a global batch of 16
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE")


def spawn_ranks(fn, args, timeout=240.0):
    """Run ``fn(rank, *args)`` in ``WORLD`` spawned processes; raise if one
    fails or they are not done within ``timeout`` seconds."""
    ctx = mp.start_processes(fn, args=args, nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{WORLD} ranks not done in {timeout} s")
    assert not any(p.is_alive() for p in ctx.processes)


def digest(*arrays) -> str:
    return hashlib.sha1(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()


def replay_digest(replay) -> str:
    n = replay.size
    return digest(replay.board[:n], replay.policy_p[:n], replay.value[:n])


def params_of(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def grads_of(net):
    """What the optimizer was given in the last step (the clipped gradient)."""
    return {k: p.grad.clone() for k, p in net.named_parameters()}


def logged(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------- rank side


def rank_loop(work, name, rank, config, replay=None, deadline=None):
    """``run_loop`` on this rank with its own metrics file; returns (state,
    replay, logged lines)."""
    env = make_env("brandubh", "cpu")
    replay = replay or ReplayBuffer(env, config.replay_capacity, config.selfplay.policy_k)
    path = launch.rank_log_path(os.path.join(work, f"{name}.jsonl"), rank)
    with open(os.devnull, "w") as quiet:
        log = MetricsLogger(stream=quiet, jsonl_path=path)
        state = run_loop(env, config, log=log, deadline=deadline, replay=replay)
        log.close()
    return state, replay, logged(path)


def scenario_topology(work, rank, topo):
    try:
        launch.local_batch_slice(9)
        raised = False
    except ValueError:
        raised = True
    return dict(topo=dataclasses.asdict(topo), slice8=launch.local_batch_slice(8), raised=raised)


def scenario_step_on_halves(work, rank, topo):
    """STEPS train steps, each on this rank's half of a global batch."""
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    net = make_network(N, channels=CHANNELS, blocks=BLOCKS, dtype=torch.float32)
    net.load_state_dict(inputs["params"])
    state = tlearner.TrainState(net, *tlearner.make_optimizer(
        net.parameters(), learning_rate=2e-3, warmup_steps=2))
    step = tlearner.make_train_step(state, dist.group.WORLD)
    rows = launch.local_batch_slice(16)
    metrics = []
    for b in inputs["batches"]:
        m = step(as_torch({k: v[rows] for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(params=params_of(net), metrics=metrics)


def scenario_augmented_step(work, rank, topo):
    """The loop's learner path on this rank's rows of one global replay
    sample: the shared draw of transforms, the batch builder, the step."""
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    board, side, reps, pidx, pp, value = inputs["sample"]
    rows = launch.local_batch_slice(board.shape[0])
    gen = torch.Generator().manual_seed(7)
    b_t, p_t = augment_slice(gen, torch.from_numpy(board[rows]), torch.from_numpy(pidx[rows]),
                             board.shape[0], rows)
    net = make_network(N, channels=CHANNELS, blocks=BLOCKS, dtype=torch.float32)
    net.load_state_dict(inputs["params"])
    state = tlearner.TrainState(net, *tlearner.make_optimizer(
        net.parameters(), learning_rate=2e-3, warmup_steps=1))
    step = tlearner.make_train_step(state, dist.group.WORLD)
    build = make_batch_builder(make_env("brandubh", "cpu"))
    m = step(build(b_t, side[rows], reps[rows], p_t, pp[rows], value[rows]))
    return dict(board=b_t, pidx=p_t, params=params_of(net), grads=grads_of(net),
                metrics={k: float(v) for k, v in m.items()})


def scenario_loop(work, rank, topo):
    """Two gated iterations with a checkpoint each (one kept), each rank's
    sidecar read back into a fresh replay, then a resumed third."""
    cfg = tiny_config(os.path.join(work, "loop_ckpt"), 2, checkpoint_keep=1, **GATED)
    state, replay, lines = rank_loop(work, "loop", rank, cfg)
    out = dict(step=state.step, params=params_of(state.net), replay=replay_digest(replay),
               replay_size=replay.size, lines=lines)
    ckpt = cfg.checkpoint_dir
    out["files"] = sorted(os.listdir(ckpt))
    out["sidecars"] = sorted(os.listdir(os.path.join(ckpt, f"replay_host{rank}")))

    env = make_env("brandubh", "cpu")
    fresh = ReplayBuffer(env, cfg.replay_capacity, cfg.selfplay.policy_k)
    probe = tlearner.init_train_state(make_network(env.n, channels=8, blocks=1),
                                      torch.Generator().manual_seed(99), "cpu")
    gen = torch.Generator().manual_seed(12345)
    mgr = CheckpointManager(ckpt, max_to_keep=1, group=dist.group.WORLD)
    it, _, _, _ = mgr.restore(probe, fresh, rank_generator=gen)
    out["restored"] = dict(iteration=it, replay=replay_digest(fresh), size=fresh.size,
                           draw=int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))

    state, replay, lines = rank_loop(work, "loop", rank, dataclasses.replace(cfg, iterations=3))
    out["resumed"] = dict(step=state.step, params=params_of(state.net), lines=lines,
                          replay_size=replay.size)
    return out


def scenario_min_replay_gate(work, rank, topo):
    """Rank 0 starts with a replay above ``min_replay_size``, rank 1 with an
    empty one: no rank may train (and none may wait for the other)."""
    cfg = tiny_config(None, 1, min_replay_size=200)
    env = make_env("brandubh", "cpu")
    replay = ReplayBuffer(env, cfg.replay_capacity, cfg.selfplay.policy_k)
    if rank == 0:
        replay.size = replay.write = replay.total_added = 200
    state, replay, lines = rank_loop(work, "gate", rank, cfg, replay=replay)
    return dict(step=state.step, size=replay.size, lines=lines)


def scenario_deadline(work, rank, topo):
    """Only rank 0 is past its deadline: both ranks stop after iteration 0,
    with a forced checkpoint."""
    cfg = tiny_config(os.path.join(work, "deadline_ckpt"), 5, checkpoint_every=4)
    state, _, lines = rank_loop(work, "deadline", rank, cfg, deadline=0.0 if rank == 0 else None)
    ckpt = cfg.checkpoint_dir
    return dict(step=state.step, lines=lines, files=sorted(os.listdir(ckpt)),
                sidecars=sorted(os.listdir(os.path.join(ckpt, f"replay_host{rank}"))))


def scenario_gate_divergence(work, rank, topo):
    """Rank 1's gate decides the other way: every rank must refuse to go on
    (split incumbents would otherwise go unnoticed)."""
    from alphazeroforhnefatafl_tpu_torch.train import loop

    decide = loop.gate_passes
    if rank == 1:
        loop.gate_passes = lambda config, result: not decide(config, result)
    try:
        rank_loop(work, "diverge", rank, tiny_config(None, 1, **GATED))
        return dict(raised=None)
    except RuntimeError as e:
        return dict(raised=str(e))
    finally:
        loop.gate_passes = decide


def scenario_train_run(work, rank, topo):
    """``scripts.train_run`` inside the group (as under torchrun)."""
    os.chdir(work)
    train_run.main([
        "--name", "tiny", "--preset", "brandubh", "--iterations", "1", "--games", "4",
        "--selfplay-batch", "4", "--max-game-len", "8", "--sims", "4", "--children", "8",
        "--train-steps", "2", "--batch", "16", "--min-replay", "8", "--replay-capacity", "512",
        "--channels", "8", "--blocks", "1", "--arena-games", "0", "--checkpoint-every", "1",
        "--cpu",
    ])
    run_dir = os.path.join(work, "runs", "tiny")
    return dict(files=sorted(os.listdir(run_dir)),
                sidecars=sorted(os.listdir(os.path.join(run_dir, "ckpt", f"replay_host{rank}"))))


SCENARIOS = [scenario_topology, scenario_step_on_halves, scenario_augmented_step, scenario_loop,
             scenario_min_replay_gate, scenario_deadline, scenario_gate_divergence,
             scenario_train_run]


def rank_main(rank, work):
    torch.set_num_threads(1)
    topo = launch.initialize_distributed(f"file://{work}/store", WORLD, rank, device="cpu")
    try:
        for scenario in SCENARIOS:
            t0 = time.perf_counter()
            out = scenario(work, rank, topo)
            print(f"rank {rank} {scenario.__name__} {time.perf_counter() - t0:.2f} s", flush=True)
            torch.save(out, os.path.join(work, f"{scenario.__name__}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- test side


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's result on each rank: ``ranks[name][rank]``, with the
    inputs the parent made (the Flax net's parameters, the batches)."""
    work = tmp_path_factory.mktemp("ranks")
    fnet, params, _ = nets("group", seed=2)
    inputs = dict(
        params=params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
        batches=batches(np.random.RandomState(2), STEPS, B=16, value_scale=(1.0, 6.0)),
        sample=sample(np.random.RandomState(5), 16),
    )
    torch.save(inputs, work / "inputs.pt")
    spawn_ranks(rank_main, (str(work),))
    out = {s.__name__[len("scenario_"):]: [
        torch.load(work / f"{s.__name__}.rank{r}.pt", weights_only=False) for r in range(WORLD)]
        for s in SCENARIOS}
    out.update(inputs=inputs, fnet=fnet, flax_params=params, work=work)
    return out


def assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_initialize_distributed_without_a_group_is_world_1(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    topo = launch.initialize_distributed(device="cpu")
    assert topo == launch.HostTopology(0, 1, 1, 1, torch.device("cpu"), None)
    assert launch.world() == (0, 1) and launch.local_batch_slice(9) == slice(0, 9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.initialize_distributed()


@pytest.mark.parametrize("explicit, env_rank, want_rank", [(0, "1", 0), (None, "1", 1), (1, "0", 1)])
def test_initialize_distributed_reads_torchrun_variables(monkeypatch, explicit, env_rank, want_rank):
    """torchrun's variables fill what the caller left out; an explicit
    ``process_id=0`` is not overridden by a stale ``RANK``."""
    seen = {}

    class Joined(Exception):
        pass

    def fake_init(backend, init_method, world_size, rank):
        seen.update(backend=backend, init_method=init_method, world_size=world_size, rank=rank)
        raise Joined

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", env_rank)
    with pytest.raises(Joined):
        launch.initialize_distributed(process_id=explicit, device="cpu")
    assert seen == dict(backend="gloo", init_method="tcp://localhost:29511", world_size=2,
                        rank=want_rank)


@pytest.mark.parametrize("device, local_ranks, cards, want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo"), ("cpu", 2, 0, "gloo"), ("cpu", 2, 8, "gloo"),
])
def test_backend_is_nccl_only_with_a_card_a_rank(device, local_ranks, cards, want):
    assert launch.choose_backend(device, local_ranks, cards) == want


@pytest.mark.parametrize("rank", range(WORLD))
def test_ranks_join_with_their_slices(ranks, rank):
    got = ranks["topology"][rank]
    assert got["topo"] == dict(process_id=rank, num_processes=WORLD, local_devices=1,
                               global_devices=WORLD, device=torch.device("cpu"), backend="gloo")
    assert got["slice8"] == slice(4 * rank, 4 * rank + 4)
    assert got["raised"]  # 9 does not divide across 2 ranks


def test_log_path_of_each_rank():
    assert launch.rank_log_path("runs/x/metrics.jsonl", 0) == "runs/x/metrics.jsonl"
    assert launch.rank_log_path("runs/x/metrics.jsonl", 3) == "runs/x/metrics.rank3.jsonl"


def test_two_rank_step_on_halves_matches_jax_on_the_whole_batch(ranks):
    fnet, params, inputs = ranks["fnet"], ranks["flax_params"], ranks["inputs"]
    got = ranks["step_on_halves"]
    assert_params_equal(got[0]["params"], got[1]["params"])  # bit-identical ranks
    assert got[0]["metrics"] == got[1]["metrics"]

    opt = jlearner.make_optimizer(learning_rate=2e-3, warmup_steps=2)
    jstate = jlearner.TrainState(params=params, opt_state=opt.init(params), step=jnp.int32(0))
    jstep = jax.jit(jlearner.make_train_step(fnet, opt))
    norms = []
    for i, b in enumerate(inputs["batches"]):
        jstate, want = jstep(jstate, as_jax(b))
        for k in ("loss", "grad_norm", "policy_loss", "value_loss", "value_mean"):
            np.testing.assert_allclose(got[0]["metrics"][i][k], float(want[k]), rtol=1e-4,
                                       atol=1e-6 if k == "value_mean" else 0, err_msg=f"{i} {k}")
        norms.append(got[0]["metrics"][i]["grad_norm"])
    assert max(norms) > 1.0  # the clip of the global norm was exercised
    want_sd = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    moved = 0.0
    for k, v in got[0]["params"].items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
        moved = max(moved, float((v - inputs["params"][k]).abs().max()))
    assert moved > 1e-3


def test_augmented_two_rank_step_equals_one_rank_on_the_global_batch(ranks):
    """Each rank transforms its rows with the draw of the whole global
    batch, so two ranks on halves take the step one rank takes on all."""
    inputs, got = ranks["inputs"], ranks["augmented_step"]
    board, side, reps, pidx, pp, value = inputs["sample"]
    gen = torch.Generator().manual_seed(7)
    whole = slice(0, board.shape[0])
    b_t, p_t = augment_slice(gen, torch.from_numpy(board), torch.from_numpy(pidx), 16, whole)
    # In one process the draw is random_symmetry_batch's own.
    from alphazeroforhnefatafl_tpu_torch.core.symmetry import random_symmetry_batch

    again = random_symmetry_batch(torch.Generator().manual_seed(7), torch.from_numpy(board),
                                  torch.from_numpy(pidx))
    assert torch.equal(again[0], b_t) and torch.equal(again[1], p_t)
    assert not torch.equal(b_t, torch.from_numpy(board))  # some transform moved a board
    for r in range(WORLD):
        rows = slice(8 * r, 8 * r + 8)
        assert torch.equal(got[r]["board"], b_t[rows]) and torch.equal(got[r]["pidx"], p_t[rows])
    assert_params_equal(got[0]["params"], got[1]["params"])

    net = make_network(N, channels=CHANNELS, blocks=BLOCKS, dtype=torch.float32)
    net.load_state_dict(inputs["params"])
    state = tlearner.TrainState(net, *tlearner.make_optimizer(
        net.parameters(), learning_rate=2e-3, warmup_steps=1))
    step = tlearner.make_train_step(state)
    build = make_batch_builder(make_env("brandubh", "cpu"))
    want = step(build(b_t, side, reps, p_t, pp, value))
    for k in ("loss", "grad_norm", "policy_loss", "value_loss"):
        np.testing.assert_allclose(got[0]["metrics"][k], float(want[k]), rtol=1e-4, err_msg=k)
    # The mean of the halves' gradients is the whole batch's (the
    # parameters after Adam are not compared: its first update is about
    # lr * sign(g), so a gradient of 1e-9 rounds either way).
    assert_params_equal(got[0]["grads"], got[1]["grads"])
    for k, g in grads_of(net).items():
        np.testing.assert_allclose(got[0]["grads"][k].numpy(), g.numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_two_rank_loop_keeps_the_ranks_equal_and_their_games_apart(ranks):
    r0, r1 = ranks["loop"]
    assert r0["step"] == r1["step"] == 6  # 2 iterations x 3 steps
    assert_params_equal(r0["params"], r1["params"])
    assert r0["replay"] != r1["replay"]  # each rank plays its own games
    for r in (r0, r1):
        assert [l["step"] for l in r["lines"] if "selfplay/games" in l] == [0, 1]
        # Each rank plays games_per_iteration // 2 = 2 games (at its batch of 4).
        assert all(l["selfplay/games"] >= 2 for l in r["lines"] if "selfplay/games" in l)
    # Every rank played the same arena and took the same decision.
    arena0 = [{k: v for k, v in l.items() if k.startswith("arena/")} for l in r0["lines"]]
    arena1 = [{k: v for k, v in l.items() if k.startswith("arena/")} for l in r1["lines"]]
    assert arena0 == arena1 and any(arena0)
    # Rank 1 logs beside rank 0's file, not into it.
    assert os.path.exists(ranks["work"] / "loop.rank1.jsonl")


@pytest.mark.parametrize("rank", range(WORLD))
def test_sidecars_are_written_pruned_and_restored_into_their_rank(ranks, rank):
    mine, other = ranks["loop"][rank], ranks["loop"][1 - rank]
    # One main file (rank 0's) and one sidecar a rank, pruned to the last.
    assert mine["files"] == ["ckpt_00000001.pt", "replay_host0", "replay_host1"]
    assert mine["sidecars"] == ["1.pt"]
    restored = mine["restored"]
    assert restored["iteration"] == 1
    assert restored["replay"] == mine["replay"] != other["replay"]
    assert restored["size"] == mine["replay_size"]
    # The rank's self-play generator came back from its sidecar: another
    # rank's (or a fresh seed's) draw would differ.
    assert restored["draw"] != other["restored"]["draw"]
    # The resume left iteration 2's file alone; the replays are beside it.
    payload = torch.load(ranks["work"] / "loop_ckpt" / "ckpt_00000002.pt", weights_only=True)
    assert "replay" not in payload and payload["iteration"] == 2
    # The resumed call starts at iteration 2 from this rank's own replay.
    resumed = mine["resumed"]
    assert resumed["step"] == 9
    assert [l["resume/iteration"] for l in resumed["lines"] if "resume/iteration" in l] == [2.0]
    assert resumed["replay_size"] >= mine["replay_size"]
    assert_params_equal(resumed["params"], other["resumed"]["params"])


def test_min_replay_gate_holds_across_ranks(ranks):
    r0, r1 = ranks["min_replay_gate"]
    assert r0["size"] >= 200 > r1["size"]
    assert r0["step"] == r1["step"] == 0
    assert not any("train/loss" in l for r in (r0, r1) for l in r["lines"])


def test_deadline_of_one_rank_stops_every_rank(ranks):
    for r in ranks["deadline"]:
        assert r["step"] == 3  # iteration 0 only
        assert r["lines"][-1].get("stop/deadline_reached") == 1.0
        assert [l["step"] for l in r["lines"] if "selfplay/games" in l] == [0]
        assert r["files"] == ["ckpt_00000000.pt", "replay_host0", "replay_host1"]
        assert r["sidecars"] == ["0.pt"]


def test_ranks_that_gate_differently_stop(ranks):
    for r in ranks["gate_divergence"]:
        assert "the ranks' gate decisions differ" in r["raised"]


def test_train_run_under_a_group_logs_each_rank_apart(ranks):
    for r in range(WORLD):
        assert ranks["train_run"][r]["sidecars"] == ["0.pt"]
    assert ranks["train_run"][0]["files"] == ["ckpt", "config.jsonl", "metrics.jsonl",
                                              "metrics.rank1.jsonl"]
    run_dir = ranks["work"] / "runs" / "tiny"
    assert len((run_dir / "config.jsonl").read_text().splitlines()) == 1
    for name in ("metrics.jsonl", "metrics.rank1.jsonl"):
        assert [l["step"] for l in logged(run_dir / name)] == [0]


def test_dryrun_multichip_on_the_cpu(capsys):
    out = dryrun_multichip(WORLD, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: 2 ranks on cpu over gloo")
    assert out["arena/decisive"] >= 1 and "Wilson lower bound" in line
    assert out["step"] == 2


def test_world_1_loop_makes_no_collective(monkeypatch, tmp_path):
    """In one process the loop, its checkpoint and its resume never reach
    ``torch.distributed`` beyond asking whether a group exists."""

    def refuse(*args, **kw):
        raise AssertionError("a collective was called at world 1")

    for name in ("all_reduce", "broadcast", "all_gather", "barrier", "init_process_group",
                 "get_rank", "get_world_size", "get_backend"):
        monkeypatch.setattr(dist, name, refuse)
    env = make_env("brandubh", "cpu")
    cfg = tiny_config(tmp_path / "ckpt", 1, **GATED)
    with open(os.devnull, "w") as quiet:
        state = run_loop(env, cfg, log=MetricsLogger(stream=quiet))
        assert state.step == 3
        state = run_loop(env, dataclasses.replace(cfg, iterations=2),
                         log=MetricsLogger(stream=quiet))
    assert state.step == 6
    assert "replay" in torch.load(tmp_path / "ckpt" / "ckpt_00000001.pt", weights_only=True)
