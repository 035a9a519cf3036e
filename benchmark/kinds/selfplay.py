"""Self-play at steady state: the program's ``SelfPlayActor.move`` on a
batch of games spread over every ply, with the host work of ``play``
around each move.

Traffic (``traffic/<name>.json``, kind ``selfplay``): each game starts at a
ply drawn from the seed, uniform over ``0 .. start_ply_max``, reached by
uniformly random legal moves from the opening (a game that ends on the way
starts again from the opening). The window then plays moves as ``play``
does: it reads back the boards, root values and policy targets, writes
each ended game (decided, or cut at the configuration's cap) into a replay
ring, and restarts it from the opening with ``where_state``. The
temperature is on while a game's ply is under the configuration's
threshold. There is no resignation (``reduced`` says so); the window
counts the games that the record's rule would have resigned.

The window runs from its first move to the end of the first move that ends
after ``--seconds``: a move is never cut. Without ``--trace`` it runs under
the device trace, in stretches of ``busy_stretch_moves`` moves, and its
rate is the positions over the seconds in which the card was busy. Its
outputs are then judged by ``reference/selfplay_check.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

import harness
from reference import net as ref_net
from reference import selfplay_check

def _post_pack(s):
    """The fields of a state after a move that the check compares, one row a
    game, read back in one copy (the order of ``selfplay_check._post_of``)."""
    return torch.stack([
        s.terminated.to(torch.int32), s.result, s.reason, s.side_to_play, s.turn,
        s.plays_since_capture, s.reps[:, 0], s.reps[:, 1],
        s.mid_pair[:, 0].to(torch.int32), s.mid_pair[:, 1].to(torch.int32),
    ], 1)


def _state_fields(s) -> dict:
    return {
        "board": s.board.cpu().numpy(), "side": s.side_to_play.cpu().numpy(),
        "reps": s.reps.cpu().numpy(), "mid_pair": s.mid_pair.cpu().numpy().astype(np.int32),
        "plays_since_capture": s.plays_since_capture.cpu().numpy(),
        "turn": s.turn.cpu().numpy(), "terminated": s.terminated.cpu().numpy().astype(np.int32),
        "result": s.result.cpu().numpy(), "reason": s.reason.cpu().numpy(),
    }


class Evaluator:
    """The net as the search's ``evaluate``; on request keeps the next
    call's outputs (a search's root) for some rows, on the card."""

    def __init__(self, net):
        self.net = net
        self.rows = None
        self.kept = None

    def __call__(self, obs):
        logits, value = self.net(obs)
        if self.rows is not None:
            self.kept = (logits[self.rows].float().clone(), value[self.rows].float().clone())
            self.rows = None
        return logits, value


def start_states(env, B: int, ply_max: int, seed: int, device):
    """The traffic's start positions: ``(states, start_ply i64[B], choices
    i64[ply_max, B])``. At prefix ply p a game whose start ply is above p
    plays its ``choices[p] % n_legal``-th legal action (ascending ids)."""
    from alphazeroforhnefatafl_tpu_torch.core.env import where_state

    g = torch.Generator(device=device)
    g.manual_seed(harness.sub_seed(seed, "start"))
    start_ply = torch.randint(0, ply_max + 1, (B,), generator=g, device=device)
    choices = torch.randint(0, 1 << 24, (max(ply_max, 1), B), generator=g, device=device)
    states, fresh = env.reset_batch(B), env.reset_batch(B)
    for p in range(int(start_ply.max())):
        legal = env.legal_mask_many(states)
        k = choices[p] % legal.sum(1).clamp(min=1)
        action = (legal.cumsum(1) <= k[:, None]).sum(1)
        new, _ = env.step_many(states, action)
        states = where_state(start_ply > p, new, states)
        states = where_state(states.terminated, fresh, states)
    return states, start_ply.cpu().numpy(), choices.cpu().numpy()


def derive(record: dict) -> dict:
    """The sizes the runner and the check read, grouped, from a
    configuration file: the run record's own keys, and ``assumed`` for what
    the record does not give."""
    def get(key):
        return record[key] if key in record else record["assumed"][key]["value"]

    return {
        "name": record["name"], "preset": record["preset"], "limits": record["limits"],
        "net": {"channels": get("channels"), "blocks": get("blocks"), "norm": get("norm"),
                "value_hidden": get("value_hidden"), "trunk_dtype": get("trunk_dtype")},
        "search": {"num_simulations": get("sims"), "max_children": get("children"),
                   "leaves_per_wave": get("leaves"), "topk_recall": get("topk_recall"),
                   "dirichlet_alpha_scale": get("alpha_scale"),
                   "dirichlet_eps": get("dirichlet_eps"), "cpuct": get("cpuct"),
                   "virtual_loss": get("virtual_loss"), "max_depth": get("max_depth")},
        "selfplay": {"batch_size": get("selfplay_batch"), "temp_threshold": get("temp_threshold"),
                     "max_game_len": get("max_game_len"), "policy_k": get("policy_k"),
                     "replay_capacity": get("replay_capacity")},
        # The record's resignation, which the window only counts.
        "resign": {"threshold": record["reduced"]["resign"]["record"],
                   "min_moves": get("resign_min_moves")},
    }


def mcts_config(cfg: dict):
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig

    return MCTSConfig(**cfg["search"])


def fp8_reference(weights: dict, blocks: int):
    """The control's ``evaluate``: the reference net with an fp8 trunk, on
    the planes the search hands the program's net (NHWC)."""
    def evaluate(obs):
        return ref_net.forward(weights, obs.permute(0, 3, 1, 2).float(), blocks, "fp8")

    return evaluate


def build(cfg: dict, seed: int, device, control: bool = False):
    """The program under test, with the benchmark's weights. With
    ``control`` the search evaluates with the reference net with an fp8
    trunk (``reference/net.py``) in the program's net's place."""
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig

    net_cfg, sp = cfg["net"], cfg["selfplay"]
    env = make_env(cfg["preset"], device)
    shapes = ref_net.param_shapes(env.n, net_cfg["channels"], net_cfg["blocks"],
                                  net_cfg["value_hidden"])
    weights = ref_net.make_weights(shapes, harness.sub_seed(seed, "weights"), device)
    net = make_network(env.n, channels=net_cfg["channels"], blocks=net_cfg["blocks"],
                       norm=net_cfg["norm"], dtype=getattr(torch, net_cfg["trunk_dtype"]))
    net.load_state_dict(weights, strict=True)
    net = net.to(device).eval()
    evaluator = Evaluator(fp8_reference(weights, net_cfg["blocks"]) if control else net)
    spcfg = SelfPlayConfig(batch_size=sp["batch_size"], temp_threshold=sp["temp_threshold"],
                           max_game_len=sp["max_game_len"], policy_k=sp["policy_k"])
    actor = SelfPlayActor(env, evaluator, mcts_config(cfg), spcfg, device)
    return env, weights, evaluator, actor, spcfg


class Window:
    """The benchmark's mirror of ``SelfPlayActor.play``'s host loop, one
    move at a time, recording what the check needs."""

    def __init__(self, env, actor, evaluator, spcfg, replay, states, seed, traffic, device,
                 resign):
        from alphazeroforhnefatafl_tpu_torch.core.env import where_state

        self.where_state = where_state
        self.actor, self.evaluator, self.cfg = actor, evaluator, spcfg
        self.replay, self.states, self.device = replay, states, device
        B, n, K = spcfg.batch_size, env.n, spcfg.policy_k
        L = spcfg.max_game_len
        self.B = B
        self.fresh = env.reset_batch(B)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(harness.sub_seed(seed, "moves"))
        self.ply = states.turn.cpu().numpy().astype(np.int64)
        self.ep_board = np.zeros((B, L, n, n), np.int8)
        self.ep_side = np.zeros((B, L), np.int8)
        self.ep_reps = np.zeros((B, L), np.int8)
        self.ep_pidx = np.full((B, L, K), -1, np.int32)
        self.ep_pp = np.zeros((B, L, K), np.float32)
        self.ep_len = np.zeros((B,), np.int64)
        self.rows = np.arange(B)
        self.check_rows = set(harness.sample_rows(seed, "rules_rows", B,
                                                  traffic["check_rows"]).tolist())
        self.moves, self.adds, self.invalid = [], [], 0
        # The record's resignation, counted and not played: ``play``'s rule
        # of a mover's root value under -threshold on consecutive moves.
        self.resign = resign
        self.resign_streak = np.zeros((B, 2), np.int32)
        self.resign_fired = np.zeros((B,), bool)
        self.would_resign = self.games_ended = 0
        self.spans = {"move": [], "search": []}
        self.capture_at = {}
        self.captures = {}
        self.sync_spans = False
        self.annotate = False
        self._wrap_search()

    def _wrap_search(self):
        actor, spans, window = self.actor, self.spans, self
        inner = actor.mcts.search

        def search(root_state, root_legal, generator=None, add_noise=True):
            t0 = time.perf_counter()
            cap = window.capture_at.get(len(window.moves))
            gen_state = generator.get_state() if cap is not None else None
            if cap is not None:
                window.evaluator.rows = torch.as_tensor(cap["root_rows"], device=window.device)
            with (torch.profiler.record_function("bench/search") if window.annotate
                  else contextlib.nullcontext()):
                res = inner(root_state, root_legal, generator, add_noise)
                if window.sync_spans:
                    torch.cuda.synchronize(window.device) if window.device.type == "cuda" else None
            spans["search"].append((t0, time.perf_counter()))
            if cap is not None:
                window.captures[len(window.moves)] = _capture(
                    res, root_legal, window.evaluator, cap, gen_state)
            return res

        actor.mcts.search = search

    def move(self):
        """One move of every game and the host work of ``play`` around it."""
        cfg, B, dev = self.cfg, self.B, self.device
        t0 = time.perf_counter()
        with (torch.profiler.record_function("bench/move") if self.annotate
              else contextlib.nullcontext()):
            temps = torch.as_tensor((self.ply < cfg.temp_threshold).astype(np.float32),
                                    device=dev)
            s = self.states
            b_board = s.board.cpu().numpy()
            b_side = s.side_to_play.cpu().numpy().astype(np.int8)
            b_reps = s.reps.cpu().numpy()[self.rows, b_side].astype(np.int8)
            new, actions, info, top_a, top_p, root_v, fb = self.actor.move(s, temps,
                                                                          self.generator)
            fb.cpu()
            top_a_np, top_p_np = top_a.cpu().numpy(), top_p.cpu().numpy()
            root_v_np = root_v.cpu().numpy()
            actions_np = actions.cpu().numpy()
            post = _post_pack(new).cpu().numpy()
            self.invalid += int(info.invalid.sum())
            g, t = self.rows, self.ep_len
            self.ep_board[g, t] = b_board
            self.ep_side[g, t] = b_side
            self.ep_reps[g, t] = b_reps
            self.ep_pidx[g, t] = top_a_np
            self.ep_pp[g, t] = top_p_np
            self.ep_len += 1
            self.ply += 1
            done = post[:, 0] != 0
            ended = done | (self.ply >= cfg.max_game_len)
            side = b_side.astype(np.int64)
            streak = np.where(root_v_np < -self.resign["threshold"],
                              self.resign_streak[g, side] + 1, 0)
            self.resign_streak[g, side] = streak
            fire = ((streak >= cfg.resign_consecutive) & (self.ply >= self.resign["min_moves"])
                    & ~ended & ~self.resign_fired)
            self.resign_fired |= fire
            self.would_resign += int(fire.sum())
            self.games_ended += int(ended.sum())
            for r in np.nonzero(ended)[0]:
                length = int(self.ep_len[r])
                sides = self.ep_side[r, :length]
                res = int(post[r, 1])
                if done[r] and res in (0, 1):
                    z = np.where(sides == res, 1.0, -1.0).astype(np.float32)
                else:
                    z = np.zeros(length, np.float32)
                at = self.replay.write
                self.replay.add(self.ep_board[r, :length], sides, self.ep_reps[r, :length],
                                self.ep_pidx[r, :length], self.ep_pp[r, :length], z)
                if r in self.check_rows:
                    self.adds.append({"row": int(r), "move": len(self.moves), "at": at,
                                      "length": length})
            self.ep_len[ended] = 0
            self.resign_streak[ended] = 0
            self.resign_fired[ended] = False
            self.ply[ended] = 0
            if ended.any():
                new = self.where_state(torch.as_tensor(ended, device=dev), self.fresh, new)
            self.states = new
            self.moves.append({"board": b_board, "side": b_side, "actions": actions_np, "top_a": top_a_np,
                               "top_p": top_p_np, "root_v": root_v_np, "post": post,
                               "ended": ended})
        self.spans["move"].append((t0, time.perf_counter()))


@torch.inference_mode()
def _capture(res, root_legal, evaluator, cap, gen_state) -> dict:
    """What the check reads of one search, kept on the card until the
    window has closed: the root's logits and value and its legal mask for
    ``root_rows``, the whole tree for ``tree_rows``, and the generator's
    state before the search (the reference redraws the root noise)."""
    tr = torch.as_tensor(cap["tree_rows"], device=root_legal.device)
    rr = torch.as_tensor(cap["root_rows"], device=root_legal.device)
    t = res.tree
    tree = {f.name: getattr(t.state, f.name)[tr].clone() for f in dataclasses.fields(t.state)}
    for name in ("expanded", "terminal", "terminal_value", "child_action", "child_prior",
                 "child_N", "child_W", "child_node"):
        tree[name] = getattr(t, name)[tr].clone()
    logits, value = evaluator.kept
    return {"root_rows": cap["root_rows"], "tree_rows": cap["tree_rows"],
            "root_logits": logits, "root_value": value, "root_legal": root_legal[rr].clone(),
            "tree": tree, "gen_state": gen_state, "batch": int(root_legal.shape[0])}


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def run(ctx: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> dict:
    """One run of a self-play cell; returns the parts of the result line."""
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor

    cfg, traffic = derive(ctx["config"]), ctx["traffic"]
    device = torch.device(device)
    env, weights, evaluator, actor, spcfg = build(cfg, seed, device, control)
    B = spcfg.batch_size
    states, start_ply, choices = start_states(env, B, traffic["start_ply_max"], seed, device)
    start_fields = _state_fields(states)

    # Warm every shape of the window: one short search at the cell's batch,
    # leaves and children, on a copy of the start positions.
    search = cfg["search"]
    warm_cfg = dataclasses.replace(mcts_config(cfg),
                                   num_simulations=traffic["warm_waves"] * search["leaves_per_wave"])
    warm = SelfPlayActor(env, evaluator, warm_cfg, spcfg, device)
    wg = torch.Generator(device=device)
    wg.manual_seed(harness.sub_seed(seed, "warm"))
    temps = torch.ones((B,), device=device)
    out = warm.move(states, temps, wg)
    out[3].cpu()
    del warm, out

    replay = ReplayBuffer(env, cfg["selfplay"]["replay_capacity"], spcfg.policy_k)
    win = Window(env, actor, evaluator, spcfg, replay, states, seed, traffic, device,
                 cfg["resign"])
    check_rows = np.array(sorted(win.check_rows))
    for m in harness.sample_rows(seed, "capture_moves", traffic["capture_move_range"],
                                 traffic["capture_moves"]).tolist():
        win.capture_at[m] = {
            "root_rows": check_rows,
            "tree_rows": check_rows[harness.sample_rows(seed, f"tree_rows{m}", len(check_rows),
                                                        traffic["tree_rows"])],
        }
    win.sync_spans = trace
    # Without --trace the window is traced whole for the card's busy
    # seconds, in stretches of a few moves; the profiler starts once here.
    busy = None
    if not trace and device.type == "cuda":
        busy = harness.DeviceBusy(device, "tafl_step_kernel")
        with harness.DeviceBusy(device, "").stretch():
            torch.zeros((1,), device=device).add_(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    last_capture = max(win.capture_at)
    launches0 = step_arrays.launches
    closed = False
    while not closed:
        with busy.stretch() if busy else contextlib.nullcontext():
            for _ in range(traffic["busy_stretch_moves"]):
                win.move()
                t_end = time.perf_counter()
                if t_end - t0 >= seconds and len(win.moves) > last_capture:
                    closed = True
                    break
    window_s = t_end - t0
    moves = len(win.moves)
    launched = step_arrays.launches - launches0
    # The profiler loses some events: 0.1-1.1% of the step kernels on an
    # H100. A trace that lost more than 5% of them lost a buffer and reads
    # no busy time.
    if busy is not None and busy.kernel_events < 0.95 * launched:
        raise RuntimeError(f"the device trace holds {busy.kernel_events} step kernels of the "
                           f"{launched} launched: it dropped events")

    trace_out = None
    if trace:
        trace_out = _traced_moves(win, traffic, device, step_arrays, batched_legal_mask)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # The window has closed: free the program's state, then judge.
    rec = {
        "start_ply": start_ply, "choices": choices, "start": start_fields,
        "moves": win.moves, "adds": win.adds, "check_rows": check_rows,
        "captures": {m: _to_host(c) for m, c in win.captures.items()},
        "replay": {k: getattr(replay, k) for k in ("board", "side", "reps", "policy_idx",
                                                   "policy_p", "value")},
    }
    gen_states = {m: c["gen_state"] for m, c in win.captures.items()}
    spans, invalid = {k: v[:moves] for k, v in win.spans.items()}, win.invalid
    resign = {"would_resign": win.would_resign, "games_ended": win.games_ended}
    del win, actor, evaluator, states
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, extra = selfplay_check.check(rec, gen_states, weights, cfg, device)
    check_s = time.perf_counter() - t_check

    positions = moves * B
    # On the CPU the host is the device, busy the whole window; a traced
    # run's window is not traced, and its busy seconds are not read.
    busy_s = busy.busy_s if busy is not None else None if trace else window_s
    run_info = {
        "cell": ctx["name"], "config": cfg, "traffic": traffic, "chips": 1,
        "positions": positions, "moves": moves, "window_s": window_s,
        "spans": spans,
        "evals_per_position": search["num_simulations"] + 1,
        "waves_per_move": search["num_simulations"] // search["leaves_per_wave"],
        "flops_per_eval": harness.net_flops_per_eval(
            env.n, 6, cfg["net"]["channels"], cfg["net"]["blocks"], cfg["net"]["value_hidden"]),
        "n": env.n, "num_actions": env.num_actions,
        "trace": trace_out,
    }
    return {
        "setup_s": setup_s, "window_s": window_s, "positions": positions, "moves": moves,
        "attempted": positions, "failed": invalid,
        "memory_peak_bytes": int(memory_peak), "checks": checks, "check_extra": extra,
        "check_s": check_s, "resign": resign, "busy_s": busy_s,
        "traced_events": busy.events if busy is not None else 0,
        "step_kernels": (busy.kernel_events if busy is not None else 0, launched),
        "run": run_info,
        "e2e": {"selfplay_positions_per_device_s": positions / busy_s if busy_s else None,
                "setup_s": setup_s},
    }


def _traced_moves(win, traffic, device, step_arrays, batched_legal_mask) -> dict:
    """Moves for ``traffic["trace_seconds"]`` more (one at least) under
    ``torch.profiler``, in a
    host region the trace reader finds; the device events in it, the host
    spans, and the rows the two kernels were called on meanwhile."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    rows0 = {"step": dict(step_arrays.batches), "mask": dict(batched_legal_mask.batches)}
    win.annotate = True
    first = len(win.moves)
    with profile(activities=acts) as prof:
        with record_function("bench/traced"):
            t0 = time.perf_counter()
            while len(win.moves) == first or time.perf_counter() - t0 < traffic["trace_seconds"]:
                win.move()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    win.annotate = False

    def rows(now, before):
        return sum(b * (c - before.get(b, 0)) for b, c in now.items())

    kernel_rows = {"step": rows(step_arrays.batches, rows0["step"]),
                   "mask": rows(batched_legal_mask.batches, rows0["mask"])}
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out = harness.read_trace(path, "bench/traced")
    finally:
        os.remove(path)
    out["kernel_rows"] = kernel_rows
    out["moves"] = len(win.moves) - first
    out["spans"] = {k: v[first:] for k, v in win.spans.items()}
    return out
