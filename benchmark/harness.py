"""What every cell shares: finding a cell's files by name, seeds, the card
check, the result line, and the frozen arithmetic the metrics use (peaks,
FLOPs of an evaluation, the union of device intervals, op families).

A cell is an entry of ``workloads`` in the root ``BENCHMARK.json``. Its
configuration is the file that entry's ``config`` names there; its traffic
mix is ``traffic/<traffic>.json``, whose ``kind`` names the runner
``kinds/<kind>.py``; each per-layer metric is ``metrics/<name>.py``. A
later cell, configuration, mix or metric is added as files and entries,
without editing any file here.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: Modules that may not be loaded in the process that prints a result,
#: compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "alphazeroforhnefatafl_tpu")


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json", bench: Path = BENCH) -> dict:
    """Everything one cell needs, found by name: its entry, configuration,
    traffic mix (under ``bench``), its kind's runner and the metrics it
    reports."""
    spec = load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {spec_path.name}: {sorted(cells)}")
    cell = cells[name]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    return {
        "name": name,
        "cell": cell,
        "config": load_json(spec_path.parent / config_entry["file"]),
        "traffic": traffic,
        "runner": importlib.import_module(f"kinds.{traffic['kind']}"),
        "end_to_end": [m for m in spec["end_to_end"] if metric_applies(m, name)],
        "per_layer": [m for m in spec["per_layer"] if metric_applies(m, name)],
    }


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one use (``label``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{seed}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def sample_rows(seed: int, label: str, population: int, k: int):
    """``k`` distinct sorted indices of ``range(population)`` from the seed."""
    import numpy as np

    rng = np.random.default_rng(sub_seed(seed, label))
    return np.sort(rng.choice(population, size=min(k, population), replace=False))


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("CUDA is not available")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ----------------------------------------------------------------------------
# The frozen arithmetic
# ----------------------------------------------------------------------------

def peaks(kind: str):
    """The published peaks of the card named ``kind`` (``peaks.json``), or
    None for a card the table does not hold."""
    for entry in load_json(BENCH / "peaks.json")["cards"]:
        if re.search(entry["match"], kind):
            return entry
    return None


def net_flops_per_eval(n: int, in_planes: int, channels: int, blocks: int,
                       value_hidden: int) -> float:
    """Analytic forward FLOPs of one evaluation of the policy/value net
    (multiply-adds x 2 of its convolutions and dense layers; norms and
    elementwise work are left out)."""
    nn2 = n * n

    def conv(cin, cout, k):
        return 2.0 * nn2 * cin * cout * k * k

    f = conv(in_planes, channels, 3)
    f += blocks * 2 * conv(channels, channels, 3)
    f += conv(channels, channels, 3)
    f += conv(channels, 4 * (n - 1), 1)
    f += conv(channels, 8, 1)
    f += 2.0 * (nn2 * 8) * value_hidden + 2.0 * value_hidden
    return f


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` (microseconds) covered by the union of the
    ``(start, end)`` intervals."""
    covered, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            covered += end - start
            reach = end
    return covered / 1e6


class DeviceBusy:
    """The card's busy seconds over stretches of work, from ``torch.profiler``'s
    device trace: the union of the card's kernels, copies and sets, summed
    over the stretches. Each stretch is traced on its own, so that no trace
    outgrows the profiler's buffers, and ``kernel``'s traced events are
    counted so that a trace that dropped events can be told."""

    def __init__(self, device, kernel: str):
        self.device, self.kernel = device, kernel
        self.busy_s, self.events, self.kernel_events = 0.0, 0, 0

    @contextlib.contextmanager
    def stretch(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch._C._autograd.DeviceType.CUDA
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize(self.device)
        intervals = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            start = e.start_ns() / 1e3
            intervals.append((start, start + e.duration_ns() / 1e3))
            self.kernel_events += self.kernel in e.name()
        self.events += len(intervals)
        if intervals:
            self.busy_s += union_seconds(intervals, min(s for s, _ in intervals),
                                         max(e for _, e in intervals))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# Ordered: the first pattern that matches names the family.
FAMILIES = (
    (r"tafl_step_kernel|tafl_legal_mask_kernel", "ported-kernel"),
    (r"nchwtonhwc|nhwctonchw", "layout nchw/nhwc"),
    (r"fprop|dgrad|wgrad|conv|winograd|implicit_gemm|implicit_convolve", "conv"),
    (r"gemm|gemv|cublas|cutlass|matmul|xmma", "gemm"),
    (r"group_?norm|rowwisemoments|computefusedparams", "groupnorm"),
    (r"distribution|philox|curand|random|gamma|dirichlet|\brand", "rng"),
    (r"sort|radix|topk|top_k|bitonic|segmented", "sort/topk"),
    (r"index_put|reduceadd|reducemultiply|reducemean|reducemaximum|reduceminimum|scatter_add",
     "scatter"),
    (r"index_kernel|index_elementwise|indexselect|index_select|gather", "gather/index"),
    (r"reduce|argmax|argmin|\bsum\b", "reduce"),
    (r"copy|memcpy|memset|catarray|fill", "copy/cast/fill"),
    (r"where|elementwise|vectorized|unrolled|pointwise|binary|unary|compare|clamp|"
     r"mul|add|div|sub|relu|tanh|softmax", "where/elementwise"),
)
_FAMILY_RES = tuple((re.compile(p), f) for p, f in FAMILIES)


def family(name: str, cat: str = "kernel") -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/cast/fill"
    low = name.lower()
    for pat, fam in _FAMILY_RES:
        if pat.search(low):
            return fam
    return "other"


def read_trace(path: Path, region: str) -> dict:
    """The device events of a Chrome trace that fall in the host region
    named ``region`` (the last one), with the host spans beside them:
    ``{"window": (lo, hi), "device": [(name, cat, start, end)],
    "host": [(name, start, end)]}``, in microseconds."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    window, device, host = None, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((e.get("name", "?"), cat, start, end))
        elif cat == "user_annotation":
            if e.get("name") == region:
                window = (start, end)
            host.append((e.get("name", "?"), start, end))
    if window is None:
        raise ValueError(f"no host region {region!r} in the trace")
    lo, hi = window
    device = [d for d in device if d[3] > lo and d[2] < hi]
    return {"window": window, "device": device, "host": host}


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device's op families by seconds, and the longest idle gaps of
    the card in the window labelled by the innermost benchmark span the
    host was in at the gap's middle."""
    lo, hi = trace["window"]
    fam = {}
    for name, cat, s, e in trace["device"]:
        f = family(name, cat)
        fam[f] = fam.get(f, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
    ops = sorted(fam.items(), key=lambda kv: -kv[1])[:top]
    gaps, reach = [], lo
    for _, _, s, e in sorted(trace["device"], key=lambda d: d[2]):
        if s > reach:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, e)
    if reach < hi:
        gaps.append((reach, hi))
    spans = [h for h in trace["host"] if h[0] != "bench/traced"]
    by_label = {}
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [h for h in spans if h[1] <= mid <= h[2]]
        label = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "outside any span"
        by_label.setdefault(label, []).append((e - s) / 1e6)
    longest = sorted(((label, max(v)) for label, v in by_label.items()), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in longest[:top]]}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown_: dict = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = checks
    return json.dumps(out)
