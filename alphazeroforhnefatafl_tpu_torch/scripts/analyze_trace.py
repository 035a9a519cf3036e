"""Summarize a ``torch.profiler`` Chrome trace: the card's time by op family.

The counterpart of the root ``scripts/analyze_trace.py``. Pairs with
``scripts.profile_wave``, which writes ``*.pt.trace.json`` under its
``--trace-dir``: this reads the newest one there and groups the card's
events (Chrome-trace categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``, on tracks whose process or thread name matches
``--track-regex``) by a coarse op-family key, so a search's cost is one
table. Prints the same three tables as the JAX script (tracks, op families,
top ops), then the kernels no family names, and, when the trace holds
profile_wave's search region, the share of that region's host window in
which the card was busy: the union of the device events' intervals, not
their sum, and the card's idle time there put down to the innermost host
span (``mcts/traverse``, ``mcts/level_sync``, ...) the host was in at each
idle gap's middle. A trace with no device events (one taken on the CPU) is
reported as such::

    python -m alphazeroforhnefatafl_tpu_torch.scripts.analyze_trace trace [--top 40]
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import re
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The host region ``scripts.profile_wave`` puts around its traced search.
SEARCH_REGION = "profile_wave/search"

# Ordered: the first pattern that matches names the family. The port's own
# kernels come first; the layout conversions before the convolutions (a
# cuDNN convolution's name holds "nhwc" too); random draws before
# elementwise (their kernels are elementwise kernels); index_put (a write)
# before the index reads.
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
_FAMILY_RES = tuple((re.compile(pat), fam) for pat, fam in FAMILIES)


def family(name: str, cat: str = "kernel") -> str:
    """Coarse op-family key of a device event's name (and category: every
    memcpy and memset is a copy)."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/cast/fill"
    n = name.lower()
    for pat, fam in _FAMILY_RES:
        if pat.search(n):
            return fam
    return "other"


def find_trace(root: str) -> str:
    """The newest ``*.pt.trace.json`` (or ``.json.gz``) under ``root``."""
    hits = [
        os.path.join(dirpath, f)
        for dirpath, _, files in os.walk(root)
        for f in files
        if f.endswith((".pt.trace.json", ".pt.trace.json.gz"))
    ]
    if not hits:
        raise FileNotFoundError(f"no *.pt.trace.json under {root}")
    return max(hits, key=os.path.getmtime)


def load_events(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union_ms(intervals, lo: float, hi: float) -> float:
    """Milliseconds of ``[lo, hi]`` (microseconds) that the union of the
    ``(start, end)`` intervals covers."""
    covered, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            covered += end - start
            reach = end
    return covered / 1e3


def idle_by_span(intervals, spans, lo: float, hi: float):
    """The card's idle gaps in ``[lo, hi]`` (the complement of the union of
    the device ``intervals``), each put down to the innermost of the host
    ``spans`` (``(name, start, end)``, nested as one thread opens them) that
    holds the gap's middle, or to ``"outside any span"``: ``{label: (ms,
    gaps)}``, the most idle label first."""
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach and reach < hi:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
    if reach < hi:
        gaps.append((reach, hi))
    spans = sorted(spans, key=lambda h: (h[1], -h[2]))
    out, open_, k = {}, [], 0
    for start, end in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (start + end) / 2
        while k < len(spans) and spans[k][1] <= mid:
            while open_ and open_[-1][2] < spans[k][1]:
                open_.pop()
            open_.append(spans[k])
            k += 1
        while open_ and open_[-1][2] < mid:
            open_.pop()
        label = open_[-1][0] if open_ else "outside any span"
        ms, n = out.get(label, (0.0, 0))
        out[label] = (ms + (end - start) / 1e3, n + 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def analyze(events, track_regex: str, region: str = SEARCH_REGION) -> dict:
    """Device time (ms) by track, family and op name, with the op counts;
    the names that fall into ``other``; and, when the trace holds a host
    ``region``, its window, the card's busy time and share within it, and
    its idle time by the innermost host span (:func:`idle_by_span`)."""
    proc, thread = {}, {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                proc[e.get("pid")] = str(e.get("args", {}).get("name", ""))
            elif e.get("name") == "thread_name":
                thread[(e.get("pid"), e.get("tid"))] = str(e.get("args", {}).get("name", ""))
    track_re = re.compile(track_regex, re.I)

    by_track, by_fam, by_name = (collections.Counter() for _ in range(3))
    count_name, other = collections.Counter(), collections.Counter()
    intervals, window, off_track, spans = [], None, 0, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation":
            start = float(e["ts"])
            if e.get("name") == region:
                window = (start, start + float(e["dur"]))
            else:
                spans.append((e.get("name", "?"), start, start + float(e["dur"])))
        if cat not in DEVICE_CATS:
            continue
        p_name = proc.get(e.get("pid"), "?")
        t_name = thread.get((e.get("pid"), e.get("tid")), "?")
        if not (track_re.search(p_name) or track_re.search(t_name)):
            off_track += 1
            continue
        dur, name = float(e["dur"]), e.get("name", "?")
        fam = family(name, cat)
        by_track[f"{p_name}/{t_name}"] += dur
        by_fam[fam] += dur
        by_name[name] += dur
        count_name[name] += 1
        if fam == "other":
            other[name] += dur
        intervals.append((float(e["ts"]), float(e["ts"]) + dur))

    out = {
        "device_events": len(intervals),
        "off_track_device_events": off_track,
        "total_ms": sum(by_fam.values()) / 1e3,
        "tracks": {k: v / 1e3 for k, v in by_track.most_common()},
        "families": {k: v / 1e3 for k, v in by_fam.most_common()},
        "ops": {k: v / 1e3 for k, v in by_name.most_common()},
        "op_counts": dict(count_name),
        "other": {k: v / 1e3 for k, v in other.most_common()},
        "window_ms": None,
        "busy_ms": None,
        "busy_share": None,
        "idle_by_span": None,
    }
    if window is not None:
        lo, hi = window
        busy = union_ms(intervals, lo, hi)
        out.update(window_ms=(hi - lo) / 1e3, busy_ms=busy,
                   busy_share=busy / ((hi - lo) / 1e3) if hi > lo else None,
                   idle_by_span=idle_by_span(intervals, spans, lo, hi))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="analyze_trace")
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument(
        "--track-regex",
        default="GPU|stream",
        help="process/thread name filter for device tracks",
    )
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    a = ap.parse_args(argv)

    path = find_trace(a.trace_dir)
    s = analyze(load_events(path), a.track_regex)
    print(f"trace: {path}")
    if not s["device_events"]:
        print("no device events in the trace"
              + (f" on tracks matching {a.track_regex!r} ({s['off_track_device_events']} "
                 "on other tracks)" if s["off_track_device_events"] else
                 " (taken without a card?)"))
        return 0
    total = s["total_ms"]
    print(f"device-track total: {total:.1f} ms\n")
    print("== tracks ==")
    for t, d in list(s["tracks"].items())[:8]:
        print(f"{d:10.1f} ms  {t}")
    print("\n== by op family ==")
    for fam, d in s["families"].items():
        print(f"{d:10.1f} ms  {100 * d / total:5.1f}%  {fam}")
    print(f"\n== top {a.top} ops ==")
    for name, d in list(s["ops"].items())[: a.top]:
        print(f"{d:10.1f} ms  {100 * d / total:5.1f}%  x{s['op_counts'][name]:<6} {name[:110]}")
    if s["other"]:
        print("\n== in no family (other) ==")
        for name, d in s["other"].items():
            print(f"{d:10.3f} ms  x{s['op_counts'][name]:<6} {name[:160]}")
    if s["window_ms"] is not None:
        print(f"\n{SEARCH_REGION}: host window {s['window_ms']:.1f} ms, card busy "
              f"{s['busy_ms']:.1f} ms of it ({100 * s['busy_share']:.1f}%; the union of "
              "the device events, not their sum)")
        idle = s["window_ms"] - s["busy_ms"]
        print(f"\n== card idle in {SEARCH_REGION} by innermost host span ==")
        for label, (ms, gaps) in list(s["idle_by_span"].items())[: a.top]:
            share = 100 * ms / idle if idle > 0 else 0.0
            print(f"{ms:10.3f} ms  {share:5.1f}%  x{gaps:<6} {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
