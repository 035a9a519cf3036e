"""The SE kernel's share of its roofline in the traced moves: the bytes its
launches must move (``se_arith.se_block_bytes``: each row's input, skip and
output once, each launch's weights once) at the HBM's peak, over its device
time (``tafl_se_block_kernel``). Rows and launches come from the program's
counters (``se_block.batches``); a program without the kernel reads
nothing."""

import se_arith


def read(run):
    t, peak = run["trace"], run["peak"]
    if t is None or peak is None:
        return None
    rows = t["kernel_rows"].get("se_block", 0)
    launches = t.get("kernel_launches", {}).get("se_block", 0)
    secs = sum(d[3] - d[2] for d in t["device"] if "tafl_se_block_kernel" in d[0]) / 1e6
    if secs <= 0 or rows <= 0:
        return None
    net = run["config"]["net"]
    nbytes = se_arith.se_block_bytes(rows, launches, run["n"], net["channels"], net["se_ratio"])
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / secs
