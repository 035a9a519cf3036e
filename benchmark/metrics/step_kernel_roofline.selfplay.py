"""The env step kernel's share of its roofline in the traced moves: the
bytes its calls must move at the HBM's peak, over its device time. Bytes
a row: the inputs read once (board N*N, side 4, action 4, the repetition
ring 16, its index 4, the counts 8, the pairs 2, plays since a capture 4)
and the outputs written once (board and captures 2 N*N, the next legal
mask A, 24 scalars of 4). Rows come from the program's launch counter."""


def read(run):
    t, peak = run["trace"], run["peak"]
    if t is None or peak is None:
        return None
    secs = sum(d[3] - d[2] for d in t["device"] if "tafl_step_kernel" in d[0]) / 1e6
    rows = t["kernel_rows"]["step"]
    if secs <= 0 or rows <= 0:
        return None
    n, a = run["n"], run["num_actions"]
    per_row = (n * n + 42) + (2 * n * n + a + 96)
    return 100.0 * rows * per_row / peak["hbm_bytes_per_s"] / secs
