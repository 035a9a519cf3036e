"""The legal mask kernel's share of its roofline in the traced moves: the
bytes its calls must move at the HBM's peak (a row: the board N*N and the
side 4 read once, the mask A written once), over its device time. Rows
come from the program's launch counter."""


def read(run):
    t, peak = run["trace"], run["peak"]
    if t is None or peak is None:
        return None
    secs = sum(d[3] - d[2] for d in t["device"] if "tafl_legal_mask_kernel" in d[0]) / 1e6
    rows = t["kernel_rows"]["mask"]
    if secs <= 0 or rows <= 0:
        return None
    per_row = run["n"] ** 2 + 4 + run["num_actions"]
    return 100.0 * rows * per_row / peak["hbm_bytes_per_s"] / secs
