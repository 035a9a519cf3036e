"""Plain float32 reference of the policy/value net, and its fp8 control.

The net of the benchmark's configurations (``configs/*.json``, key ``net``):
a 3x3 stem, ``blocks`` residual blocks of two 3x3 convolutions each with
GroupNorm (``min(32, channels)`` groups, epsilon 1e-6), a policy head (3x3
conv, GroupNorm, ReLU, 1x1 conv to ``4 (N - 1)`` move planes, flattened cell
by cell, then direction, then distance) and a value head (1x1 conv to 8
planes, ReLU, dense to ``value_hidden``, ReLU, dense to 1, tanh). Inputs are
six planes: attacker, defender or king, king, throne or corner, side to
move, and the mover's repetition count over 3.

Written from that description with plain ``torch`` operations: it imports
nothing of the program. ``precision="bf16"`` rounds every trunk
convolution's input and weight to bfloat16, the precision the
configurations state for the trunk, and computes in float32 otherwise: its
distance from the float32 net is the scale of a sound bf16 net's error on
a given seed's weights. ``precision="fp8"`` is the control: the same with
float8 e4m3 by a per-tensor scale.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

GN_EPS = 1e-6
CELL_ATT, CELL_DEF, CELL_KING = 1, 2, 3
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def param_shapes(n: int, channels: int, blocks: int, value_hidden: int) -> dict:
    """Every parameter of the net by name, in a fixed order."""
    c = channels
    shapes = {"stem.weight": (c, 6, 3, 3), "stem_gn.weight": (c,), "stem_gn.bias": (c,)}
    for b in range(blocks):
        for i in (0, 1):
            shapes[f"blocks.{b}.conv{i}.weight"] = (c, c, 3, 3)
            shapes[f"blocks.{b}.gn{i}.weight"] = (c,)
            shapes[f"blocks.{b}.gn{i}.bias"] = (c,)
    shapes.update({
        "policy_conv.weight": (c, c, 3, 3),
        "policy_gn.weight": (c,),
        "policy_gn.bias": (c,),
        "policy_out.weight": (4 * (n - 1), c, 1, 1),
        "policy_out.bias": (4 * (n - 1),),
        "value_conv.weight": (8, c, 1, 1),
        "value_conv.bias": (8,),
        "value_fc.weight": (value_hidden, 8 * n * n),
        "value_fc.bias": (value_hidden,),
        "value_out.weight": (1, value_hidden),
        "value_out.bias": (1,),
    })
    return shapes


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Float32 weights from ``seed``, drawn on ``device`` in one call:
    LeCun-normal kernels, biases of scale 0.1, GroupNorm scales 1 + 0.1 z
    and offsets 0.1 z (random, so that a fault in either shows)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        w = z[at:at + k].view(shape)
        at += k
        if len(shape) > 1:
            w = w * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif "gn" in name and name.endswith(".weight"):
            w = 1.0 + 0.1 * w
        else:
            w = 0.1 * w
        out[name] = w.contiguous()
    return out


def special_plane(n: int) -> np.ndarray:
    p = np.zeros((n, n), np.float32)
    for r, c in ((n // 2, n // 2), (0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1)):
        p[r, c] = 1.0
    return p


def planes(board: np.ndarray, side: np.ndarray, reps_mover: np.ndarray) -> np.ndarray:
    """``f32[B, 6, N, N]`` input planes of boards ``i8[B, N, N]``, sides to
    move ``[B]`` and the mover's repetition counts ``[B]``."""
    B, n = board.shape[0], board.shape[1]
    out = np.zeros((B, 6, n, n), np.float32)
    out[:, 0] = board == CELL_ATT
    out[:, 1] = (board == CELL_DEF) | (board == CELL_KING)
    out[:, 2] = board == CELL_KING
    out[:, 3] = special_plane(n)
    out[:, 4] = np.asarray(side, np.float32)[:, None, None]
    out[:, 5] = (np.asarray(reps_mover, np.float32) / 3.0)[:, None, None]
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


ROUNDING = {"f32": lambda t: t, "bf16": _bf16, "fp8": _fp8}


def forward(w: dict, x: torch.Tensor, blocks: int, precision: str = "f32"):
    """``(logits f32[B, A], value f32[B])`` of planes ``x f32[B, 6, N, N]``;
    ``precision`` rounds every trunk convolution's input and weight (``f32``
    leaves them)."""
    q = ROUNDING[precision]
    groups = min(32, w["stem.weight"].shape[0])

    def conv(x, name, bias=None, trunk=True):
        wt = w[name]
        if trunk:
            x, wt = q(x), q(wt)
        return F.conv2d(x, wt, bias, padding=wt.shape[-1] // 2)

    def gn(x, name):
        return F.group_norm(x, groups, w[name + ".weight"], w[name + ".bias"], GN_EPS)

    B, n = x.shape[0], x.shape[-1]
    x = F.relu(gn(conv(x, "stem.weight"), "stem_gn"))
    for b in range(blocks):
        y = F.relu(gn(conv(x, f"blocks.{b}.conv0.weight"), f"blocks.{b}.gn0"))
        y = gn(conv(y, f"blocks.{b}.conv1.weight"), f"blocks.{b}.gn1")
        x = F.relu(x + y)
    x = q(x)
    p = F.relu(gn(conv(x, "policy_conv.weight"), "policy_gn"))
    p = conv(p, "policy_out.weight", w["policy_out.bias"], trunk=False)
    logits = p.permute(0, 2, 3, 1).reshape(B, -1)
    v = F.relu(conv(x, "value_conv.weight", w["value_conv.bias"], trunk=False))
    v = v.permute(0, 2, 3, 1).reshape(B, -1)
    v = F.relu(F.linear(v, w["value_fc.weight"], w["value_fc.bias"]))
    v = F.linear(v, w["value_out.weight"], w["value_out.bias"])
    return logits, torch.tanh(v)[:, 0]


@torch.no_grad()
def evaluate(w: dict, blocks: int, board, side, reps_mover, precision="f32", rows=1024):
    """Logits and values as float64 numpy arrays, in blocks of ``rows``,
    with TF32 off so that float32 means float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = next(iter(w.values())).device
    x = planes(board, side, reps_mover)
    logits, values = [], []
    for i in range(0, x.shape[0], rows):
        lo, va = forward(w, torch.as_tensor(x[i:i + rows], device=dev), blocks, precision)
        logits.append(lo.double().cpu().numpy())
        values.append(va.double().cpu().numpy())
    if not logits:
        return np.zeros((0, 0)), np.zeros((0,))
    return np.concatenate(logits), np.concatenate(values)


def masked_priors(logits: np.ndarray, legal: np.ndarray) -> np.ndarray:
    """Softmax over the legal actions (float64); uniform where the legal
    logits underflow, zero elsewhere."""
    z = np.where(legal, logits, -np.inf)
    top = np.max(z, axis=-1, keepdims=True)
    top = np.where(np.isfinite(top), top, 0.0)
    e = np.where(legal, np.exp(z - top), 0.0)
    s = e.sum(-1, keepdims=True)
    n_legal = np.maximum(legal.sum(-1, keepdims=True), 1)
    return np.where(s > 0, e / np.where(s > 0, s, 1.0), legal / n_legal)
