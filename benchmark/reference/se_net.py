"""Plain float32 reference of the squeeze-excitation residual net, and its
fp8 control.

The net of ``configs/copenhagen_se_resnet_20x256.json``: Leela Chess Zero's
SE residual block (``residual_block`` and ``squeeze_excitation`` of
lczero-training's ``tf/tfprocess.py``) at AlphaZero's 256 channels
(arXiv:1712.01815), with batch norm by its running statistics (the net
evaluating, as self-play does), epsilon 1e-5:

    y1  = relu(BN0(conv3x3(x)))                 no bias in the convolutions
    y2  = BN1(conv3x3(y1))
    s   = mean of y2 over the N x N cells       [C]
    h   = relu(W1 s + b1)                       C -> C / se_ratio
    g   = W2 h + b2                             -> 2C = (gamma, beta)
    out = relu(x + sigmoid(gamma) * y2 + beta)

after a stem (3x3 conv, BN, ReLU), and the heads of ``net.py`` with BN in
place of GroupNorm (policy: 3x3 conv, BN, ReLU, 1x1 conv to ``4 (N - 1)``
move planes; value: 1x1 conv to 8 planes, ReLU, dense ``value_hidden``,
ReLU, dense 1, tanh). Both norms of a block learn a scale.

Written from that description with plain ``torch`` operations: it imports
nothing of the program. ``precision`` rounds every trunk convolution's
input and weight as ``net.py``'s does (``bf16``, the configuration's trunk;
``fp8``, the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .net import ROUNDING, masked_priors, planes  # noqa: F401  (the check reads masked_priors here)

BN_EPS = 1e-5
NORM_KEYS = ("weight", "bias", "running_mean", "running_var")


def param_shapes(n: int, channels: int, blocks: int, value_hidden: int, se_ratio: int) -> dict:
    """Every parameter and running statistic of the net by name, in a fixed
    order."""
    c, h = channels, channels // se_ratio

    def norm(name):
        return {f"{name}.{k}": (c,) for k in NORM_KEYS}

    shapes = {"stem.weight": (c, 6, 3, 3), **norm("stem_bn")}
    for b in range(blocks):
        p = f"blocks.{b}."
        shapes.update({p + "conv0.weight": (c, c, 3, 3), **norm(p + "bn0"),
                       p + "conv1.weight": (c, c, 3, 3), **norm(p + "bn1"),
                       p + "se_fc1.weight": (h, c), p + "se_fc1.bias": (h,),
                       p + "se_fc2.weight": (2 * c, h), p + "se_fc2.bias": (2 * c,)})
    shapes.update({
        "policy_conv.weight": (c, c, 3, 3), **norm("policy_bn"),
        "policy_out.weight": (4 * (n - 1), c, 1, 1), "policy_out.bias": (4 * (n - 1),),
        "value_conv.weight": (8, c, 1, 1), "value_conv.bias": (8,),
        "value_fc.weight": (value_hidden, 8 * n * n), "value_fc.bias": (value_hidden,),
        "value_out.weight": (1, value_hidden), "value_out.bias": (1,),
    })
    return shapes


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Float32 weights from ``seed``, drawn on ``device`` in one call:
    LeCun-normal kernels, biases of scale 0.1, norm scales 1 + 0.1 z and
    offsets 0.1 z, running means 0.1 z and running variances exp(0.3 z)
    (0.55-1.8 at two sigma), so that the norms' inference affine counts."""
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
        elif name.endswith("running_var"):
            w = torch.exp(0.3 * w)
        elif "bn" in name and name.endswith(".weight"):
            w = 1.0 + 0.1 * w
        else:
            w = 0.1 * w
        out[name] = w.contiguous()
    return out


def _bn(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    scale = w[name + ".weight"] / torch.sqrt(w[name + ".running_var"] + BN_EPS)
    shift = w[name + ".bias"] - w[name + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def forward(w: dict, x: torch.Tensor, blocks: int, precision: str = "f32"):
    """``(logits f32[B, A], value f32[B])`` of planes ``x f32[B, 6, N, N]``;
    ``precision`` rounds every trunk convolution's input and weight (``f32``
    leaves them)."""
    q = ROUNDING[precision]

    def conv(x, name, bias=None, trunk=True):
        wt = w[name]
        if trunk:
            x, wt = q(x), q(wt)
        return F.conv2d(x, wt, bias, padding=wt.shape[-1] // 2)

    B = x.shape[0]
    x = F.relu(_bn(w, "stem_bn", conv(x, "stem.weight")))
    for b in range(blocks):
        p = f"blocks.{b}."
        y = F.relu(_bn(w, p + "bn0", conv(x, p + "conv0.weight")))
        y = _bn(w, p + "bn1", conv(y, p + "conv1.weight"))
        h = F.relu(F.linear(y.mean((2, 3)), w[p + "se_fc1.weight"], w[p + "se_fc1.bias"]))
        gamma, beta = F.linear(h, w[p + "se_fc2.weight"], w[p + "se_fc2.bias"]).chunk(2, dim=1)
        x = F.relu(x + torch.sigmoid(gamma)[:, :, None, None] * y + beta[:, :, None, None])
    x = q(x)
    p = F.relu(_bn(w, "policy_bn", conv(x, "policy_conv.weight")))
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
    import numpy as np

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
