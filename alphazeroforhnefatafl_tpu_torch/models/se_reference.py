"""Plain float32 reference of the squeeze-excitation residual net
(``PolicyValueNet`` with ``norm="batch"``), its forward pass and its loss.

Written from the architecture's description with plain ``torch``
operations; it imports no kernel and nothing of the port, and it sets TF32
off so that float32 means float32 on a card. Leela Chess Zero's block
(``residual_block`` and ``squeeze_excitation`` of lczero-training's
``tf/tfprocess.py``), at any width and depth:

    y1  = relu(BN0(conv3x3(x)))                 no bias in the convolutions
    y2  = BN1(conv3x3(y1))
    s   = mean of y2 over the N x N cells       [C]
    h   = relu(W1 s + b1)                       C -> C / se_ratio
    g   = W2 h + b2                             -> 2C = (gamma, beta)
    out = relu(x + sigmoid(gamma) * y2 + beta)

Departures from Lc0, as the port makes them: both norms of a block learn a
scale (Lc0 fixes the first one's at 1); the stem (3x3 conv, BN, ReLU) and
the heads are the port's (policy: 3x3 conv, BN, ReLU, 1x1 conv to
``4 (N - 1)`` move planes flattened cell by cell; value: 1x1 conv to 8
planes, ReLU, dense ``value_hidden``, ReLU, dense 1, tanh). BN's epsilon
is 1e-5 and its momentum 0.1. In training mode BN normalises by the batch's
statistics (the variance biased, as it divides; the running update takes
the unbiased one); in inference mode by the running statistics.

``weights`` is a dict of float32 tensors under the net's ``state_dict``
names. ``trunk`` optionally rounds every trunk convolution's input and
weight (to show what a lower precision does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def _norm(w, name, x, training, stats):
    if training:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        if stats is not None:
            n = x.numel() // x.shape[1]
            stats[name] = (mean.detach(), var.detach() * n / (n - 1))
    else:
        mean, var = w[name + ".running_mean"], w[name + ".running_var"]
    scale = w[name + ".weight"] / torch.sqrt(var + EPS)
    return (x - mean[:, None, None]) * scale[:, None, None] + w[name + ".bias"][:, None, None]


def forward(w: dict, obs: torch.Tensor, blocks: int, training: bool = False, trunk=None,
            stats: dict = None):
    """``(logits f32[B, A], value f32[B])`` of planes ``obs f32[B, N, N, 6]``.
    In training mode ``stats``, where given, receives each norm's batch
    mean and unbiased variance by name (what the running statistics move
    towards)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = trunk or (lambda t: t)

    def conv(x, name, bias=None, rounded=True):
        wt = w[name]
        if rounded:
            x, wt = q(x), q(wt)
        return F.conv2d(x, wt, bias, padding=wt.shape[-1] // 2)

    def norm(x, name):
        return _norm(w, name, x, training, stats)

    B = obs.shape[0]
    x = obs.permute(0, 3, 1, 2).float()
    x = F.relu(norm(conv(x, "stem.weight"), "stem_bn"))
    for b in range(blocks):
        p = f"blocks.{b}."
        y = F.relu(norm(conv(x, p + "conv0.weight"), p + "bn0"))
        y = norm(conv(y, p + "conv1.weight"), p + "bn1")
        h = F.relu(F.linear(y.mean((2, 3)), w[p + "se_fc1.weight"], w[p + "se_fc1.bias"]))
        gamma, beta = F.linear(h, w[p + "se_fc2.weight"], w[p + "se_fc2.bias"]).chunk(2, dim=1)
        x = F.relu(x + torch.sigmoid(gamma)[:, :, None, None] * y + beta[:, :, None, None])
    x = q(x)
    p = F.relu(norm(conv(x, "policy_conv.weight"), "policy_bn"))
    p = conv(p, "policy_out.weight", w["policy_out.bias"], rounded=False)
    logits = p.permute(0, 2, 3, 1).reshape(B, -1)
    v = F.relu(conv(x, "value_conv.weight", w["value_conv.bias"], rounded=False))
    v = v.permute(0, 2, 3, 1).reshape(B, -1)
    v = F.relu(F.linear(v, w["value_fc.weight"], w["value_fc.bias"]))
    v = F.linear(v, w["value_out.weight"], w["value_out.bias"])
    return logits, torch.tanh(v)[:, 0]


def loss(w: dict, obs, policy_target, value_target, legal_mask, blocks: int):
    """The learner's objective in training mode: the cross entropy of the
    visit-count targets against the logits masked to the legal actions,
    plus the squared value error, each a batch mean."""
    logits, value = forward(w, obs, blocks, training=True)
    masked = torch.where(legal_mask, logits, torch.finfo(logits.dtype).min)
    logp = torch.log_softmax(masked, dim=-1)
    policy_loss = -torch.mean(torch.sum(torch.where(legal_mask, policy_target * logp, 0.0), -1))
    value_loss = torch.mean((value_target - value) ** 2)
    return policy_loss + value_loss
