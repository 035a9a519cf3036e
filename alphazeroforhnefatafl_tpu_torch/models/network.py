"""Policy/value network in PyTorch.

The counterpart of ``alphazeroforhnefatafl_tpu/models/network.py``: the same
residual trunk (GroupNorm ``ResBlock`` or norm-free ``NFResBlock``), the same
policy head whose flatten order is the action encoding (cell, then
direction, then distance) and the same value head. Parameters are float32;
the ``dtype`` knob sets the trunk's compute type as Flax's ``dtype`` does
(bf16 by default), while both heads compute in float32.

The net takes the env's NHWC planes ``f32[B, N, N, C]`` and works in NCHW
inside; the heads permute back to NHWC before flattening, so logits and the
value head's Dense input keep the JAX layout. On the card the planes keep
their NHWC strides (channels-last): the convolutions take and return
channels-last, and at each GroupNorm site :func:`norm_act` takes the CUDA
kernel of ``ops/group_norm.py`` (the norm, the skip and the ReLU in one pass)
wherever ``ops.group_norm.kernel_applies`` holds: a bf16 trunk under
``inference_mode`` or ``no_grad``. Everywhere else (the CPU, the float32
trunk, the learner's forward with grad on) the site runs PyTorch's chain.

A third trunk has no JAX counterpart: ``norm="batch"`` with ``se_ratio`` r,
Leela Chess Zero's squeeze-excitation residual block (``SEResBlock``) with
batch norm in the stem, the blocks and the policy head. Batch norm makes the
net's two modes differ: in training mode (``net.train()``, set only for the
learner's step) it normalises by the batch's statistics and updates the
running ones; in inference mode (``net.eval()``, in which the net is built
and which the step restores, so self-play's and the arena's) it is a
per-channel affine from the running statistics. There its sites take the
CUDA kernels of ``ops/se_block.py`` wherever ``se_block_applies`` holds
(:func:`bn_act`, :func:`se_act`), else PyTorch's chain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group_norm import group_norm_act, group_norm_act_plain, kernel_applies
from ..ops.se_block import bn_relu, bn_relu_plain, se_block, se_block_applies, se_block_plain
from ..utils.profiling import span

GN_EPS = 1e-6  # Flax GroupNorm's epsilon (torch's default is 1e-5)
BN_EPS = 1e-5  # batch norm's (torch's and Lc0's)
BN_MOMENTUM = 0.1
OBS_PLANES = 6  # planes of TaflEnv.observe
NORMS = ("group", "none", "batch")


class Conv(nn.Conv2d):
    """A 'SAME'-padded convolution that computes in its input's dtype."""

    def __init__(self, c_in: int, c_out: int, k: int, bias: bool = True):
        super().__init__(c_in, c_out, k, padding=k // 2, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        # A channels-last input on the card takes its weight channels-last in
        # the same cast, which cuDNN would otherwise copy on its own.
        fmt = (torch.channels_last
               if x.is_cuda and x.is_contiguous(memory_format=torch.channels_last)
               else torch.preserve_format)
        return self._conv_forward(x, self.weight.to(x.dtype, memory_format=fmt), b)


def norm_act(gn: nn.GroupNorm, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(skip + group_norm(x))``, the skip where given: the CUDA kernel
    where it applies, else PyTorch's chain with float32 statistics (counted
    in ``norm_act.plain_calls`` on the card)."""
    R, C, H, W = x.shape
    if kernel_applies(x.device.type, x.dtype, x.is_contiguous(memory_format=torch.channels_last),
                      torch.is_grad_enabled(), gn.num_groups, C, H * W):
        return group_norm_act(x, gn.weight, gn.bias, gn.eps, skip)
    if x.is_cuda:
        norm_act.plain_calls += 1
    return group_norm_act_plain(x, gn.num_groups, gn.weight, gn.bias, gn.eps, skip)


norm_act.plain_calls = 0


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=GN_EPS)


class ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = Conv(channels, channels, 3, bias=False)
        self.gn0 = _gn(channels)
        self.conv1 = Conv(channels, channels, 3, bias=False)
        self.gn1 = _gn(channels)

    def forward(self, x):
        y = norm_act(self.gn0, self.conv0(x))
        return norm_act(self.gn1, self.conv1(y), skip=x)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def _applies(bn: nn.BatchNorm2d, y: torch.Tensor) -> bool:
    R, C, H, W = y.shape
    return se_block_applies(y.device.type, y.dtype,
                            y.is_contiguous(memory_format=torch.channels_last),
                            torch.is_grad_enabled(), bn.training, C, H * W)


def bn_act(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """``relu(bn(y))``: the CUDA kernel where it applies (inference mode),
    else PyTorch's chain in float32 (counted in ``bn_relu.plain_calls`` on
    the card), which in training mode uses and updates the statistics."""
    if _applies(bn, y):
        return bn_relu(y, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    if y.is_cuda:
        bn_relu.plain_calls += 1
    return bn_relu_plain(y, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps,
                         bn.training, bn.momentum)


def se_act(blk: "SEResBlock", y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The SE block's end from its second convolution's output ``y`` and its
    input ``x``: the CUDA kernel where it applies, else PyTorch's chain
    (counted in ``se_block.plain_calls`` on the card)."""
    bn = blk.bn1
    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps,
            blk.se_fc1.weight, blk.se_fc1.bias, blk.se_fc2.weight, blk.se_fc2.bias)
    if _applies(bn, y):
        return se_block(y, x, *args)
    if y.is_cuda:
        se_block.plain_calls += 1
    return se_block_plain(y, x, *args, bn.training, bn.momentum)


class SEResBlock(nn.Module):
    """Leela Chess Zero's squeeze-excitation residual block: two bias-free 3x3
    convolutions, each with batch norm, then the cells' mean through a
    ``C -> C / se_ratio -> 2C`` unit whose halves gate and shift the
    branch: ``relu(x + sigmoid(gamma) * bn1(conv1(y)) + beta)``."""

    def __init__(self, channels: int, se_ratio: int):
        super().__init__()
        self.conv0 = Conv(channels, channels, 3, bias=False)
        self.bn0 = _bn(channels)
        self.conv1 = Conv(channels, channels, 3, bias=False)
        self.bn1 = _bn(channels)
        self.se_fc1 = nn.Linear(channels, channels // se_ratio)
        self.se_fc2 = nn.Linear(channels // se_ratio, 2 * channels)

    def forward(self, x):
        y = bn_act(self.bn0, self.conv0(x))
        return se_act(self, self.conv1(y), x)


class NFResBlock(nn.Module):
    """Norm-free residual block: pre-activation convs and a learnable branch
    gain initialized at 0 (SkipInit)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = Conv(channels, channels, 3)
        self.conv1 = Conv(channels, channels, 3)
        self.skip_gain = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        y = self.conv1(F.relu(self.conv0(F.relu(x))))
        return x + self.skip_gain.to(x.dtype) * y


class PolicyValueNet(nn.Module):
    """``obs f32[B, N, N, C_in] -> (policy_logits f32[B, A], value f32[B])``,
    ``A = N*N*4*(N-1)``, value in [-1, 1] for the player to move."""

    def __init__(
        self,
        board_size: int,
        channels: int = 64,
        blocks: int = 6,
        value_hidden: int = 128,
        dtype: torch.dtype = torch.bfloat16,
        norm: str = "group",
        se_ratio: int = 0,
    ):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm={norm!r}; expected one of {NORMS}")
        if (norm == "batch") != (se_ratio > 0) or (se_ratio > 0 and channels % se_ratio):
            raise ValueError(f"norm={norm!r} with se_ratio={se_ratio} at {channels} channels: "
                             "the SE unit comes with batch norm and only with it, and its "
                             "ratio divides the channels")
        n = board_size
        self.board_size = n
        self.dtype = dtype
        self.norm_free = norm == "none"
        self.batch_norm = norm == "batch"
        # Registered in init_params' draw order: the stem, its norm, the
        # blocks, the policy conv, its norm, the heads.
        self.stem = Conv(OBS_PLANES, channels, 3, bias=self.norm_free)
        if self.batch_norm:
            self.stem_bn = _bn(channels)
            self.blocks = nn.ModuleList(SEResBlock(channels, se_ratio) for _ in range(blocks))
        else:
            self.stem_gn = None if self.norm_free else _gn(channels)
            block = NFResBlock if self.norm_free else ResBlock
            self.blocks = nn.ModuleList(block(channels) for _ in range(blocks))
        # Bias only on the norm-free path, as in the JAX net (a norm would
        # cancel it).
        self.policy_conv = Conv(channels, channels, 3, bias=self.norm_free)
        if self.batch_norm:
            self.policy_bn = _bn(channels)
        else:
            self.policy_gn = None if self.norm_free else _gn(channels)
        self.policy_out = Conv(channels, 4 * (n - 1), 1)
        self.value_conv = Conv(channels, 8, 1)
        self.value_fc = nn.Linear(8 * n * n, value_hidden)
        self.value_out = nn.Linear(value_hidden, 1)
        # Built to evaluate; the learner's step alone trains (make_train_step).
        self.eval()

    def _norm_act(self, which: str, x: torch.Tensor) -> torch.Tensor:
        """The stem's or the policy head's norm and ReLU."""
        if self.batch_norm:
            return bn_act(getattr(self, which + "_bn"), x)
        if self.norm_free:
            return F.relu(x)
        return norm_act(getattr(self, which + "_gn"), x)

    def forward(self, obs: torch.Tensor):
        with span("net/forward"):
            return self._forward(obs)

    def _forward(self, obs: torch.Tensor):
        B = obs.shape[0]
        x = obs.permute(0, 3, 1, 2).to(self.dtype)
        x = self.stem(x)
        if self.norm_free:
            for blk in self.blocks:
                x = blk(x)
            x = F.relu(x)
        else:
            x = self._norm_act("stem", x)
            for blk in self.blocks:
                x = blk(x)

        p = self._norm_act("policy", self.policy_conv(x))
        p = self.policy_out(p.float())
        logits = p.permute(0, 2, 3, 1).reshape(B, -1)

        v = F.relu(self.value_conv(x.float()))
        v = v.permute(0, 2, 3, 1).reshape(B, -1)
        v = self.value_out(F.relu(self.value_fc(v)))
        return logits, torch.tanh(v)[:, 0]


def make_network(
    board_size: int,
    channels: int = 64,
    blocks: int = 6,
    norm: str = "group",
    dtype: torch.dtype = torch.bfloat16,
    se_ratio: int = 0,
) -> PolicyValueNet:
    return PolicyValueNet(board_size, channels=channels, blocks=blocks, norm=norm, dtype=dtype,
                          se_ratio=se_ratio)


def architecture(state: dict) -> dict:
    """``channels``, ``blocks``, ``norm`` and ``se_ratio`` of the net whose
    ``state_dict`` is ``state``, read from its tensors' names and shapes."""
    channels = state["stem.weight"].shape[0] if "stem.weight" in state else None
    blocks = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
    norm = "batch" if "stem_bn.weight" in state else "group" if "stem_gn.weight" in state else "none"
    fc1 = state.get("blocks.0.se_fc1.weight")
    se_ratio = channels // fc1.shape[0] if fc1 is not None and channels else 0
    return {"channels": channels, "blocks": blocks, "norm": norm, "se_ratio": se_ratio}


@torch.no_grad()
def init_params(net: PolicyValueNet, generator: torch.Generator) -> PolicyValueNet:
    """Initialize as Flax does: LeCun-normal (truncated) kernels, zero biases,
    unit norm scales, zero skip gains; batch norm's running statistics at
    mean 0 and variance 1."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # Flax's truncated normal at +-2 std, rescaled to unit variance.
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        elif isinstance(m, NFResBlock):
            m.skip_gain.zero_()
    return net
