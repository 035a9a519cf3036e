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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group_norm import group_norm_act, group_norm_act_plain, kernel_applies

GN_EPS = 1e-6  # Flax GroupNorm's epsilon (torch's default is 1e-5)
OBS_PLANES = 6  # planes of TaflEnv.observe


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
    ):
        super().__init__()
        if norm not in ("group", "none"):
            raise ValueError(f"norm={norm!r}; expected 'group' or 'none'")
        n = board_size
        self.board_size = n
        self.dtype = dtype
        self.norm_free = norm == "none"
        self.stem = Conv(OBS_PLANES, channels, 3, bias=self.norm_free)
        self.stem_gn = None if self.norm_free else _gn(channels)
        block = NFResBlock if self.norm_free else ResBlock
        self.blocks = nn.ModuleList(block(channels) for _ in range(blocks))
        # Bias only on the norm-free path, as in the JAX net (GroupNorm would
        # cancel it).
        self.policy_conv = Conv(channels, channels, 3, bias=self.norm_free)
        self.policy_gn = None if self.norm_free else _gn(channels)
        self.policy_out = Conv(channels, 4 * (n - 1), 1)
        self.value_conv = Conv(channels, 8, 1)
        self.value_fc = nn.Linear(8 * n * n, value_hidden)
        self.value_out = nn.Linear(value_hidden, 1)

    def forward(self, obs: torch.Tensor):
        B = obs.shape[0]
        x = obs.permute(0, 3, 1, 2).to(self.dtype)
        x = self.stem(x)
        if self.norm_free:
            for blk in self.blocks:
                x = blk(x)
            x = F.relu(x)
        else:
            x = norm_act(self.stem_gn, x)
            for blk in self.blocks:
                x = blk(x)

        p = self.policy_conv(x)
        p = F.relu(p) if self.norm_free else norm_act(self.policy_gn, p)
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
) -> PolicyValueNet:
    return PolicyValueNet(board_size, channels=channels, blocks=blocks, norm=norm, dtype=dtype)


@torch.no_grad()
def init_params(net: PolicyValueNet, generator: torch.Generator) -> PolicyValueNet:
    """Initialize as Flax does: LeCun-normal (truncated) kernels, zero biases,
    unit GroupNorm scales, zero skip gains."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # Flax's truncated normal at +-2 std, rescaled to unit variance.
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, NFResBlock):
            m.skip_gain.zero_()
    return net
