"""The trunk's normalisation epilogue: GroupNorm, the skip and the ReLU.

Replaces no TPU kernel (XLA fuses the same chain around the convolutions on
the TPU). On the H100, PyTorch's chain moves about 190 MB a GroupNorm site
at 1,024 rows of 64 channels on 11x11 (a float32 copy, moments, apply, a
cast back), a ReLU and a skip add more, and its GroupNorm takes NCHW only,
so cuDNN transposes around every channels-last convolution. The CUDA kernel
in ``csrc/group_norm.cu`` reads the bf16 activation once (and the skip,
where there is one) and writes the bf16 result once, channels-last.

:func:`group_norm_act_plain` is that chain, the plain version the kernel is
held against; :func:`group_norm_act` dispatches on the device of its input.
:func:`kernel_applies` says, from what a caller can observe, when the
network takes the kernel. :func:`group_norm_ulps` counts how far a result
lies from exact math rounded once and from the chain, in bf16 ulps; the
host simulation's tests and ``chip_smoke.py`` judge the kernel by it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

GROUPS = 32  # the kernel's groups: one a lane of a warp
CHANNELS = (32, 64, 128, 256)  # C / 32 channels a lane, as one 2-16 byte load
VALUES_PER_LANE = 32  # floats a lane keeps in registers
MAX_WARPS = 32


def max_positions(channels: int) -> int:
    """The most H x W positions a row may have: each of at most 32 warps
    keeps ``VALUES_PER_LANE`` values a lane, ``channels / 32`` a position."""
    return MAX_WARPS * VALUES_PER_LANE * GROUPS // channels


def kernel_applies(device_type: str, dtype: torch.dtype, channels_last: bool, grad: bool,
                   groups: int, channels: int, positions: int) -> bool:
    """Whether the kernel serves a GroupNorm site: a CUDA bf16 activation,
    contiguous channels-last, with autograd off, 32 groups, a channel count
    the kernel takes and a board whose row fits its registers."""
    return (device_type == "cuda" and dtype == torch.bfloat16 and channels_last and not grad
            and groups == GROUPS and channels in CHANNELS
            and positions <= max_positions(channels))


def group_norm_act_plain(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float, skip: torch.Tensor | None = None) -> torch.Tensor:
    """GroupNorm with float32 statistics, returned in ``x``'s dtype, then
    ``skip + y`` where given, then the ReLU."""
    y = F.group_norm(x.float(), groups, weight, bias, eps).to(x.dtype)
    if skip is not None:
        y = skip + y
    return F.relu(y)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   skip: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(group_norm(x) + skip)`` over 32 groups (the skip where
    given), ``x`` ``[R, C, H, W]``.

    A CPU tensor goes to :func:`group_norm_act_plain`; a CUDA tensor to the
    CUDA kernel, which takes bf16 ``x`` (and ``skip``) contiguous
    channels-last and float32 ``weight`` and ``bias``, returns bf16
    channels-last, and raises on anything else.
    """
    if x.device.type == "cpu":
        return group_norm_act_plain(x, GROUPS, weight, bias, eps, skip)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    R, C, H, W = x.shape
    cl = torch.channels_last
    if x.dtype != torch.bfloat16 or not x.is_contiguous(memory_format=cl):
        raise ValueError(f"x must be bf16 channels-last, got {x.dtype} strides {x.stride()}")
    if C not in CHANNELS or H * W > max_positions(C):
        raise ValueError(f"group_norm_act: {C} channels on {H}x{W} is not served")
    for t in (weight, bias):
        if t.dtype != torch.float32 or tuple(t.shape) != (C,) or t.device != x.device:
            raise ValueError("weight and bias must be float32[C] on x's device")
    weight, bias = weight.contiguous(), bias.contiguous()
    if skip is not None and (skip.dtype != x.dtype or skip.shape != x.shape
                             or skip.device != x.device
                             or not skip.is_contiguous(memory_format=cl)):
        raise ValueError("skip must be laid out as x")
    align = 2 * C // GROUPS  # the bytes of one lane's load
    if any(t.data_ptr() % align for t in (x, skip) if t is not None):
        raise ValueError(f"x and skip must start on a {align}-byte boundary")
    out = torch.empty_like(x, memory_format=cl)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # Enter the tensor's device around the launch, as the other wrappers do.
    with torch.cuda.device(x.device):
        rc = lib.tafl_group_norm_act(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if skip is None else skip.data_ptr(), R, C, H * W, eps,
            out.data_ptr(), stream,
        )
    _build.check(rc, "tafl_group_norm_act")
    group_norm_act.launches += 1
    group_norm_act.batches[R] = group_norm_act.batches.get(R, 0) + 1
    return out


group_norm_act.launches = 0
group_norm_act.batches = {}  # launches by rows


# How far a result lies from exact math and from the chain, in bf16 ulps.


def exact_group_norm(x, weight, bias, eps, skip=None):
    """``relu(group_norm(x) + skip)`` in float64, as ``(result, carried,
    largest)``. ``carried`` is the sum of the magnitudes that float32
    carries into each element: the input over the group's spread times the
    weight (the mean is rounded at the input's magnitude), the bias and the
    skip; ``largest`` the largest of the terms summed into it: the
    normalised value times the weight, the bias, the skip."""
    R, C, H, W = x.shape
    g = x.double().reshape(R, GROUPS, -1)
    mean = g.mean(-1, keepdim=True)
    std = torch.sqrt(((g - mean) ** 2).mean(-1, keepdim=True) + eps)
    w = weight.double()[:, None, None]
    b = bias.double()[:, None, None]
    t = ((g - mean) / std).reshape(R, C, H, W) * w
    y = t + b
    carried = (g.abs() / std).reshape(R, C, H, W) * w.abs() + b.abs()
    largest = torch.maximum(t.abs(), b.abs())
    if skip is not None:
        y = y + skip.double()
        carried = carried + skip.double().abs()
        largest = torch.maximum(largest, skip.double().abs())
    return y.clamp(min=0), carried, largest


def ordinal(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of their values (+0 = -0 = 0)."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulp(magnitude: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at ``magnitude`` (8 significant bits)."""
    e = torch.floor(torch.log2(magnitude.double().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def group_norm_ulps(got, x, weight, bias, eps, skip=None, against_chain=True):
    """``(ulps from exact math, ulps from the chain)`` of ``got``, a result
    of ``relu(group_norm(x) + skip)`` in bf16.

    The first is the largest ordinal distance from exact math rounded once,
    among elements outside the cancellation allowance (0 where there are
    none): an element whose terms cancel is held instead to 2**-20 of the
    magnitudes float32 carries into it, since float32's own error there is
    far below a bf16 ulp of those terms, not of their difference. The
    second is the largest distance from :func:`group_norm_act_plain` on the
    same tensors (0 where not compared), counted at the larger of the
    chain's result and the largest term: the chain rounds the normalised
    value to bf16 before it adds the skip, and PyTorch's CUDA GroupNorm
    applies it as x * scale + (bias - mean * scale), whose float32 terms
    cancel where the result is small."""
    ref, carried, largest = exact_group_norm(x, weight, bias, eps, skip)
    ulps = (ordinal(got) - ordinal(ref.float().to(torch.bfloat16))).abs()
    outside = (got.double() - ref).abs() > 2.0 ** -20 * carried
    exact_ulps = int(torch.where(outside, ulps, torch.zeros_like(ulps)).max())
    if not against_chain:
        return exact_ulps, 0.0
    chain = group_norm_act_plain(x, GROUPS, weight, bias, eps, skip)
    mag = torch.maximum(chain.double().abs(), largest)
    return exact_ulps, float(((got.double() - chain.double()).abs() / bf16_ulp(mag)).max())
