"""The batch-norm trunk's epilogues: the squeeze-excitation end of a block,
and the norm with its ReLU.

Replace no TPU kernel (the JAX package has no batch norm and no SE unit).
On the H100 PyTorch runs a block's SE end as about eight launches, each a
pass over the row or a launch of next to no work; the CUDA kernels in
``csrc/se_block.cu`` read the bf16 activations once and write the bf16
result once, channels-last, with the norm's running statistics:

- :func:`se_block`: ``relu(x + sigmoid(gamma) z + beta)``, ``z`` the norm of
  ``y``, ``(gamma, beta) = W2 relu(W1 mean(z) + b1) + b2``;
- :func:`bn_relu`: ``relu(z)``.

:func:`se_block_plain` and :func:`bn_relu_plain` are the PyTorch chains the
kernels are held against, in float32 with one round to the input's dtype,
and in training mode (batch statistics, the running ones updated) the
network's path wherever the kernels do not apply. :func:`se_block_applies`
says, from what a caller can observe, when the network takes the kernels.
:func:`exact_se_block`, :func:`exact_bn_relu` and :func:`ulps_from_exact`
count how far a result lies from exact math rounded once, in bf16 ulps;
the host simulation's tests and ``chip_smoke.py`` judge the kernels by them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .group_norm import CHANNELS, max_positions, ordinal

#: Where a result is held to float32's carried error instead of 1 bf16 ulp:
#: the longest float32 sum (a dot of 256 channels) may lose 256 roundings of
#: 2**-24 of the magnitudes summed, 2**-16 of them.
CARRY = 2.0 ** -16


def se_block_applies(device_type: str, dtype: torch.dtype, channels_last: bool, grad: bool,
                     training: bool, channels: int, positions: int) -> bool:
    """Whether the kernels serve a batch-norm site: a CUDA bf16 activation,
    contiguous channels-last, with autograd off and the norm in inference
    mode (running statistics), a channel count the kernels take and a board
    whose row fits the SE kernel's registers."""
    return (device_type == "cuda" and dtype == torch.bfloat16 and channels_last and not grad
            and not training and channels in CHANNELS and positions <= max_positions(channels))


def _norm(y, weight, bias, mean, var, eps, training, momentum):
    return F.batch_norm(y.float(), mean, var, weight, bias, training, momentum, eps)


def bn_relu_plain(y: torch.Tensor, weight, bias, mean, var, eps: float, training: bool = False,
                  momentum: float = 0.1) -> torch.Tensor:
    """``relu(batch_norm(y))`` in float32, returned in ``y``'s dtype; in
    training mode with the batch's statistics, updating ``mean`` and
    ``var``."""
    return F.relu(_norm(y, weight, bias, mean, var, eps, training, momentum)).to(y.dtype)


def se_block_plain(y: torch.Tensor, skip: torch.Tensor, weight, bias, mean, var, eps: float,
                   w1, b1, w2, b2, training: bool = False, momentum: float = 0.1) -> torch.Tensor:
    """The SE block's end in float32, returned in ``y``'s dtype:
    ``relu(skip + sigmoid(gamma) z + beta)``, ``z = batch_norm(y)``."""
    z = _norm(y, weight, bias, mean, var, eps, training, momentum)
    h = F.relu(F.linear(z.mean((2, 3)), w1, b1))
    gamma, beta = F.linear(h, w2, b2).chunk(2, dim=1)
    out = skip.float() + torch.sigmoid(gamma)[:, :, None, None] * z + beta[:, :, None, None]
    return F.relu(out).to(y.dtype)


def _check_kernel_args(what, y, vectors, align, skip=None):
    """Raises unless the kernel takes these tensors: ``align`` is the
    boundary, in bytes, that ``y`` and ``skip`` start on."""
    R, C, H, W = y.shape
    cl = torch.channels_last
    if y.dtype != torch.bfloat16 or not y.is_contiguous(memory_format=cl):
        raise ValueError(f"{what}: y must be bf16 channels-last, got {y.dtype} strides "
                         f"{y.stride()}")
    if C not in CHANNELS or H * W > max_positions(C):
        raise ValueError(f"{what}: {C} channels on {H}x{W} is not served")
    for t in vectors:
        if t.dtype != torch.float32 or t.device != y.device:
            raise ValueError(f"{what}: the norm's and SE unit's tensors must be float32 on "
                             "y's device")
    if skip is not None and (skip.dtype != y.dtype or skip.shape != y.shape
                             or skip.device != y.device
                             or not skip.is_contiguous(memory_format=cl)):
        raise ValueError(f"{what}: skip must be laid out as y")
    if any(t.data_ptr() % align for t in (y, skip) if t is not None):
        raise ValueError(f"{what}: y and skip must start on a {align}-byte boundary")


def _count(fn, rows):
    fn.launches += 1
    fn.batches[rows] = fn.batches.get(rows, 0) + 1


def bn_relu(y: torch.Tensor, weight, bias, mean, var, eps: float) -> torch.Tensor:
    """``relu(batch_norm(y))`` with the running statistics, ``y``
    ``[R, C, H, W]``: on the CPU :func:`bn_relu_plain`; on the card the
    kernel, which takes bf16 ``y`` contiguous channels-last and float32
    vectors of ``C``, returns bf16 channels-last and raises on anything
    else."""
    if y.device.type == "cpu":
        return bn_relu_plain(y, weight, bias, mean, var, eps)
    if y.device.type != "cuda":
        raise ValueError(f"bn_relu: unsupported device {y.device}")
    R, C, H, W = y.shape
    vectors = [t.contiguous() for t in (weight, bias, mean, var)]
    if any(tuple(t.shape) != (C,) for t in vectors):
        raise ValueError("bn_relu: the norm's vectors must be [C]")
    _check_kernel_args("bn_relu", y, vectors, 2 * C // 32)  # one lane's load
    out = torch.empty_like(y, memory_format=torch.channels_last)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        rc = lib.tafl_bn_relu(y.data_ptr(), *(t.data_ptr() for t in vectors), eps, R, C, H * W,
                              out.data_ptr(), stream)
    _build.check(rc, "tafl_bn_relu")
    _count(bn_relu, R)
    return out


bn_relu.launches = 0
bn_relu.batches = {}  # launches by rows
bn_relu.plain_calls = 0  # sites on the card that took the chain (models/network.py)


def se_block(y: torch.Tensor, skip: torch.Tensor, weight, bias, mean, var, eps: float,
             w1, b1, w2, b2) -> torch.Tensor:
    """The SE block's end with the norm's running statistics (see the
    module's docstring), ``y`` and ``skip`` ``[R, C, H, W]``, ``w1``
    ``[hidden, C]``, ``w2`` ``[2C, hidden]``: on the CPU
    :func:`se_block_plain`; on the card the kernel, which takes bf16 ``y``
    and ``skip`` contiguous channels-last and float32 vectors and matrices,
    ``y``, ``skip``, ``w1`` and ``w2`` on 16-byte boundaries, returns bf16
    channels-last and raises on anything else."""
    if y.device.type == "cpu":
        return se_block_plain(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2)
    if y.device.type != "cuda":
        raise ValueError(f"se_block: unsupported device {y.device}")
    out = torch.empty_like(y, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        launch_se_block(_build.load_library(), y, skip, weight, bias, mean, var, eps,
                        w1, b1, w2, b2, out, _sm_count(y.device.index), stream)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int | None) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index).multi_processor_count


@functools.lru_cache(maxsize=None)
def se_block_plan(lib, channels: int, hidden: int, positions: int) -> tuple[bool, int]:
    """``(resident, smem_bytes)`` of the kernel's CTA at these shapes:
    whether it holds the SE weights in shared memory, and its dynamic shared
    memory; raises where the kernel does not serve them."""
    smem = ctypes.c_int(0)
    resident = lib.tafl_se_block_plan(channels, hidden, positions, ctypes.byref(smem))
    if resident < 0:
        raise ValueError(f"se_block: {channels} channels, hidden {hidden}, {positions} "
                         "positions are not served")
    return bool(resident), smem.value


def launch_se_block(lib, y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, out, sms,
                    stream) -> None:
    """Checks the kernel's arguments, launches ``lib``'s ``tafl_se_block``
    into ``out`` over at most ``sms`` SMs' worth of resident CTAs, and
    counts the launch: :func:`se_block` on the card, the host simulation in
    tests."""
    R, C, H, W = y.shape
    hidden = w1.shape[0]
    tensors = [t.contiguous() for t in (weight, bias, mean, var, w1, b1, w2, b2)]
    shapes = [(C,)] * 4 + [(hidden, C), (hidden,), (2 * C, hidden), (2 * C,)]
    if [tuple(t.shape) for t in tensors] != shapes or not 1 <= hidden <= C:
        raise ValueError(f"se_block: the norm's and SE unit's shapes "
                         f"{[tuple(t.shape) for t in tensors]}, want {shapes}")
    _check_kernel_args("se_block", y, tensors, 16, skip)  # a bulk copy's, a thread's load
    if tensors[4].data_ptr() % 16 or tensors[6].data_ptr() % 16:
        raise ValueError("se_block: w1 and w2 must start on a 16-byte boundary")
    ptrs = [t.data_ptr() for t in tensors]
    rc = lib.tafl_se_block(y.data_ptr(), skip.data_ptr(), *ptrs[:4], eps, *ptrs[4:], hidden, R, C,
                           H * W, sms, out.data_ptr(), stream)
    _build.check(rc, "tafl_se_block")
    _count(se_block, R)
    if se_block_plan(lib, C, hidden, H * W)[0]:
        se_block.resident_launches += 1


se_block.launches = 0
se_block.batches = {}  # launches by rows
se_block.resident_launches = 0  # launches that held the SE weights in shared memory
se_block.plain_calls = 0  # sites on the card that took the chain (models/network.py)


# How far a result lies from exact math, in bf16 ulps.


def _affine(weight, bias, mean, var, eps, y):
    """The norm of ``y`` in float64 and the magnitudes float32 carries into
    it (``y`` times the scale, the mean times the scale, the bias)."""
    scale = (weight.double() / torch.sqrt(var.double() + eps))[:, None, None]
    mean, bias = mean.double()[:, None, None], bias.double()[:, None, None]
    yd = y.double()
    return (yd - mean) * scale + bias, (yd * scale).abs() + (mean * scale).abs() + bias.abs()


def exact_bn_relu(y, weight, bias, mean, var, eps):
    """``(relu(batch_norm(y)), carried)`` in float64, the running statistics."""
    z, carried = _affine(weight, bias, mean, var, eps, y)
    return z.clamp(min=0), carried


def exact_se_block(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2):
    """The SE block's end in float64, as ``(result, carried)``: ``carried``
    is the sum of the magnitudes float32 carries into each element, each
    layer's passed on through the absolute values of the next one's weights
    (the gate's at the sigmoid's steepest slope, 1/4)."""
    z, zc = _affine(weight, bias, mean, var, eps, y)
    w1, b1, w2, b2 = (t.double() for t in (w1, b1, w2, b2))
    h = F.relu(z.mean((2, 3)) @ w1.T + b1)
    hc = zc.mean((2, 3)) @ w1.abs().T + b1.abs()
    gamma, beta = (h @ w2.T + b2).chunk(2, dim=1)
    gc_gamma, gc_beta = (hc @ w2.abs().T + b2.abs()).chunk(2, dim=1)
    gate = torch.sigmoid(gamma)[:, :, None, None]
    x = skip.double()
    out = x + gate * z + beta[:, :, None, None]
    carried = (x.abs() + gate * zc + 0.25 * gc_gamma[:, :, None, None] * z.abs()
               + gc_beta[:, :, None, None])
    return out.clamp(min=0), carried


def ulps_from_exact(got: torch.Tensor, exact: torch.Tensor, carried: torch.Tensor) -> int:
    """The largest ordinal distance of bf16 ``got`` from ``exact`` rounded
    once, among elements outside the cancellation allowance (0 where there
    are none): an element whose terms cancel is held instead to ``CARRY``
    of the magnitudes float32 carries into it."""
    ulps = (ordinal(got) - ordinal(exact.float().to(torch.bfloat16))).abs()
    outside = (got.double() - exact).abs() > CARRY * carried
    return int(torch.where(outside, ulps, torch.zeros_like(ulps)).max())


def se_block_ulps(got, y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2) -> int:
    """:func:`ulps_from_exact` of a result of :func:`se_block`."""
    return ulps_from_exact(got, *exact_se_block(y, skip, weight, bias, mean, var, eps,
                                                w1, b1, w2, b2))


def bn_relu_ulps(got, y, weight, bias, mean, var, eps) -> int:
    """:func:`ulps_from_exact` of a result of :func:`bn_relu`."""
    return ulps_from_exact(got, *exact_bn_relu(y, weight, bias, mean, var, eps))
