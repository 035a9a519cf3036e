"""AlphaZero learner: loss, optimizer and train step.

The counterpart of ``alphazeroforhnefatafl_tpu/train/learner.py``. The loss
is the standard AlphaZero objective over the search's visit-count policy
targets and final-outcome values:

    L = CE(pi_target, policy_logits) + (z - v)^2   (+ weight decay via AdamW)

The optimizer equals the optax chain of the JAX learner: a global-norm clip
at 1.0, then AdamW with weight decay on every parameter, on a linear-warmup
cosine-decay schedule that is read at the step count *before* each update
(so the first update has rate 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ..parallel.mesh import mean_

DECAY_STEPS = 200_000  # whole schedule length, warmup included
END_FRACTION = 0.05  # the rate held after the decay, as a share of the peak
CLIP_NORM = 1.0


@dataclass
class Batch:
    """One training batch of self-play positions."""

    obs: torch.Tensor  # f32[B, N, N, C]
    policy_target: torch.Tensor  # f32[B, A] (visit-count distribution, sums to 1)
    value_target: torch.Tensor  # f32[B] in [-1, 1], mover perspective
    legal_mask: torch.Tensor  # bool[B, A]


@dataclass
class TrainState:
    """The net in training with its optimizer and schedule. The step count
    lives with the schedule (one scheduler step per optimizer step)."""

    net: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR

    @property
    def step(self) -> int:
        return self.scheduler.last_epoch

    def state_dict(self) -> Dict[str, dict]:
        return {
            "net": self.net.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
        }

    def load_state_dict(self, state: Dict[str, dict]) -> None:
        self.net.load_state_dict(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])


def learning_rate_schedule(
    learning_rate: float = 2e-3, warmup_steps: int = 200
) -> Callable[[int], float]:
    """``step -> rate``: linear from 0 to ``learning_rate`` over
    ``warmup_steps``, then a cosine over the remaining
    ``DECAY_STEPS - warmup_steps`` steps down to ``END_FRACTION`` of the
    peak, held from there on."""
    cosine_steps = DECAY_STEPS - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return learning_rate * step / warmup_steps
        t = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return learning_rate * ((1.0 - END_FRACTION) * cosine + END_FRACTION)

    return schedule


def make_optimizer(
    params, learning_rate: float = 2e-3, weight_decay: float = 1e-4, warmup_steps: int = 200
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``params`` (all in one group: biases and norm scales decay
    too) and its schedule. Step the scheduler after every optimizer step."""
    # Base rate 1.0: the lambda's value is the rate itself.
    optimizer = torch.optim.AdamW(
        params, lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, learning_rate_schedule(learning_rate, warmup_steps)
    )
    return optimizer, scheduler


def init_train_state(
    net: nn.Module, generator: torch.Generator, device="cuda", **optimizer_args
) -> TrainState:
    """Initialize ``net`` on the CPU from the (CPU) ``generator``, move it to
    ``device`` and build its optimizer there. The state lives on the CUDA
    card unless the caller asks for ``device="cpu"``; without a card that
    raises."""
    from ..models.network import init_params

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"init_train_state(device={str(device)!r}): CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    init_params(net, generator).to(device)
    optimizer, scheduler = make_optimizer(net.parameters(), **optimizer_args)
    return TrainState(net=net, optimizer=optimizer, scheduler=scheduler)


def loss_fn(net: nn.Module, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, value = net(batch.obs)
    # Mask illegal actions out of the cross entropy: targets are zero there,
    # and masking keeps the normalizer consistent with play-time softmax.
    neg_inf = torch.finfo(logits.dtype).min
    masked_logits = torch.where(batch.legal_mask, logits, neg_inf)
    logp = torch.log_softmax(masked_logits, dim=-1)
    policy_loss = -torch.mean(
        torch.sum(torch.where(batch.legal_mask, batch.policy_target * logp, 0.0), dim=-1)
    )
    value_loss = torch.mean((batch.value_target - value) ** 2)
    loss = policy_loss + value_loss
    metrics = {
        "loss": loss.detach(),
        "policy_loss": policy_loss.detach(),
        "value_loss": value_loss.detach(),
        "value_mean": value.detach().mean(),
    }
    return loss, metrics


def global_norm(tensors) -> torch.Tensor:
    """The 2-norm of all the tensors' elements together."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def make_train_step(state: TrainState, group=None) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Build ``train_step(batch) -> metrics``, which updates ``state`` in
    place. ``metrics`` are device scalars; ``grad_norm`` is the gradients'
    global norm before the clip.

    With a process ``group``, each rank passes its equal slice of the
    global batch: after the backward pass one all-reduce takes the mean of
    the gradients and of the four loss metrics over the ranks, so the norm,
    the clip and the update are the global batch's (JAX's psum) and every
    rank's parameters stay bit-identical. ``group=None`` reduces nothing.

    The step runs the net in training mode and leaves it in inference mode,
    the mode it is built in: a batch-norm net normalises by the batch's
    statistics and moves its running ones towards them. Across ranks each
    rank's running statistics moved with its own slice; the same all-reduce
    makes them their mean over the ranks, so every rank's net stays the same.
    """
    params = [p for p in state.net.parameters() if p.requires_grad]
    stats = [b for b in state.net.buffers() if b.is_floating_point()]

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        state.net.train()
        try:
            loss, metrics = loss_fn(state.net, batch)
            loss.backward()
        finally:
            state.net.eval()
        grads = [p.grad for p in params]
        if group is not None:
            # The four metrics and the running statistics ride in the
            # gradients' collective.
            scalars = torch.stack(list(metrics.values()))
            mean_(grads + [scalars] + stats, group)
            metrics = dict(zip(metrics, scalars))
        norm = global_norm(grads)
        # Gradients are left alone below the bound and divided by exactly
        # norm / bound above it (no epsilon in the divisor).
        divisor = torch.where(norm < CLIP_NORM, torch.ones_like(norm), norm / CLIP_NORM)
        for g in grads:
            g.div_(divisor)
        state.optimizer.step()
        state.scheduler.step()
        metrics["grad_norm"] = norm
        return metrics

    return train_step
