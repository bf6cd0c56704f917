"""Train state: model, optimizer state, loss-balancing EMA, parameter EMA.
Mirrors ``imm_tpu.train.state``.

The JAX package's state is an immutable tree; here the parameters and the
BatchNorm statistics live in the ``nn.Module`` and a step updates them in
place. The optimizer is written as functions on tensors with optax's
arithmetic (``make_optimizer``), not ``torch.optim``: a step must be able to
skip its whole update on a device-side flag (the NaN guard) without a host
sync, and the piecewise learning rate follows a count that lives on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from imm_tpu_torch.models.imm import IMM, IMMConfig, init_model
from imm_tpu_torch.utils.config import TrainConfig

Tensors = dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # 0-d int32 on the device: optimizer steps taken
    model: IMM  # parameters and BatchNorm statistics, updated in place
    opt_state: dict[str, Any]  # 'count' (0-d int32) and, for Adam, 'mu' / 'nu'
    loss_ema: torch.Tensor  # per-term loss scale EMA (losses/perceptual.py)
    # Polyak-averaged parameters by name (TrainConfig.param_ema_decay > 0), else None
    ema_params: Tensors | None = None
    # ``step`` again, as a host integer, so the loop, the step-0 EMA seeding
    # and the equivariance schedule never read the device
    host_step: int = 0

    @property
    def params(self) -> Tensors:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Tensors:
        return dict(self.model.named_buffers())


class Optimizer:
    """optax's ``chain(clip_by_global_norm?, sgd | adam | adamw)`` with a
    piecewise-constant learning rate, on dicts of tensors.

    ``update`` is pure: it returns the parameter updates and a new state and
    changes neither argument, so the caller can gate both on a flag.
    """

    def __init__(self, config: TrainConfig):
        if config.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {config.optimizer!r}; expected 'adam' or 'sgd'")
        if len(config.lr_factors) != len(config.lr_boundaries) + 1:
            raise ValueError(
                "lr_factors must have one more entry than lr_boundaries, got "
                f"{config.lr_factors} / {config.lr_boundaries}"
            )
        self.config = config
        # optax.piecewise_constant_schedule: the rate is scaled by the ratio
        # of consecutive factors at every boundary the count has reached
        self.boundaries = sorted(
            (int(b), config.lr_factors[i + 1] / config.lr_factors[i])
            for i, b in enumerate(config.lr_boundaries)
        )
        self.adam = config.optimizer == "adam"

    def init(self, params: Tensors) -> dict[str, Any]:
        dev = next(iter(params.values())).device
        state: dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.adam:
            state["mu"] = {k: torch.zeros_like(p) for k, p in params.items()}
            state["nu"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The rate used by the update that finds ``count`` updates done
        before it: scaled from the first count that is >= a boundary."""
        lr = torch.full((), self.config.learning_rate, dtype=torch.float32, device=count.device)
        for boundary, ratio in self.boundaries:
            lr = torch.where(count >= boundary, lr * ratio, lr)
        return lr

    def update(self, grads: Tensors, state: dict[str, Any], params: Tensors):
        c = self.config
        count = state["count"]
        new_state: dict[str, Any] = {"count": count + 1}
        if c.grad_clip > 0:
            # optax.clip_by_global_norm: untouched below the bound, else
            # g / norm * bound (torch's clip_grad_norm_ divides by norm + 1e-6)
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            grads = {
                k: torch.where(norm < c.grad_clip, g, g / norm * c.grad_clip)
                for k, g in grads.items()
            }
        step_size = -self.learning_rate(count)
        if not self.adam:
            return {k: step_size * g for k, g in grads.items()}, new_state
        b1, b2, eps = c.adam_b1, c.adam_b2, 1e-8
        t = (count + 1).to(torch.float32)
        bias1, bias2 = 1.0 - b1**t, 1.0 - b2**t
        mu = {k: (1.0 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1.0 - b2) * (g * g) + b2 * state["nu"][k] for k, g in grads.items()}
        new_state["mu"], new_state["nu"] = mu, nu
        updates = {}
        for k in grads:
            u = (mu[k] / bias1) / (torch.sqrt(nu[k] / bias2) + eps)  # eps outside the root
            if c.weight_decay > 0:  # adamw: decoupled decay, before the rate
                u = u + c.weight_decay * params[k]
            updates[k] = step_size * u
        return updates, new_state


def make_optimizer(config: TrainConfig) -> Optimizer:
    return Optimizer(config)


def create_train_state(
    seed: int,
    model_config: IMMConfig,
    train_config: TrainConfig,
    n_loss_terms: int,
    device=None,
) -> tuple[IMM, TrainState]:
    """Initialize the model (from ``seed``, with flax's initialisers) and the
    optimizer into a fresh ``TrainState`` on ``device`` (default: the GPU)."""
    model = init_model(model_config, seed=seed, device=device)
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    state = TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        model=model,
        opt_state=make_optimizer(train_config).init(params),
        loss_ema=torch.ones((n_loss_terms,), dtype=torch.float32, device=dev),
        ema_params=(
            {k: p.detach().clone() for k, p in params.items()}
            if train_config.param_ema_decay > 0 else None
        ),
    )
    return model, state
