"""Train state: model, optimizer state, loss-balancing EMA, parameter EMA.
Mirrors ``imm_tpu.train.state``.

The JAX package's state is an immutable tree; here the parameters and the
BatchNorm statistics live in the ``nn.Module`` and a step updates them in
place. The optimizer is written as functions on tensors with optax's
arithmetic (``make_optimizer``), not ``torch.optim``: a step must be able to
skip its whole update on a device-side flag (the NaN guard) without a host
sync, and the piecewise learning rate follows a count that lives on the
device.

A checkpoint is the state flattened to one dict of tensors
(``flatten_state``), which ``torch.save`` writes and
``torch.load(weights_only=True)`` reads; ``load_flat_state`` copies such a
dict back into a live state's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from imm_tpu_torch.models.imm import IMM, IMMConfig, init_model
from imm_tpu_torch.ops.adam import Recipe, StepScalars, adam_ema
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
    ``update_per_leaf`` adds the parameter EMA and that gate;
    ``update_in_place`` is the same step for Adam on the card (K6,
    ``ops/adam.py``), applied in place.
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

    def update_per_leaf(self, grads: Tensors, state: dict[str, Any], params: Tensors,
                        ema_params: Tensors | None, loss: torch.Tensor, ema_decay: float,
                        nan_guard: bool):
        """``update``, ``params + updates``, the parameter EMA (``ema_decay >
        0``) and, with ``nan_guard``, all of them gated on a finite loss and
        gradient norm, leaf by leaf and out of place: the step of the CPU and
        of SGD, and what ``update_in_place`` is held to. -> new parameters,
        optimizer state and EMA, and the step's ``StepScalars`` (its
        ``nonfinite`` None without the guard)."""
        grad_sq = torch.stack([torch.sum(g * g) for g in grads.values()]).sum()
        updates, new_opt_state = self.update(grads, state, params)
        new_params = {k: p + updates[k] for k, p in params.items()}
        new_ema_params = ema_params
        if ema_decay > 0:
            new_ema_params = {
                k: e * ema_decay + new_params[k] * (1.0 - ema_decay)
                for k, e in ema_params.items()
            }
        nonfinite = None
        if nan_guard:
            # A truly skipped step: gate params AND optimizer state on `ok` —
            # merely zeroing grads would still move params via decayed Adam
            # momentum and poison mu/nu with non-finite values.
            ok = torch.isfinite(loss) & torch.isfinite(grad_sq)

            def gate(new, old):
                if isinstance(new, dict):
                    return {k: gate(v, old[k]) for k, v in new.items()}
                return torch.where(ok, new, old)

            new_params = gate(new_params, params)
            new_opt_state = gate(new_opt_state, state)
            if ema_decay > 0:
                new_ema_params = gate(new_ema_params, ema_params)
            zero = torch.zeros_like(loss)
            loss = torch.where(ok, loss, zero)
            grad_sq = torch.where(ok, grad_sq, zero)
            nonfinite = 1.0 - ok.to(torch.float32)
        scalars = StepScalars(grad_norm=grad_sq**0.5, loss=loss, nonfinite=nonfinite)
        return new_params, new_opt_state, new_ema_params, scalars

    def runs_k6(self, device: torch.device) -> bool:
        """Whether a step on ``device`` takes ``update_in_place``: Adam on the
        card. The CPU and SGD take ``update_per_leaf``."""
        return self.adam and device.type == "cuda"

    def update_in_place(self, grads: Tensors, state: dict[str, Any], params: Tensors,
                        ema_params: Tensors | None, loss: torch.Tensor, ema_decay: float,
                        nan_guard: bool) -> StepScalars:
        """``update_per_leaf`` written into ``params``, ``state`` and
        ``ema_params`` in place by K6's two launches. -> the step's
        ``StepScalars`` on the device."""
        c = self.config
        recipe = Recipe(c.learning_rate, tuple(self.boundaries), c.adam_b1, c.adam_b2,
                        weight_decay=c.weight_decay, grad_clip=c.grad_clip, ema_decay=ema_decay,
                        nan_guard=nan_guard)
        names = list(params)
        return adam_ema(
            [params[k] for k in names], [grads[k] for k in names],
            [state["mu"][k] for k in names], [state["nu"][k] for k in names],
            [ema_params[k] for k in names] if ema_decay > 0 else None,
            state["count"], loss, recipe,
        )


def make_optimizer(config: TrainConfig) -> Optimizer:
    return Optimizer(config)


def piecewise_constant_config(init_value: float,
                              boundaries_and_scales: dict[int, float]) -> TrainConfig:
    """The Adam ``TrainConfig`` whose learning rate is optax's
    ``piecewise_constant_schedule(init_value, boundaries_and_scales)``: the
    scales multiply from each boundary on, so they become cumulative
    ``lr_factors``."""
    boundaries = sorted(boundaries_and_scales)
    factors = [1.0]
    for b in boundaries:
        factors.append(factors[-1] * boundaries_and_scales[b])
    return TrainConfig(learning_rate=init_value, lr_boundaries=tuple(boundaries),
                       lr_factors=tuple(factors))


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


def flatten_state(state: TrainState) -> Tensors:
    """The whole state as one flat dict of tensors (no copies): ``step``,
    ``loss_ema``, ``model/<name>`` for every parameter and BatchNorm
    statistic, ``opt_state/count`` and ``opt_state/{mu,nu}/<name>``, and
    ``ema_params/<name>`` when the state keeps a parameter EMA."""
    flat = {"step": state.step, "loss_ema": state.loss_ema}
    flat.update({f"model/{k}": v for k, v in state.model.state_dict().items()})
    for key, value in state.opt_state.items():
        if isinstance(value, dict):
            flat.update({f"opt_state/{key}/{k}": v for k, v in value.items()})
        else:
            flat[f"opt_state/{key}"] = value
    if state.ema_params is not None:
        flat.update({f"ema_params/{k}": v for k, v in state.ema_params.items()})
    return {k: v.detach() for k, v in flat.items()}


def load_flat_state(state: TrainState, flat: Tensors) -> TrainState:
    """Copy ``flat`` (as ``flatten_state`` gives it) into ``state``'s own
    tensors in place, so the model and the step function that holds it train
    the loaded values; set ``host_step`` from the loaded ``step``.

    The keys must be those of ``flatten_state(state)``, and every tensor must
    have its target's shape and dtype: a checkpoint of another model or
    optimizer raises instead of loading in part."""
    live = flatten_state(state)
    if set(flat) != set(live):
        missing, extra = sorted(set(live) - set(flat)), sorted(set(flat) - set(live))
        raise KeyError(f"checkpoint does not fit the state: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for k, target in live.items():
        src = flat[k]
        if src.shape != target.shape or src.dtype != target.dtype:
            raise ValueError(f"checkpoint {k}: {tuple(src.shape)} {src.dtype}, "
                             f"the state holds {tuple(target.shape)} {target.dtype}")
    with torch.no_grad():
        for k, target in live.items():
            target.copy_(flat[k])
    state.host_step = int(state.step)
    return state
