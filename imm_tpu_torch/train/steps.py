"""Train/eval step factories. Mirrors ``imm_tpu.train.steps``.

A step function is ``(state, gen) -> (state, metrics)`` (on-device data) or
``(state, batch, gen) -> (state, metrics)`` (host-fed): ``gen`` is a
``torch.Generator`` on the state's device, where the JAX package passes a
PRNG key. The state is updated in place and returned. ``metrics`` are 0-d
tensors on the device; nothing in a step reads a tensor back to the host.

``scan_steps`` (``TrainConfig.steps_per_call``) keeps its meaning: that many
optimizer steps per call, metrics averaged by ``_scan_mean``. Here it is a
plain Python loop; there is no dispatch cost to amortize as there was through
``lax.scan``.

Data parallelism (``mesh`` of more than one rank, ``parallel.mesh``): every
rank runs the step on its share of the batch and averages what the JAX
step ``pmean``s under ``shard_map`` — the loss terms (in the loss and here),
BatchNorm's statistics (in the model, whose config carries
``axis_name='data'``) and the gradients, as one flat buffer after
``torch.autograd.grad``. The model is not wrapped in DDP: its reducer syncs
only ``.grad``, which this step never fills. Every rank then applies the
same update to the same state.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Callable
from typing import Any

import torch

from imm_tpu_torch.data.pairs import PairSynthesizer
from imm_tpu_torch.losses.perceptual import ReconstructionLoss
from imm_tpu_torch.models.imm import IMM
from imm_tpu_torch.models.nets import batch_stats_frozen
from imm_tpu_torch.ops.coords import marginal_distributions
from imm_tpu_torch.ops.tps import tps_transform_points
from imm_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_flat
from imm_tpu_torch.train.state import Optimizer, TrainState, make_optimizer
from imm_tpu_torch.utils.config import TrainConfig
from imm_tpu_torch.utils.profiling import span

Metrics = dict[str, torch.Tensor]


def _scan_mean(metrics: Metrics) -> Metrics:
    """Average per-step metrics, each stacked ``(scan,)``, over a window.

    With the NaN guard active, skipped steps report their metrics as 0.0
    (see ``_single_step``); a plain mean would bias the window toward zero —
    a spuriously *improving* loss exactly when training is unhealthy. Weight
    by the ok-mask instead, so the window mean is over executed steps only;
    ``nonfinite_step`` itself stays a plain mean (the skipped fraction).
    """
    nf = metrics.get("nonfinite_step")
    if nf is None:
        return {k: v.mean() for k, v in metrics.items()}
    ok = 1.0 - nf  # (scan,) 1 where the step executed
    denom = torch.clamp(ok.sum(), min=1.0)
    return {
        k: v.mean() if k == "nonfinite_step" else (v * ok).sum() / denom
        for k, v in metrics.items()
    }


def landmark_separation_loss(coords: torch.Tensor, margin: float) -> torch.Tensor:
    """Hinge repulsion on pairwise landmark distances (pair-mean, scalar).

    ``coords``: (B, K, 2) in [-1, 1] units. Returns
    ``mean_B mean_{i != j} relu(margin - d_ij)^2`` — exactly zero once every
    landmark pair sits >= margin apart.
    """
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    dist = torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-12)
    k = coords.shape[1]
    off_diag = 1.0 - torch.eye(k, dtype=dist.dtype, device=dist.device)
    hinge = torch.square(torch.clamp(margin - dist, min=0.0)) * off_diag
    return torch.mean(torch.sum(hinge, dim=(1, 2)) / (k * (k - 1)))


def marginal_entropy_loss(heatmaps: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Normalized entropy of the spatial-softmax marginals (scalar).

    ``heatmaps``: (B, H, W, K) raw pose-encoder activations. The Shannon
    entropy of the same y/x marginal distributions the coordinate readout
    uses (``ops.coords.marginal_distributions``, same temperature), divided
    by log(n) per axis so 1.0 = uniform; the mean over batch, landmarks and
    both axes.

    The plain ``marginal_distributions`` is the single definition of "the
    marginals" even when the bottleneck runs its kernels, which recompute the
    same softmax and are held to this definition, forward and gradient.
    """
    py, px = marginal_distributions(heatmaps, temperature)

    def _ent(p, axis_n):
        e = -torch.sum(p * torch.log(p + 1e-12), dim=1)  # (B, K) nats
        return e / math.log(float(axis_n))

    ent_y = _ent(py, heatmaps.shape[1])
    ent_x = _ent(px, heatmaps.shape[2])
    return torch.mean(0.5 * (ent_y + ent_x))


def _single_step(
    model: IMM,
    loss_fn: ReconstructionLoss,
    optimizer: Optimizer,
    state: TrainState,
    source: torch.Tensor,
    target: torch.Tensor,
    nan_guard: bool = False,
    mesh: Mesh | None = None,
    equi: tuple | None = None,
    sep: tuple | None = None,
    ent: tuple | None = None,
    ema_decay: float = 0.0,
) -> tuple[TrainState, Metrics]:
    """One optimizer update given an already-synthesized (source, target).
    Updates ``state`` (and ``model``, which it holds) in place.

    ``mesh``: the data-parallel group (the JAX package's ``axis_name``):
    the loss's raw terms and the equi, sep and ent terms are averaged across
    its ranks for the EMA and the metrics, and the gradients, with the total
    loss, through one flat all-reduce. The NaN guard reads the averaged loss
    and gradient, so every rank skips the same steps.

    ``equi``: optional ``(view, params_v, params_t, n_grid, weight)`` — the
    equivariance extension: run the pose encoder on an auxiliary ``view``
    whose analytic warp ``params_v`` is known, and penalize disagreement with
    the main pass's coordinates after mapping both into a shared frame. TPS
    mode: view = source, the shared frame is the base image (``params_t``
    maps target coords into it). Temporal mode: view = a fresh known warp of
    the target, the shared frame is the target (``params_t=None``).

    ``sep``: optional ``(weight, margin)`` — the landmark-separation hinge.
    ``ent``: optional ``(weight, temperature)`` — the marginal-entropy term.

    ``nan_guard``: a step whose loss or gradient is not finite changes
    nothing — parameters, optimizer state, parameter EMA, ``loss_ema`` and
    BatchNorm statistics are all gated on one device-side flag — and reports
    ``nonfinite_step`` = 1 with its other metrics as 0.
    """
    model.train()
    params = dict(model.named_parameters())
    stats = dict(model.named_buffers())
    old_stats = {k: v.clone() for k, v in stats.items()} if nan_guard else None

    with span("imm.forward"):
        out = model(source, target)
    with span("imm.loss"):
        total, new_ema, metrics = loss_fn(out.recon, target, state.loss_ema, state.host_step, mesh)
    metrics = dict(metrics)
    if equi is not None:
        with span("imm.equivariance"):
            view, params_v, params_t, n_grid, w_equi = equi
            # Extra pose pass on the auxiliary view; its BatchNorm statistics
            # are discarded (the main pass owns the running stats).
            with batch_stats_frozen(model):
                view_coords, _ = model.encode_pose(view)
            base_s = tps_transform_points(params_v, view_coords, n_grid)
            base_t = (
                out.coords if params_t is None
                else tps_transform_points(params_t, out.coords, n_grid)
            )
            equi_loss = torch.mean(torch.sum(torch.square(base_s - base_t), dim=-1))
            total = total + w_equi * equi_loss
            metrics["loss/equi"] = equi_loss.detach()
    if sep is not None or ent is not None:
        with span("imm.regularizers"):
            if sep is not None:
                w_sep, margin = sep
                sep_loss = landmark_separation_loss(out.coords, margin)
                total = total + w_sep * sep_loss
                metrics["loss/sep"] = sep_loss.detach()
            if ent is not None:
                w_ent, temp = ent
                ent_loss = marginal_entropy_loss(out.heatmaps, temp)
                total = total + w_ent * ent_loss
                metrics["loss/ent"] = ent_loss.detach()

    with span("imm.backward"):
        grad_list = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    with span("imm.update"), torch.no_grad():
        grads = {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grad_list)
        }
        loss = total.detach()
        if mesh is not None and mesh.size > 1:
            # one all-reduce: the gradients, the total loss and the terms
            # that the loss did not average itself
            terms = [k for k in ("loss/equi", "loss/sep", "loss/ent") if k in metrics]
            avg = all_reduce_mean_flat([*grads.values(), loss, *(metrics[k] for k in terms)], mesh)
            grads = dict(zip(grads, avg))
            loss = avg[len(grads)]
            metrics.update(zip(terms, avg[len(grads) + 1:]))
        if optimizer.runs_k6(loss.device):
            # K6 (ops/adam.py): the same update in place, parameters, moments,
            # count and EMA gated on the guard's flag on the device
            out = optimizer.update_in_place(grads, state.opt_state, params, state.ema_params,
                                            loss, ema_decay, nan_guard)
        else:
            new_params, state.opt_state, state.ema_params, out = optimizer.update_per_leaf(
                grads, state.opt_state, params, state.ema_params, loss, ema_decay, nan_guard)
            for k, p in params.items():
                p.copy_(new_params[k])
        if nan_guard:
            # the rest of a skipped step: the loss EMA, the BatchNorm
            # statistics and the metrics
            ok = out.nonfinite == 0
            new_ema = torch.where(ok, new_ema, state.loss_ema)
            for k, v in stats.items():
                v.copy_(torch.where(ok, v, old_stats[k]))
            zero = torch.zeros_like(loss)
            metrics = {k: torch.where(ok, v, zero) for k, v in metrics.items()}
            metrics["nonfinite_step"] = out.nonfinite
        metrics["loss/total"] = out.loss
        metrics["grad_norm"] = out.grad_norm
        state.step = state.step + 1
        state.host_step += 1
        state.loss_ema = new_ema
    return state, metrics


def _check_equi(train_config: TrainConfig, pair_synth: PairSynthesizer, pair_mode: str) -> bool:
    """Validate the equivariance extension's preconditions."""
    if train_config.equi_weight <= 0:
        return False
    if pair_mode == "tps" and not pair_synth.config.enable_warp:
        raise ValueError(
            "train.equi_weight in TPS pair mode needs warping enabled — "
            "the objective maps predicted coordinates through the analytic "
            "pair warps (temporal mode instead synthesizes its own known "
            "warp of the target, so enable_warp is not required there)"
        )
    if len(train_config.equi_factors) != len(train_config.equi_boundaries) + 1:
        raise ValueError(
            "train.equi_factors must have one more entry than "
            f"train.equi_boundaries, got {train_config.equi_factors} / "
            f"{train_config.equi_boundaries}"
        )
    return True


def _equi_weight_schedule(train_config: TrainConfig) -> Callable[[int], float]:
    """Step (a host integer) -> effective equivariance weight.

    Piecewise-constant like the LR schedule: ``equi_weight`` scaled by
    ``equi_factors[i]`` between boundaries. A direct segment lookup rather
    than optax's cumulative-ratio form, which ignores a non-unit
    ``factors[0]`` and divides by zero on a 0.0 factor."""
    base = train_config.equi_weight
    boundaries = train_config.equi_boundaries
    factors = train_config.equi_factors

    def schedule(step: int) -> float:
        return base * factors[sum(step >= b for b in boundaries)]

    return schedule


def _make_step(model, loss_fn, train_config, pair_synth, pair_mode, scan_steps, mesh, get_batch):
    """The step function shared by both factories. ``get_batch(gen, batch, i)``
    yields iteration ``i``'s data: drawn from ``gen``, or sliced from the
    host-fed ``batch``."""
    if pair_mode not in ("tps", "temporal"):
        raise ValueError(f"unknown pair mode: {pair_mode!r}")
    mesh = mesh if (mesh is not None and mesh.size > 1) else None
    if mesh is not None and model.config.norm == "batch" and model.config.axis_name is None:
        raise ValueError(
            "a data-parallel step over BatchNorm needs the model config's "
            "axis_name='data', or each rank would normalise with its own statistics"
        )
    tc = train_config
    optimizer = make_optimizer(tc)
    use_equi = _check_equi(tc, pair_synth, pair_mode)
    equi_w = _equi_weight_schedule(tc)
    sep = (tc.sep_weight, tc.sep_margin) if tc.sep_weight > 0 else None
    ent = (tc.ent_weight, model.config.temperature) if tc.ent_weight > 0 else None
    n_grid = pair_synth.config.n_grid

    def synth(gen, batch):
        """-> (source, target, equi tuple without its weight, or None)."""
        with torch.no_grad():
            if pair_mode == "tps":
                s, t, ps, pt = pair_synth.pair_with_params(gen, batch["image"])
                return s, t, ((s, ps, pt, n_grid) if use_equi else None)
            s, t = pair_synth.temporal_pair(gen, batch["image_a"], batch["image_b"])
            if not use_equi:
                return s, t, None
            view, pv = pair_synth.warp_view(gen, t)
            return s, t, (view, pv, None, n_grid)

    def one(state, gen, batch, i):
        with span("imm.train_step"):
            with span("imm.pairs"):
                source, target, equi = synth(gen, get_batch(gen, batch, i))
            if equi is not None:
                # scheduled on the live step, so windows of several steps and
                # (later) resumed runs land on the same schedule position
                equi = (*equi, equi_w(state.host_step))
            return _single_step(
                model, loss_fn, optimizer, state, source, target,
                nan_guard=tc.skip_nonfinite_updates, mesh=mesh, equi=equi, sep=sep, ent=ent,
                ema_decay=tc.param_ema_decay,
            )

    def step_fn(state, gen, batch=None):
        if scan_steps == 1:
            return one(state, gen, batch, None)
        window = []
        for i in range(scan_steps):
            state, metrics = one(state, gen, batch, i)
            window.append(metrics)
        return state, _scan_mean({k: torch.stack([m[k] for m in window]) for k in window[0]})

    return step_fn


def make_train_step(
    model: IMM,
    loss_fn: ReconstructionLoss,
    train_config: TrainConfig,
    pair_synth: PairSynthesizer,
    pair_mode: str = "tps",
    scan_steps: int = 1,
    mesh=None,
) -> Callable[[TrainState, dict[str, Any], torch.Generator], tuple[TrainState, Metrics]]:
    """Host-fed step ``(state, batch, gen)``. ``batch`` keys: 'image' (tps) or
    'image_a'/'image_b' (temporal), tensors on the state's device. With
    ``scan_steps > 1`` the returned metrics are averaged over the window, and
    ``batch`` is either such a dict whose every leaf has an extra leading
    axis of that length, or an iterator that yields the window's batches one
    by one, each taken as its step starts (the experiment's stream: no
    (scan_steps, B, ...) tensor is built).

    ``mesh`` (``parallel.mesh.Mesh`` of several ranks): each rank is handed
    its own share of the global batch (``batch_size / mesh.size`` images)
    and the step averages across the ranks; the model config must carry
    ``axis_name='data'`` under BatchNorm.
    """

    def get_batch(gen, batch, i):
        if i is None:
            return batch
        if isinstance(batch, dict):
            return {k: v[i] for k, v in batch.items()}
        return next(batch)

    step = _make_step(
        model, loss_fn, train_config, pair_synth, pair_mode, scan_steps, mesh, get_batch
    )
    return lambda state, batch, gen: step(state, gen, batch)


def make_synthetic_train_step(
    model: IMM,
    loss_fn: ReconstructionLoss,
    train_config: TrainConfig,
    pair_synth: PairSynthesizer,
    sample_batch: Callable[[torch.Generator], dict[str, torch.Tensor]],
    pair_mode: str = "tps",
    scan_steps: int = 1,
    mesh=None,
) -> Callable[[TrainState, torch.Generator], tuple[TrainState, Metrics]]:
    """Fully on-device step ``(state, gen)``: ``sample_batch(gen)`` generates
    {'image': ...} or {'image_a', 'image_b'} on the device, so each of the
    ``scan_steps`` iterations is generate -> synthesize -> forward ->
    backward -> update with no host data.

    ``mesh`` (of several ranks): ``sample_batch`` must accept ``(gen,
    local_batch)``, and each rank draws ``batch_size / mesh.size`` images
    from its own generator (the trainer folds the rank into its seed).
    """
    local = None
    if mesh is not None and mesh.size > 1:
        if train_config.batch_size % mesh.size:
            raise ValueError(
                f"global batch {train_config.batch_size} not divisible by {mesh.size} ranks"
            )
        local = train_config.batch_size // mesh.size

    def get_batch(gen, batch, i):
        with torch.no_grad():
            return sample_batch(gen) if local is None else sample_batch(gen, local)

    return _make_step(
        model, loss_fn, train_config, pair_synth, pair_mode, scan_steps, mesh, get_batch
    )


@contextlib.contextmanager
def _params_swapped(model: IMM, params: dict[str, torch.Tensor] | None):
    """Within the block ``model`` computes with ``params`` (by name) in place
    of its own parameters."""
    if params is None:
        yield
        return
    own = dict(model.named_parameters())
    saved = {k: p.data for k, p in own.items()}
    try:
        for k, p in own.items():
            p.data = params[k]
        yield
    finally:
        for k, p in own.items():
            p.data = saved[k]


def make_eval_coords_fn(model: IMM):
    """Batched pose-encoder sweep: ``coords_fn(images, params=None)`` ->
    (B, K, 2) coords in eval mode without gradients, with the model's own
    parameters or a given set (the parameter EMA); BatchNorm statistics are
    the model's either way."""

    def coords_fn(images: torch.Tensor, params=None) -> torch.Tensor:
        model.eval()
        with _params_swapped(model, params), torch.inference_mode():
            coords, _ = model.encode_pose(images)
        return coords

    return coords_fn
