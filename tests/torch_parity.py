"""Shared set-up of the parity tests between ``imm_tpu`` and ``imm_tpu_torch``:
one tiny model config, flax variables with every scale, bias and running
statistic moved off its initial value (so a wrong mapping shows), and the
port's model carrying the same weights."""

import jax
import numpy as np
import torch

from imm_tpu.models.imm import IMMConfig as JaxIMMConfig
from imm_tpu.models.imm import init_model as jax_init_model
from imm_tpu_torch.models.convert import load_flax_weights
from imm_tpu_torch.models.imm import IMM, IMMConfig

TINY = dict(
    n_landmarks=5,
    image_size=32,
    filters=(8, 8, 16, 16),
    strides=(1, 2, 1, 2),
    decoder_filters=(16, 8, 8),
)


def _perturb(tree, rng):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = _perturb(value, rng)
            continue
        v = np.asarray(value)
        if key in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif key in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        out[key] = v
    return out


def jax_model(norm="batch", compute_dtype="float32", seed=0, **overrides):
    """-> (flax module, variables as nested dicts of numpy arrays)."""
    cfg = JaxIMMConfig(**{**TINY, **overrides}, norm=norm, compute_dtype=compute_dtype)
    model, variables = jax_init_model(jax.random.PRNGKey(seed), cfg, batch=2)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = _perturb(
        {k: dict(v) for k, v in variables.items()}, np.random.default_rng(seed + 100)
    )
    return model, variables


def port_model(variables, norm="batch", compute_dtype="float32", **overrides) -> IMM:
    """The port's model on the CPU, carrying ``variables``."""
    cfg = IMMConfig(**{**TINY, **overrides}, norm=norm, compute_dtype=compute_dtype)
    return load_flax_weights(IMM(cfg), variables)


def images(seed, batch=3, size=32):
    return np.random.default_rng(seed).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)


def t(x):
    """numpy or JAX array -> float32 CPU tensor (a copy)."""
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def n(x):
    """tensor or JAX array -> float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


