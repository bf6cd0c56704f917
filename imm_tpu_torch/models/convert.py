"""Weights from the JAX package's flax variables to the port's ``state_dict``.

Input: the ``{"params": ..., "batch_stats": ...}`` tree as nested dicts of
arrays, or the same tree flattened to ``/``-joined keys (as an ``.npz`` file
holds it, e.g. ``params/decoder/to_rgb/kernel``). Mapping:

- conv ``kernel`` (kh, kw, cin, cout) -> ``weight`` (cout, cin, kh, kw);
- conv ``bias`` as it is (``heatmap_head``, ``to_rgb``, norm='none' blocks);
- ``BatchNorm_0`` / ``GroupNorm_0`` ``scale``/``bias`` -> ``weight``/``bias``;
- ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

Module paths: ``content_encoder/trunk/ConvBlock_{i}`` ->
``content_encoder.trunk.blocks.{i}``, the same under ``pose_encoder``,
``pose_encoder/heatmap_head``, ``decoder/ConvBlock_{i}`` ->
``decoder.blocks.{i}``, ``decoder/to_rgb``.

The same mapping carries a single collection (``collection_from_flax``: a
parameter, gradient or optimizer-moment tree to the port's parameter names)
and runs backwards (``to_flax``), so a test can compare one optimizer step
leaf by leaf. ``vgg_from_flax`` and ``tps_params_to_numpy`` carry the VGG
parameters and warp parameters across as numpy.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def flatten_variables(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts of arrays -> ``{"a/b/c": array}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(value, "items"):
            flat.update(flatten_variables(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _module_path(parts: list[str]) -> str:
    out = []
    for p in parts:
        m = re.fullmatch(r"ConvBlock_(\d+)", p)
        if m:
            out += ["blocks", m.group(1)]
        elif p == "Conv_0":
            out.append("conv")
        elif p in ("BatchNorm_0", "GroupNorm_0"):
            out.append("norm")
        elif p in ("s2d_kernel", "s2d_bias"):
            raise NotImplementedError(
                "space-to-depth entry convs are not ported yet: ROADMAP.md, Queue 1 item 12"
            )
        else:
            out.append(p)
    return ".".join(out)


def from_flax(variables) -> dict[str, torch.Tensor]:
    """flax variables (nested, flat, or an ``.npz`` path) -> port ``state_dict``."""
    if isinstance(variables, (str, bytes)) or hasattr(variables, "__fspath__"):
        with np.load(variables) as npz:
            flat = {k: npz[k] for k in npz.files}
    elif any(hasattr(v, "items") for v in variables.values()):
        flat = flatten_variables(variables)
    else:
        flat = {k: np.asarray(v) for k, v in variables.items()}
    state = {}
    for key, value in flat.items():
        collection, *parts = key.split("/")
        leaf = _LEAF.get((collection, parts[-1]))
        if leaf is None:
            raise KeyError(f"unexpected flax variable {key!r}")
        if parts[-1] == "kernel":
            if value.ndim != 4:
                raise ValueError(f"{key}: expected a (kh, kw, cin, cout) kernel, got {value.shape}")
            value = value.transpose(3, 2, 0, 1)
        name = f"{_module_path(parts[:-1])}.{leaf}"
        state[name] = torch.tensor(value, dtype=torch.float32)
    return state


def load_flax_weights(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax variables into ``model`` in place (strict: every key must
    match), keeping the model's device. Returns the model."""
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def save_npz(variables, path) -> None:
    """Write flax variables (nested dicts of arrays) to an ``.npz`` that
    ``from_flax`` and ``cli.generate --weights`` read."""
    np.savez(path, **flatten_variables(variables))


def collection_from_flax(tree, collection: str = "params") -> dict[str, torch.Tensor]:
    """One flax collection (nested dicts: parameters, their gradients, Adam
    moments, or ``batch_stats``) -> tensors under the port's names."""
    return from_flax({collection: tree})


def to_flax(state: dict, norm: str = "batch") -> dict:
    """The port's ``state_dict`` (or any dict under its names) -> flax
    variables ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
    arrays: the inverse of ``from_flax``. ``norm`` names the norm layer
    (``BatchNorm_0`` for 'batch', ``GroupNorm_0`` for 'group')."""
    norm_name = {"batch": "BatchNorm_0", "group": "GroupNorm_0"}.get(norm, "BatchNorm_0")
    out: dict = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        value = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        parts, under_norm, i = [], False, 0
        while i < len(path):
            if path[i] == "blocks":
                parts.append(f"ConvBlock_{path[i + 1]}")
                i += 2
                continue
            if path[i] == "conv":
                parts.append("Conv_0")
            elif path[i] == "norm":
                parts.append(norm_name)
                under_norm = True
            else:
                parts.append(path[i])
            i += 1
        if leaf in ("running_mean", "running_var"):
            collection, key = "batch_stats", leaf[len("running_"):]
        elif under_norm:
            collection, key = "params", {"weight": "scale", "bias": "bias"}[leaf]
        elif leaf == "weight":
            collection, key, value = "params", "kernel", value.transpose(2, 3, 1, 0)
        else:
            collection, key = "params", "bias"
        node = out.setdefault(collection, {})
        for part in parts:
            node = node.setdefault(part, {})
        node[key] = value
    return out


def vgg_from_flax(params) -> dict:
    """VGG16 parameters of the JAX package (the flax tree, or the path of an
    ``.npz`` either package wrote) -> the numpy tree that
    ``VGG16Features.load_params`` and ``ReconstructionLoss(vgg_params=...)``
    take."""
    if isinstance(params, (str, bytes)) or hasattr(params, "__fspath__"):
        from imm_tpu_torch.models.vgg import load_vgg16_params

        return load_vgg16_params(params)
    return {
        name: {"kernel": np.asarray(leaf["kernel"], np.float32),
               "bias": np.asarray(leaf["bias"], np.float32)}
        for name, leaf in params.items()
    }


def tps_params_to_numpy(params) -> tuple[np.ndarray, ...]:
    """``TPSParams`` of either package -> (rot, log_scale, trans, cp_delta) as
    float32 numpy arrays."""
    return tuple(
        x.detach().cpu().numpy().astype(np.float32) if isinstance(x, torch.Tensor)
        else np.asarray(x, np.float32)
        for x in params
    )
