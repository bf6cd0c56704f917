"""Landmark-regression evaluation protocol. Mirrors ``imm_tpu.eval.regression``.

Freeze the pose encoder, sweep it over the annotated train split, fit a
linear (ridge) regressor from the K predicted coordinates to the annotated
points, then report the mean L2 error on the test split normalized by
inter-ocular distance (faces, %IOD) or image size (H36M, % of image).
"""

from __future__ import annotations

import numpy as np
import torch

from imm_tpu_torch.utils.device import get_device


def _features(coords: torch.Tensor) -> torch.Tensor:
    """(N, K, 2) predicted coords -> (N, 2K+1) design matrix with bias."""
    flat = coords.reshape(coords.shape[0], -1)
    return torch.cat([flat, torch.ones_like(flat[:, :1])], dim=1)


def fit_landmark_regressor(
    pred_coords: torch.Tensor, gt_landmarks: torch.Tensor, ridge: float = 1e-5
) -> torch.Tensor:
    """Closed-form ridge regression (N, K, 2) -> (N, L, 2); returns the
    (2K+1, 2L) weights including the bias row."""
    x = _features(pred_coords)
    y = gt_landmarks.reshape(gt_landmarks.shape[0], -1)
    d = x.shape[1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    xtx = x.T @ x + ridge * x.shape[0] * eye
    return torch.linalg.solve(xtx, x.T @ y)


def predict_landmarks(w: torch.Tensor, pred_coords: torch.Tensor) -> torch.Tensor:
    """Apply the fitted regressor: (N, K, 2) -> (N, L, 2)."""
    return (_features(pred_coords) @ w).reshape(pred_coords.shape[0], -1, 2)


def landmark_error(
    predicted: torch.Tensor,
    gt: torch.Tensor,
    norm: str = "iod",
    iod_points: tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """Mean normalized L2 error in percent (``norm``: 'iod' | 'size')."""
    per_image = torch.linalg.norm(predicted - gt, dim=-1).mean(dim=-1)  # (N,)
    if norm == "iod":
        denom = torch.linalg.norm(gt[:, iod_points[0]] - gt[:, iod_points[1]], dim=-1)
    elif norm == "size":
        denom = torch.full_like(per_image, 2.0)
    else:
        raise ValueError(f"unknown normalization: {norm!r}")
    return 100.0 * torch.mean(per_image / torch.clamp(denom, min=1e-8))


def sweep_coords(coords_fn, images: np.ndarray, batch_size: int = 256, device=None) -> np.ndarray:
    """Batched pose-encoder sweep over a (possibly ragged) host array: the last
    chunk is zero-padded to ``batch_size`` so every call sees one shape."""
    dev = get_device(device)
    n = images.shape[0]
    outs = []
    for start in range(0, n, batch_size):
        chunk = images[start : start + batch_size]
        keep = chunk.shape[0]
        if keep < batch_size:
            chunk = np.concatenate(
                [chunk, np.zeros((batch_size - keep, *chunk.shape[1:]), chunk.dtype)], axis=0
            )
        c = coords_fn(torch.as_tensor(chunk, device=dev))
        outs.append(c[:keep].float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def evaluate_landmarks(
    coords_fn,
    train_split: dict[str, np.ndarray],
    test_split: dict[str, np.ndarray],
    norm: str = "iod",
    iod_points: tuple[int, int] = (0, 1),
    ridge: float = 1e-5,
    batch_size: int = 256,
    device=None,
) -> dict[str, float]:
    """The full protocol: sweep -> fit on train -> error on train and test.
    ``coords_fn`` maps an image batch on ``device`` to (B, K, 2) coords."""
    pred = {
        name: torch.as_tensor(sweep_coords(coords_fn, split["image"], batch_size, device))
        for name, split in (("train", train_split), ("test", test_split))
    }
    gt = {
        "train": torch.as_tensor(train_split["landmarks"]),
        "test": torch.as_tensor(test_split["landmarks"]),
    }
    w = fit_landmark_regressor(pred["train"], gt["train"], ridge)
    return {
        f"landmark_error_{name}_pct": float(
            landmark_error(predict_landmarks(w, pred[name]), gt[name], norm, iod_points)
        )
        for name in ("train", "test")
    }
