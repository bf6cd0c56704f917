from imm_tpu_torch.eval.export import landmark_fn
from imm_tpu_torch.eval.regression import (
    evaluate_landmarks,
    fit_landmark_regressor,
    landmark_error,
    predict_landmarks,
)
from imm_tpu_torch.eval.swap import pose_swap, swap_fn

__all__ = [
    "fit_landmark_regressor",
    "predict_landmarks",
    "landmark_error",
    "evaluate_landmarks",
    "landmark_fn",
    "pose_swap",
    "swap_fn",
]
