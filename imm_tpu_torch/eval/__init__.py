from imm_tpu_torch.eval.export import (
    export_landmarker,
    export_swap_generator,
    landmark_fn,
    load_landmarker,
    load_landmarker_file,
    load_swap_generator,
    save_landmarker,
)
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
    "export_landmarker",
    "load_landmarker",
    "export_swap_generator",
    "load_swap_generator",
    "save_landmarker",
    "load_landmarker_file",
    "pose_swap",
    "swap_fn",
]
