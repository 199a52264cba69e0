"""Vectorized robust estimators: F / E / H / PnP, hypothesis-parallel RANSAC.

Reference parity: the reference delegates to OpenCV calib3d (cv::findHomography,
cv::findFundamentalMat, cv::findEssentialMat + recoverPose, cv::solvePnPRansac
— see src/Reconstruction/Initializer.cpp and Registrant.cpp).  Here RANSAC is
re-designed for an accelerator: all M hypotheses are sampled, solved
(batched SVD/eigh minimal solvers) and scored against all N candidates in a
single fixed-shape dispatch — M×N residual evaluation in parallel instead of
an adaptive sequential loop.
"""

from monocularsfm_tpu.estimators.fundamental import (
    estimate_fundamental_ransac,
    estimate_fundamental_ransac_batch,
)
from monocularsfm_tpu.estimators.essential import (
    estimate_essential_ransac,
    decompose_essential,
    recover_pose_from_essential,
)
from monocularsfm_tpu.estimators.homography import estimate_homography_ransac
from monocularsfm_tpu.estimators.pnp import estimate_pnp_ransac
from monocularsfm_tpu.estimators.ransac import (
    num_ransac_iterations,
    rounds_to_confidence,
)

__all__ = [
    "estimate_fundamental_ransac",
    "estimate_fundamental_ransac_batch",
    "estimate_essential_ransac",
    "decompose_essential",
    "recover_pose_from_essential",
    "estimate_homography_ransac",
    "estimate_pnp_ransac",
    "num_ransac_iterations",
    "rounds_to_confidence",
]
