"""Bundle adjustment: Levenberg-Marquardt with Schur complement on device.

Replaces the reference's Ceres stack (src/Optimizer/CeresBundleOptimizer.cpp):
same residual model (angle-axis rotate + translate + pinhole f*x/z against
pre-undistorted observations, no distortion in BA), same solver policy
surface (dense Schur for small bundles, iterative for large), rebuilt as
fixed-shape batched JAX with a lax.while_loop trust-region driver.
"""

from monocularsfm_tpu.optim.ba import (
    BundleProblem,
    bundle_adjust,
    bundle_adjust_refine_focal,
    make_bundle_problem,
)

__all__ = [
    "BundleProblem",
    "bundle_adjust",
    "bundle_adjust_refine_focal",
    "make_bundle_problem",
]
