from bundleadjustment_jl_tpu_torch.models.camera import (  # noqa: F401
    distortion_factor, project, project_p1, rodrigues_rotate)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem  # noqa: F401
