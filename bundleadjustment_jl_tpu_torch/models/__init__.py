from bundleadjustment_jl_tpu_torch.models.problem import BAProblem  # noqa: F401
