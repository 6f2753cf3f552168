from bundleadjustment_jl_tpu_torch.io.bal import load_fixture, read_bal, write_bal  # noqa: F401
from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal  # noqa: F401
