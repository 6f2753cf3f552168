"""The benchmark layer (PyTorch port of `bundleadjustment_jl_tpu/benchmark`):
problem suites, the campaign runner and its tables, and the precision
cascade."""

from bundleadjustment_jl_tpu_torch.benchmark.precision import (  # noqa: F401
    facto_bytes, facto_solve, precision_cascade)
from bundleadjustment_jl_tpu_torch.benchmark.problems import (  # noqa: F401
    BAL_SIZES, bal_suite, pad_problem, pad_to_buckets, synthetic_suite)
from bundleadjustment_jl_tpu_torch.benchmark.runner import (  # noqa: F401
    latex_table, load_stats, markdown_table, performance_profile,
    run_campaign, save_stats)
