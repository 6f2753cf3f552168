"""Compute ops: residuals, the Jacobian chain, assembly, Schur reduction,
PCG, CGLS and the CUDA kernel wrappers."""

from bundleadjustment_jl_tpu_torch.ops.residuals import (  # noqa: F401
    objective, residuals)
from bundleadjustment_jl_tpu_torch.ops.jacobian import (  # noqa: F401
    jacobian_blocks_ad, residuals_and_jacobian)
from bundleadjustment_jl_tpu_torch.ops.normal import (  # noqa: F401
    GNBlocks, assemble_blocks, damp, gradient_norm, inv3x3)
from bundleadjustment_jl_tpu_torch.ops.schur import (  # noqa: F401
    SchurSystem, assemble_dense_schur, back_substitute, predicted_reduction,
    reduce_system, schur_diag_blocks, schur_matvec, solve_dense)
from bundleadjustment_jl_tpu_torch.ops.pcg import (  # noqa: F401
    PCGResult, block_cho_solve, block_cholesky, forcing_rtol, pcg,
    power_series)
from bundleadjustment_jl_tpu_torch.ops.cgls import (  # noqa: F401
    CGLSResult, cgls_solve, j_matvec, jt_matvec)
from bundleadjustment_jl_tpu_torch.ops.seg_reduce import (  # noqa: F401
    wt_cam_reduce, wtv_point_reduce)
