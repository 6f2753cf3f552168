"""Compute ops: the chain, assembly, Schur reduction, PCG and the CUDA kernel wrappers."""
