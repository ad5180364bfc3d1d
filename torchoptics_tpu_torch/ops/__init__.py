"""Tensor operations of the trace path and the kernel wrappers."""
