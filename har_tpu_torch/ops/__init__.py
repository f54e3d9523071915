"""Kernels and their plain versions, and the evaluation battery."""
