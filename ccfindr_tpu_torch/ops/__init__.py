"""Numerical core: the VB math (vb.py), its CUDA kernels (kernels/)
and the consensus helpers."""
