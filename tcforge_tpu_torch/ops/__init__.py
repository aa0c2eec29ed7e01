"""Pixel ops and the CUDA kernels' wrappers."""
