"""Operators of the port; the hand-written CUDA kernels live in :mod:`.cuda`."""
