"""Transpose engine, distributed FFT and the CUDA kernels under them."""
