"""Pallas kernels: the fused path-tracing megakernel for NVIDIA GPUs."""
