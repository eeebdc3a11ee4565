"""quantnet_torch: the PyTorch + CUDA port of quantnet, for NVIDIA Hopper.

A package of its own beside the JAX package `quantnet`, which stays the
reference. Layouts, parameter trees and numerics follow the JAX package
(NHWC activations, HWIO / (K, N) weights, nested dicts of parameters), so the
two can be held against each other on the same numpy inputs.

This slice serves the dynamic-INT8 SimpleConvNet: init -> BN fold -> dynamic
INT8 quantize with a bf16 inter-layer handoff -> forward. Its two int8 GEMMs
are hand-written CUDA kernels (quantnet_torch/csrc), built with nvcc at first
use and loaded with ctypes (quantnet_torch/_build.py).
"""
