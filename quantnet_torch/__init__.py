"""quantnet_torch: the PyTorch + CUDA port of quantnet, for NVIDIA Hopper.

A package of its own beside the JAX package `quantnet`, which stays the
reference. Layouts, parameter trees and numerics follow the JAX package
(NHWC activations, HWIO / (K, N) weights, nested dicts of parameters), so the
two can be held against each other on the same numpy inputs.

Two deployments are ported: the dynamic-INT8 SimpleConvNet (init -> BN fold
-> dynamic INT8 with a bf16 inter-layer handoff -> forward) and the
static-INT8 ResNet (init -> BN fold -> min-max calibration -> static INT8
bake with int8 handoffs -> forward). Their kernels, one for each Pallas kernel
of the JAX package (an int8 GEMM, the fused dynamic-quant GEMM, the ResNet
block boundary), are hand-written CUDA (quantnet_torch/csrc), built with nvcc
at first use and loaded with ctypes (quantnet_torch/_build.py).
"""
