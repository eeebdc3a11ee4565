"""quantnet_torch: the PyTorch + CUDA port of quantnet, for NVIDIA Hopper.

A package of its own beside the JAX package `quantnet`, which stays the
reference. Layouts, parameter trees and numerics follow the JAX package
(NHWC activations, HWIO / (K, N) weights, nested dicts of parameters), so the
two can be held against each other on the same numpy inputs.

Ported: the SimpleConvNet, the ResNet at every depth and MobileNetV2
(training, QAT, BN fold, every quantization scheme, forward), artifacts, the
reference's `.pth` importer, the evaluator and bench, the continuous-batching
engine (quantnet_torch/serve, one CUDA graph per bucket) and the command
line (`python -m quantnet_torch`). Their kernels, one for each Pallas kernel
of the JAX package (an int8 GEMM, the fused dynamic-quant GEMM, the ResNet
block boundary) and a depthwise int8 conv, are hand-written CUDA
(quantnet_torch/csrc), built with nvcc at first use and loaded with ctypes
(quantnet_torch/_build.py).
"""
