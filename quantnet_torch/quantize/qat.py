"""Quantization-aware training (counterpart of quantnet/quantize/qat.py):
finetune through fake quantization, then bake a deployable tree.

  1. `prepare` folds BN (the deployed graph is BN-folded), calibrates each
     quantizable layer's input range once with any observer, and marks the
     layer with a `FakeQuant` of that frozen range and its weight grid.
  2. The ordinary Trainer finetunes it: every marked layer computes with
     straight-through fake-quantized weights and activations
     (core/quantize.py::fake_quant_*_ste).
  3. `bake` quantizes the finetuned weights for real: the static contract
     (QTensor weights, ActQuant input domains, wsum corrections, per group
     for a grouped weight: W4A8), or the weight-only one for act_quant=False
     islands, with each quantized layer's GEMM constants. The result runs,
     evaluates, serves and saves as static.bake's does.

`dequantize_tree` turns a quantized tree (an AdaRound-refined W4A8 one, say)
back into f32 weights on its grid, to start a finetune from (prepare with
fold=False: the tree is folded already).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

from quantnet_torch.core.types import ActQuant, FakeQuant, QTensor
from quantnet_torch.ops.linear import gemm_constants, needs_gemm_constants
from quantnet_torch.quantize import static
from quantnet_torch.quantize.common import (
    first_layer_path,
    last_layer_path,
    quantize_weight,
    resolve_policy,
    walk_layers,
    weight_colsum,
)
from quantnet_torch.quantize.fold import fold_model


def prepare(
    params: dict,
    state: dict,
    apply_fn: Callable,
    calibration_batches: Iterable,
    *,
    observer: str = "minmax",
    per_channel: bool = True,
    skip_last_layer: bool = False,
    skip_first_layer: bool = False,
    layer_policy: Optional[dict] = None,
    weight_bits: int = 8,
    weight_group_size: Optional[int] = None,
    act_quant: bool = True,
    fold: bool = True,
) -> Tuple[dict, dict]:
    """FP32 (params, state) -> a QAT tree with 'fq' markers
    (quantnet/quantize/qat.py:59-136).

    skip_first_layer / skip_last_layer / layer_policy follow static.quantize
    (an explicit policy entry wins over the skip flags). Policy 'fp32' leaves
    a layer float for training and bake; 'int8' pins its weight to 8 bits
    inside a weight_bits=4 prepare (the int4 guard). weight_bits=4 with
    weight_group_size simulates the sub-byte grid; act_quant=False trains
    weight-only islands (no calibration). fold=False takes a folded tree.
    """
    if fold:
        params, state = fold_model(params, state)
    act_qparams = (static.calibrate(apply_fn, params, state, calibration_batches, observer=observer)
                   if act_quant else None)
    last, first = last_layer_path(params), first_layer_path(params)

    def q(path: str, layer: dict) -> dict:
        action = resolve_policy(path, "qat", layer_policy)
        explicit = bool(layer_policy) and (path in layer_policy or path.rsplit("/", 1)[-1] in layer_policy)
        skipped = (skip_last_layer and path == last) or (skip_first_layer and path == first)
        if action == "fp32" or (not explicit and skipped):
            return dict(layer)
        out = dict(layer)
        scale, zp = (1.0, 0) if act_qparams is None else act_qparams[path]
        lbits = 8 if action == "int8" else weight_bits
        out["fq"] = FakeQuant(
            float(scale), int(zp), per_channel, weight_bits=lbits,
            weight_group_size=weight_group_size if lbits == weight_bits else None,
            act_quant=act_quant,
        )
        return out

    return walk_layers(params, q), state


@torch.no_grad()
def bake(qat_params: dict) -> dict:
    """QAT tree -> deployable quantized tree (quantnet/quantize/qat.py:139-174).
    Layers without 'fq' stay f32."""

    def q(path: str, layer: dict) -> dict:
        fq = layer.get("fq")
        if fq is None:
            return dict(layer)
        out = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in layer.items() if k != "fq"}
        w = out["w"]
        qw = quantize_weight(w, fq.per_channel, bits=fq.weight_bits, group_size=fq.weight_group_size)
        out["w"] = qw
        if fq.act_quant:
            out["aq"] = ActQuant(scale=torch.tensor(fq.scale, dtype=torch.float32, device=w.device),
                                 zero_point=torch.tensor(fq.zero_point, dtype=torch.int32, device=w.device))
            out["wsum"] = weight_colsum(qw)
        if needs_gemm_constants(out):
            out["gemm"] = gemm_constants(out)
        return out

    return walk_layers(qat_params, q)


@torch.no_grad()
def dequantize_tree(qparams: dict) -> dict:
    """Quantized tree -> f32 tree, each QTensor weight rebuilt from its
    payload; 'aq', 'wsum', 'oq' and the GEMM constants dropped
    (quantnet/quantize/qat.py:177-194)."""

    def q(path: str, layer: dict) -> dict:
        out = {k: v for k, v in layer.items() if k not in ("aq", "wsum", "oq", "gemm")}
        if isinstance(layer["w"], QTensor):
            out["w"] = layer["w"].dequantize()
        return out

    return walk_layers(qparams, q)
