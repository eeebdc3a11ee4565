"""Static PTQ (counterpart of quantnet/quantize/static.py:39-304).

Calibration runs the BN-folded model eagerly over the calibration batches
with a `capture` dict, which records every quantizable layer's input; one
observer per capture key turns them into frozen affine (scale, zero_point).
The bake quantizes every weight to int8 (per output channel by default) and
attaches to each layer its input's `ActQuant` under 'aq' and the weight's
column sums under 'wsum'; with `pre_add_quant`, residual-branch outputs get an
'oq' as well. Each quantized layer keeps its GEMM kernels' frozen operands
under 'gemm' (ops/linear.py::gemm_constants). The model's apply then runs
int8 x int8 GEMMs and hands int8 tensors from layer to layer.

The JAX package bakes under jit; the port takes the same divisions as XLA
does there (quantnet_torch/core/quantize.py), so both bake the same bits from
the same folded params and activation statistics. `weight_bits=4` is the
W4A8 tier: 4-bit weights inside the same int8-activation path, group-wise
scales along K for dense layers (`weight_group_size`), per channel for convs.
The cross-process observer merge comes with a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from quantnet_torch.core.observers import make_observer
from quantnet_torch.core.types import ActQuant
from quantnet_torch.ops.linear import gemm_constants
from quantnet_torch.quantize.common import (
    first_layer_path,
    last_layer_path,
    quantize_weight,
    resolve_policy,
    walk_layers,
    weight_colsum,
)
from quantnet_torch.quantize.fold import fold_model

# apply_fn(params, state, x, capture=dict) -> (logits, state)
ApplyFn = Callable
QParams = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def calibrate(
    apply_fn: ApplyFn,
    params: dict,
    state: dict,
    batches: Iterable,
    *,
    observer: str = "minmax",
    observer_kwargs: Optional[dict] = None,
    include_output_stats: bool = False,
    cross_process: bool = True,
) -> QParams:
    """Run the calibration batches through the BN-folded model and return
    {layer_path: (scale, zero_point)}. A batch is an image tensor or a tuple
    whose first item is one. ':out' keys (pre-add residual statistics) are
    observed only with include_output_stats. With cross_process (a no-op in
    one process) the observers of every rank are merged first."""
    obs = observe(apply_fn, params, state, batches, observer=observer,
                  observer_kwargs=observer_kwargs, include_output_stats=include_output_stats)
    if cross_process:
        obs = merge_across_processes(obs)
    return {k: o.qparams() for k, o in obs.items()}


@torch.no_grad()
def observe(
    apply_fn: ApplyFn,
    params: dict,
    state: dict,
    batches: Iterable,
    *,
    observer: str = "minmax",
    observer_kwargs: Optional[dict] = None,
    include_output_stats: bool = False,
) -> dict:
    """{layer_path: observer} after the calibration batches (this process's)."""
    observer_kwargs = observer_kwargs or {}
    obs: dict = {}
    for batch in batches:
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        cap: dict = {}
        apply_fn(params, state, x, capture=cap)
        for key, value in cap.items():
            if include_output_stats or ":out" not in key:
                if key not in obs:
                    obs[key] = make_observer(observer, **observer_kwargs)
                obs[key].update(value)
    if not obs:
        raise ValueError("calibration saw no batch")
    return obs


def merge_across_processes(obs: dict) -> dict:
    """Every rank's observers gathered once, in rank order, through the host,
    and folded with merge_all key by key; the merged observers lie where
    this rank's did. The same on every rank, bit for bit. One process: obs."""
    from quantnet_torch.parallel.mesh import gather_objects, process_count

    if process_count() == 1:
        return obs
    gathered = gather_objects({k: o.to("cpu") for k, o in obs.items()})
    return {k: type(o).merge_all([g[k] for g in gathered]).to(o.device) for k, o in obs.items()}


def quantize(
    params: dict,
    state: dict,
    apply_fn: ApplyFn,
    calibration_batches: Iterable,
    *,
    observer: str = "minmax",
    per_channel: bool = True,
    skip_last_layer: bool = False,
    skip_first_layer: bool = False,
    pre_add_quant: bool = False,
    layer_policy: Optional[dict] = None,
    last_layer_name: Optional[str] = None,
    weight_bits: int = 8,
    weight_group_size: Optional[int] = None,
) -> Tuple[dict, dict]:
    """FP32 (params, state) -> statically quantized (params', {}): fold,
    calibrate, bake.

    skip_first_layer keeps the stem in fp32; its output still hands int8 to
    the next static layer. pre_add_quant quantizes the residual-branch
    outputs before the add wherever the model captured ':out' statistics.
    weight_bits=4 with weight_group_size (e.g. 128) is W4A8.
    """
    params, state = fold_model(params, state)
    act_qparams = calibrate(
        apply_fn, params, state, calibration_batches, observer=observer,
        include_output_stats=pre_add_quant,
    )
    return bake(
        params, state, act_qparams, per_channel=per_channel,
        skip_last_layer=skip_last_layer, skip_first_layer=skip_first_layer,
        pre_add_quant=pre_add_quant, layer_policy=layer_policy,
        last_layer_name=last_layer_name, weight_bits=weight_bits,
        weight_group_size=weight_group_size,
    )


@torch.no_grad()
def bake(
    params: dict,
    state: dict,
    act_qparams: QParams,
    *,
    per_channel: bool = True,
    skip_last_layer: bool = False,
    skip_first_layer: bool = False,
    pre_add_quant: bool = False,
    layer_policy: Optional[dict] = None,
    last_layer_name: Optional[str] = None,
    weight_bits: int = 8,
    weight_group_size: Optional[int] = None,
) -> Tuple[dict, dict]:
    """Bake the static tree from calibrated activation qparams. `params` must
    be BN-folded: the tree calibrate() saw. An explicit `layer_policy` entry
    (exact path or leaf name) wins over the skip flags; 'fp32' keeps a layer
    in fp32, and 'int8' keeps a layer's weight 8-bit per channel inside a
    weight_bits=4 bake. One calibration can feed several bakes (static INT8
    and W4A8 alike)."""
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
    last = last_layer_name or last_layer_path(params)
    first = first_layer_path(params)

    def q(path: str, layer: dict) -> dict:
        action = resolve_policy(path, "static", layer_policy)
        explicit = bool(layer_policy) and (
            path in layer_policy or path.rsplit("/", 1)[-1] in layer_policy
        )
        skipped = (skip_last_layer and path == last) or (skip_first_layer and path == first)
        if action == "fp32" or (not explicit and skipped):
            return dict(layer)
        out = dict(layer)
        # 'int8': the layer's weight stays 8-bit inside a 4-bit bake (the
        # activation path is the same either way), with no groups.
        lbits = 8 if action == "int8" else weight_bits
        qw = quantize_weight(
            layer["w"], per_channel, bits=lbits,
            group_size=weight_group_size if lbits == weight_bits else None,
        )
        out["w"] = qw
        scale, zp = act_qparams[path]
        out["aq"] = ActQuant(scale=scale, zero_point=zp)
        out["wsum"] = weight_colsum(qw)
        if pre_add_quant and f"{path}:out" in act_qparams:
            oscale, ozp = act_qparams[f"{path}:out"]
            out["oq"] = ActQuant(scale=oscale, zero_point=ozp)
        out["gemm"] = gemm_constants(out)
        return out

    qparams = walk_layers(params, q)
    _validate_sibling_domains(qparams)
    return qparams, state


def _validate_sibling_domains(qparams: dict) -> None:
    """A block whose conv1 and downsample are both static must give them the
    same input domain: the ResNet's downsample then takes the block's raw
    int8 input, which lies in conv1's domain (quantnet/models/resnet.py:383-397).
    Trees calibrated here always hold it (both observers saw one tensor)."""

    def walk(node):
        if not isinstance(node, dict):
            return
        c1, ds = node.get("conv1"), node.get("downsample")
        if (
            isinstance(c1, dict) and isinstance(ds, dict)
            and isinstance(c1.get("aq"), ActQuant) and isinstance(ds.get("aq"), ActQuant)
        ):
            a, b = c1["aq"], ds["aq"]
            if not (torch.equal(a.scale, b.scale) and torch.equal(a.zero_point, b.zero_point)):
                raise ValueError(
                    "static PTQ invariant violated: downsample input ActQuant differs from "
                    "conv1's within one block; the raw-int8 downsample handoff requires "
                    "identical domains"
                )
        for v in node.values():
            if isinstance(v, dict) and "w" not in v:
                walk(v)

    walk(qparams)
