"""Mixed-precision policy: per-layer scheme selection (counterpart of
quantnet/quantize/policy.py).

A sensitivity sweep measures each layer's quantization damage (the logits'
MSE against fp32 with only that layer quantized, through the real dispatch)
and `build_policy` turns it into a {path: scheme} table: the most sensitive
layers stay in bf16, the rest go weight-only int8 (or int4). The same sweep
with 4-bit weight-only lanes gives the sub-byte tiers' guard (`int4_guard`):
layers whose damage is an outlier keep 8-bit weights.

The sweep tags every layer with a `ProbeGate` and runs one forward per layer
with a one-hot row of gates. The gate is host data here, so each forward
runs one layer's quantized lane and every other layer's plain one; on the
card the quantized lanes run K1 (convs), K4 (depthwise convs) and K2 (dense
layers, Flags.dynamic_linear="fused"). The JAX package runs all the forwards
as one compiled program under `lax.map`.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from quantnet_torch.core.types import ProbeGate
from quantnet_torch.quantize.common import layer_paths, quantize_weight, walk_layers
from quantnet_torch.quantize.fold import fold_model


def static_importance_map(paths: List[str]) -> Dict[str, float]:
    """Positional importance: the first and last layers most sensitive,
    early layers more than late ones (the reference's hand-written table,
    generalized by position)."""
    n = max(len(paths) - 1, 1)
    imp = {}
    for i, p in enumerate(paths):
        imp[p] = 1.0 if i in (0, len(paths) - 1) else 0.9 - 0.4 * (i - 1) / n
    return imp


@torch.no_grad()
def measure_sensitivity(
    apply_fn: Callable,
    params: dict,
    state: dict,
    probe_batches: Iterable,
    *,
    per_channel: bool = True,
    bits: int = 8,
    group_size: Optional[int] = None,
    act_quant: bool = True,
) -> Dict[str, float]:
    """Per-layer damage: mean((ref - got)^2) in f32 on the device, ref the
    fp32 logits and got the logits with only that layer quantized (the
    dynamic INT8 path with act_quant, else weight-only), summed over the
    probe batches and divided by their number (quantnet/quantize/policy.py:80-98)."""
    fparams, fstate = fold_model(params, state)
    paths = layer_paths(fparams)
    index = {p: i for i, p in enumerate(paths)}
    batches = [b[0] if isinstance(b, (tuple, list)) else b for b in probe_batches]

    def tagged(onehot: List[float]) -> dict:
        def tag(path, layer):
            out = dict(layer)
            out["probe"] = ProbeGate(gate=onehot[index[path]], per_channel=per_channel, bits=bits,
                                     group_size=group_size, act_quant=act_quant)
            return out

        return walk_layers(fparams, tag)

    total = None
    for x in batches:
        ref, _ = apply_fn(fparams, fstate, x)
        d = []
        for i in range(len(paths)):
            got, _ = apply_fn(tagged([float(j == i) for j in range(len(paths))]), fstate, x)
            d.append(torch.mean((ref - got) ** 2))
        d = torch.stack(d)
        total = d if total is None else total + d
    if total is None:
        return {}
    # f32 division by the batch count, on the host, as the JAX package takes it.
    d = total.cpu().numpy() / max(len(batches), 1)
    return {p: float(d[i]) for p, i in index.items()}


def guard_from_damage(damage: Dict[str, float], rel_threshold: float) -> Dict[str, str]:
    """The int4 guard's rule: layers whose damage strictly exceeds
    rel_threshold x the median damage keep 8-bit weights (action "int8"); a
    layer exactly at the cut does not."""
    vals = sorted(damage.values())
    med = vals[len(vals) // 2] if vals else 0.0
    cut = rel_threshold * max(med, 1e-12)
    return {p: "int8" for p, d in damage.items() if d > cut}


def int4_guard(
    apply_fn: Callable,
    params: dict,
    state: dict,
    probe_batches: Iterable,
    *,
    group_size: Optional[int] = 128,
    rel_threshold: float = 50.0,
) -> Dict[str, str]:
    """The sub-byte tiers' guard: layers whose 4-bit weight-only damage
    exceeds rel_threshold x the median keep 8-bit weights (layer_policy
    action "int8")."""
    damage = measure_sensitivity(apply_fn, params, state, probe_batches, bits=4,
                                 group_size=group_size, act_quant=False)
    return guard_from_damage(damage, rel_threshold)


def int4_guard_sweep(
    apply_fn: Callable,
    params: dict,
    state: dict,
    probe_batches: Iterable,
    *,
    group_size: Optional[int] = 128,
    thresholds: Tuple[float, ...] = (25.0, 50.0, 100.0),
) -> Dict:
    """One sensitivity measurement, the guard sets at several thresholds and
    the damage statistics behind them: {"damage", "median", "rel_damage",
    "guards": {threshold: [paths]}, "stable_over_range": bool}."""
    damage = measure_sensitivity(apply_fn, params, state, probe_batches, bits=4,
                                 group_size=group_size, act_quant=False)
    vals = sorted(damage.values())
    med = vals[len(vals) // 2] if vals else 0.0
    guards = {thr: sorted(guard_from_damage(damage, thr)) for thr in thresholds}
    sets = [tuple(g) for g in guards.values()]
    return {
        "damage": damage,
        "median": med,
        "rel_damage": {p: d / max(med, 1e-12) for p, d in damage.items()},
        "guards": guards,
        "stable_over_range": all(s == sets[0] for s in sets),
    }


def build_policy(
    importance: Dict[str, float],
    *,
    keep_fp32_fraction: float = 0.25,
    high_precision_scheme: str = "bf16",
    low_precision_scheme: str = "weight_only",
) -> Dict[str, str]:
    """An importance or damage map -> {path: scheme}: the top
    keep_fp32_fraction get high_precision_scheme, the rest low_precision_scheme."""
    ranked = sorted(importance.items(), key=lambda kv: -kv[1])
    n_keep = max(1, int(round(len(ranked) * keep_fp32_fraction)))
    return {path: high_precision_scheme if i < n_keep else low_precision_scheme
            for i, (path, _) in enumerate(ranked)}


def quantize_optimized(
    params: dict,
    state: dict,
    apply_fn: Callable,
    probe_batches: Optional[Iterable] = None,
    *,
    importance: str = "sensitivity",
    keep_fp32_fraction: float = 0.25,
    per_channel: bool = True,
    low_precision_scheme: str = "weight_only",
    int4_group_size: Optional[int] = 128,
) -> Tuple[dict, dict, Dict[str, str]]:
    """The optimized scheme: measure (or the static map) -> policy -> bake.
    Returns (qparams, qstate, policy). low_precision_scheme "int4" puts the
    least sensitive layers on group-wise 4-bit weights."""
    fparams, fstate = fold_model(params, state)
    if importance == "sensitivity" and probe_batches is not None:
        imp = measure_sensitivity(apply_fn, params, state, probe_batches, per_channel=per_channel)
    else:
        imp = static_importance_map(layer_paths(fparams))
    policy = build_policy(imp, keep_fp32_fraction=keep_fp32_fraction,
                          low_precision_scheme=low_precision_scheme)
    qparams, qstate = _apply_policy(fparams, fstate, tuple(sorted(policy.items())), per_channel,
                                    int4_group_size)
    return qparams, qstate, policy


@torch.no_grad()
def _apply_policy(fparams, fstate, policy_items, per_channel, int4_group_size=128):
    """The mixed-precision bake: 'fp32' keeps a layer, 'bf16' casts its
    weight and bias, 'int4' quantizes its weight to 4 bits (grouped along K
    in dense layers), anything else to per-channel int8; weight-only
    throughout."""
    policy = dict(policy_items)

    def q(path: str, layer: dict) -> dict:
        action = policy.get(path, "weight_only")
        out = dict(layer)
        if action == "fp32":
            return out
        if action == "bf16":
            out["w"] = layer["w"].to(torch.bfloat16)
            if out.get("b") is not None:
                out["b"] = out["b"].to(torch.bfloat16)
            return out
        if action == "int4":
            out["w"] = quantize_weight(layer["w"], per_channel, bits=4, group_size=int4_group_size)
            return out
        out["w"] = quantize_weight(layer["w"], per_channel)
        return out

    return walk_layers(fparams, q), fstate
