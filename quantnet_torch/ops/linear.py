"""Dense layer with quantization-aware dispatch (counterpart of
quantnet/ops/linear.py:93-226).

Four paths, picked by the layer's leaves:

  fp32/bf16    w: Tensor                  -> x @ w + b, f32 accumulation
                                             and result
  weight-only  w: QTensor, no 'aq'        -> (x @ q) * scale (grouped:
                                             x @ dequantize(w))
  dynamic PTQ  w: QTensor, aq dynamic     -> fused kernel with the relu in
                                             its store, or per-row quant +
                                             int8 GEMM kernel with the
                                             epilogue fused into its store
  static PTQ   w: QTensor, aq ActQuant    -> frozen affine quant, int8 GEMM
                                             kernel with - zp * wsum and the
                                             epilogue fused into its store

Every path takes `out_quant` and then requantizes its output into that
domain (the int8 handoff; see ops/conv.py); on the int8 GEMM paths the
kernel stores that int8 output itself. W4A8's grouped static weight runs
the int8 GEMM kernel's grouped-K mode: one int32 product per group of K
rows, folded in f32 with each group's zero-point correction and scale inside
the kernel (quantnet/ops/linear.py:228-253). The fp32 / bf16 and weight-only
products run outside Pallas in the JAX package too: here they are PyTorch
products with TF32 off.

A layer on the model axis carries a `TensorShard` under 'tp'
(parallel/tensor.py): a column shard runs the whole dispatch on its
columns; a row shard makes each reduction over its K-slice global
(`_row_int8`, `_row_fused_dynamic`, `row_epilogue`). A packed 4-bit weight
(the s4 runtime) reaches the int8 GEMM kernel packed; the weight-only
products widen it in torch ops; the fused dynamic kernel takes none.

A float layer that carries a `ProbeGate` under 'probe' (the sensitivity
sweep, quantize/policy.py) runs the lane its gate picks (`probe_lane`): its
plain self, or its quantized lane through this same dispatch
(quantnet/ops/linear.py:109-127). A float layer that carries a `FakeQuant`
under 'fq' (QAT) multiplies its fake-quantized input and weight in f32,
differentiably (quantnet/ops/linear.py:129-152).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags
from quantnet_torch.core.quantize import (
    EPS,
    SYM_MAX,
    _mul_reciprocal,
    dynamic_quantize,
    fake_quant_act_ste,
    fake_quant_weight_ste,
    maybe_requantize,
    quantize_affine,
)
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.ops.fused_dynamic_matmul import (
    BF16_EPS,
    _round_up,
    block_k_for,
    fused_dynamic_gemm,
    fused_dynamic_gemm_plain,
)
from quantnet_torch.ops.int8_matmul import (
    K_ALIGN,
    Epilogue,
    activation,
    apply_epilogue,
    finish_epilogue,
    gemm_width,
    int8_gemm,
    int8_gemm_epilogue,
    int8_gemm_epilogue_plain,
    int8_gemm_plain,
)
from quantnet_torch.ops.layers import set_column_shard
from quantnet_torch.ops.macs import record_linear
from quantnet_torch.quantize.common import quantize_weight


def relu_flag(act: Optional[str]) -> bool:
    """The fused dynamic kernel's relu switch for an activation name (it
    takes none or relu)."""
    if act not in (None, "relu"):
        raise ValueError(f"the fused dynamic GEMM applies no activation or relu, not {act!r}")
    return act == "relu"


def _per_column(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.float().reshape(-1).expand(n).contiguous()


@dataclass(frozen=True)
class GemmConstants:
    """A quantized layer's frozen operands of the GEMM kernels, kept in the
    layer under 'gemm'. Made once, where the tree is built (the static bake,
    the dynamic quantize, interop), by `gemm_constants`.

    b_nk:    int8[N, K'], the weight as the int8 GEMM kernel takes it: K
             zero-padded to a multiple of K_ALIGN (the same tensor as
             `w.nk()` where K is one already, and always for a grouped
             weight); a packed 4-bit weight's own uint8[N, K'/2] payload
    w_nk:    int8[N, K], the weight as the fused dynamic kernel takes it (a
             dynamic dense layer with an int8-wide weight), else None
    w_scale: f32[N], the weight scale per column (a depthwise conv's per
             channel; f32[G, N] for a grouped weight, one row per group)
    cs:      f32[N], aq.scale * w.scale (static; aq.scale alone for a
             grouped weight), else None
    zpw:     int32[N], zero_point * wsum (static; int32[G, N] for a grouped
             weight), else None
    bias:    f32[N], or None
    group:   the rows of K that share a scale (a grouped weight), else None
    """

    b_nk: torch.Tensor
    w_nk: Optional[torch.Tensor]
    w_scale: torch.Tensor
    cs: Optional[torch.Tensor]
    zpw: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    group: Optional[int] = None


def gemm_constants(layer: dict) -> GemmConstants:
    """The GEMM constants of a quantized layer {'w' QTensor, 'aq', 'wsum'
    (static), optional 'b'}. Built again if any of those is replaced."""
    w, aq, b = layer["w"], layer["aq"], layer.get("b")
    n = w.shape[-1]
    k = math.prod(w.shape) // n
    bias = None if b is None else _per_column(b, n)
    if w.group_size is not None:
        # W4A8: the kernel's grouped mode takes K as it is (whole groups),
        # the activation scale per column and each group's scale and
        # zero-point correction.
        return GemmConstants(
            b_nk=w.nk(), w_nk=None, w_scale=w.scale.float().reshape(-1, n).contiguous(),
            cs=_per_column(aq.scale, n),
            zpw=(aq.zero_point * layer["wsum"]).to(torch.int32).reshape(-1, n).contiguous(),
            bias=bias, group=w.group_size,
        )
    pad = -k % K_ALIGN
    if pad == 0 or w.is_packed:
        b_nk = w.nk()
    else:
        b_nk = F.pad(w.values.reshape(k, n).t(), (0, pad)).contiguous()
    dense_dynamic = isinstance(aq, DynamicActQuant) and len(w.shape) == 2 and not w.is_packed
    w_scale = _per_column(w.scale, n)
    cs = zpw = None
    if isinstance(aq, ActQuant):
        cs = _per_column(aq.scale * w.scale, n)
        zpw = (aq.zero_point * layer["wsum"]).to(torch.int32).reshape(-1).expand(n).contiguous()
    return GemmConstants(
        b_nk=b_nk, w_nk=w.nk() if dense_dynamic else None, w_scale=w_scale, cs=cs, zpw=zpw,
        bias=bias,
    )


def _constants(layer: dict) -> GemmConstants:
    g = layer.get("gemm")
    if g is None:
        raise ValueError(
            "a quantized layer needs its GEMM constants under 'gemm': build the tree with "
            "the static bake, the dynamic quantize or interop, or add gemm_constants(layer)"
        )
    return g


def int8_epilogue(
    layer: dict,
    x_scale: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str],
    out_quant: Optional[ActQuant],
    per_row: bool = False,
) -> Epilogue:
    """The int8 GEMM epilogue of a quantized layer: the output is
    acc * (x_scale * w.scale) [- zp * wsum first, static], + b, activation,
    stored as the layer hands it on: int8 in `out_quant`'s domain, else the
    dynamic bf16 handoff, else f32. `per_row`: x_scale is [M, 1] (the
    dynamic linear's per-row quant), else () per tensor."""
    aq, g = layer["aq"], _constants(layer)
    rs = None
    grouped = {}
    if g.group is not None:
        grouped = dict(group=g.group, gs=g.w_scale, gzpw=g.zpw)
        cs = g.cs
    elif isinstance(aq, ActQuant):
        cs = g.cs
    elif per_row:
        cs, rs = g.w_scale, x_scale.float().reshape(-1)
    else:
        cs = x_scale.float() * g.w_scale
    if out_quant is not None:
        out = torch.int8
    elif isinstance(aq, DynamicActQuant) and aq.handoff is not None:
        out = aq.handoff_dtype
    else:
        out = torch.float32
    return Epilogue(
        cs=cs, bias=g.bias, zpw=None if grouped else g.zpw, rs=rs, act=activation, out=out,
        out_quant=out_quant, **grouped,
    )


def int8_matmul(qx: torch.Tensor, layer: dict, flags: Flags, epi: Epilogue) -> torch.Tensor:
    """int8[M,K] x the layer's int8 weight through the int8 GEMM kernel with
    `epi` fused -> epi.out[M,N]. K is zero-padded to the kernel's K_ALIGN
    (the weight's padded copy is one of the layer's GEMM constants)."""
    b = _constants(layer).b_nk
    if qx.shape[1] != gemm_width(b):
        qx = F.pad(qx, (0, gemm_width(b) - qx.shape[1]))
    gemm = int8_gemm_epilogue_plain if flags.plain else int8_gemm_epilogue
    return gemm(qx.contiguous(), b, epi)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation and an f32 result, as the JAX package's
    `jnp.dot(..., preferred_element_type=f32)`: bf16 operands are widened to
    f32, where the product of two bf16 values is exact, and multiplied in
    f32 with TF32 off, whatever the caller has set."""
    x, w = x.float(), w.float()
    if not x.is_cuda:
        return torch.matmul(x, w)
    cublas = torch.backends.cuda.matmul
    before = cublas.allow_tf32
    cublas.allow_tf32 = False
    try:
        return torch.matmul(x, w)
    finally:
        cublas.allow_tf32 = before


def needs_gemm_constants(layer: dict) -> bool:
    """Whether a layer runs through the int8 kernels and so keeps its frozen
    operands under 'gemm': an int8 weight with a dynamic or static
    activation quant, grouped only with a static one (W4A8)."""
    w, aq = layer.get("w"), layer.get("aq")
    if not isinstance(w, QTensor):
        return False
    return isinstance(aq, ActQuant) or (isinstance(aq, DynamicActQuant) and w.group_size is None)


def with_gemm_constants(node):
    """A params tree whose every layer that needs them (needs_gemm_constants)
    holds its GEMM constants under 'gemm', made here, once: for a tree
    carried over or loaded from an artifact."""
    if not isinstance(node, dict):
        return node
    out = {k: with_gemm_constants(v) for k, v in node.items()}
    if needs_gemm_constants(out):
        out["gemm"] = gemm_constants(out)
    return out


def probe_lane(layer: dict) -> dict:
    """The layer a sensitivity probe's gate picks, without its 'probe' key:
    the float layer itself, or (gate > 0.5) its quantized lane, built as the
    JAX package builds it (quantnet/ops/conv.py:178-187): the weight through
    quantize_weight(w, per_channel, bits, group_size), a DynamicActQuant when
    the probe quantizes activations, and the GEMM constants the kernels read.
    The gate is host data, so only the picked lane runs; the JAX package
    computes both and selects, which gives the same values."""
    probe = layer["probe"]
    lane = {k: v for k, v in layer.items() if k != "probe"}
    if not probe.gate > 0.5:
        return lane
    lane["w"] = quantize_weight(lane["w"], probe.per_channel, bits=probe.bits,
                                group_size=probe.group_size)
    if probe.act_quant:
        lane["aq"] = DynamicActQuant()
    if needs_gemm_constants(lane):
        lane["gemm"] = gemm_constants(lane)
    return lane


def float_epilogue(y: torch.Tensor, b, act, out_quant) -> torch.Tensor:
    """+ b, activation and the int8 handoff after an f32 product."""
    if b is not None:
        y = y + b
    return maybe_requantize(activation(y, act), out_quant)


def row_epilogue(acc: torch.Tensor, epi: Epilogue) -> torch.Tensor:
    """A row shard's epilogue, applied once after the model axis's reduction
    (the elementwise work that XLA runs after its psum): an int32
    accumulator through `apply_epilogue` (- zpw, the scale, bias,
    activation, the store), or the grouped mode's f32 sum over the groups
    times the activation scale, then the rest. The same elementwise steps
    as the kernel's fused store, so a reduced int32 accumulator gives its
    bits."""
    if acc.dtype == torch.int32:
        return apply_epilogue(acc, epi)
    return finish_epilogue(acc * epi.cs, epi)


def _row_int8(qx: torch.Tensor, layer: dict, shard, flags: Flags, epi: Epilogue) -> torch.Tensor:
    """An int8 layer on a row shard: this rank's K-slice product by the int8
    GEMM kernel, reduced over the model axis, then `row_epilogue`. The int32
    accumulator is summed exactly (the result is the one-rank layer's, bit
    for bit); the grouped mode stores each rank's f32 sum over its whole
    groups, added in rank order (((g0 + g1) + (g2 + g3)) against the one
    rank's ((g0 + g1) + g2) + g3)."""
    b = _constants(layer).b_nk
    if qx.shape[1] != gemm_width(b) and epi.group is None:
        qx = F.pad(qx, (0, gemm_width(b) - qx.shape[1]))
    if epi.group is None:
        gemm = int8_gemm_plain if flags.plain else int8_gemm
        return row_epilogue(shard.int_sum(gemm(qx.contiguous(), b)), epi)
    ones = torch.ones((b.shape[0],), dtype=torch.float32, device=qx.device)
    partial = Epilogue(cs=ones, group=epi.group, gs=epi.gs, gzpw=epi.gzpw)
    gemm = int8_gemm_epilogue_plain if flags.plain else int8_gemm_epilogue
    return row_epilogue(shard.leave(gemm(qx.contiguous(), b, partial)), epi)


def _row_fused_dynamic(x: torch.Tensor, layer: dict, shard, flags: Flags, relu: bool) -> torch.Tensor:
    """The fused dynamic GEMM's function (fused_dynamic_gemm_plain) on a row
    shard. Its quantization blocks (block_k_for of the global K) may
    straddle the shards, so each (row, block) absmax is taken over the model
    axis; each rank quantizes its part of the block with that scale by the
    kernel's own steps, multiplies it by the int8 GEMM kernel (int32 store),
    and the int32 partials are summed exactly; the block's scale, the
    weight scale and the bias follow once: the one-rank result, bit for
    bit."""
    g = _constants(layer)
    m, n = x.shape[0], g.w_scale.shape[0]
    lo, hi = shard.k_range
    bf16 = x.dtype == torch.bfloat16
    bk = block_k_for(shard.k)
    pk = _round_up(_round_up(shard.k, 128), bk)
    xf = x.float()
    gemm = int8_gemm_plain if flags.plain else int8_gemm
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for k0 in range(0, pk, bk):
        a, e = max(k0, lo) - lo, min(k0 + bk, hi) - lo
        xb = xf[:, a:max(a, e)]
        amax = (torch.amax(torch.abs(xb), dim=1, keepdim=True) if xb.shape[1]
                else torch.zeros((m, 1), device=x.device))
        s = _mul_reciprocal(torch.clamp_min(shard.max(amax), BF16_EPS if bf16 else EPS), SYM_MAX)
        quot = (xb / s.bfloat16().float()).bfloat16().float() if bf16 else xb / s
        q = torch.clamp(torch.round(quot), -SYM_MAX, SYM_MAX).to(torch.int8)
        part = (gemm(q.contiguous(), g.w_nk[:, a:e].contiguous()) if xb.shape[1]
                else torch.zeros((m, n), dtype=torch.int32, device=x.device))
        acc = acc + shard.int_sum(part).float() * s
    y = acc * g.w_scale + g.bias
    return torch.relu(y) if relu else y


def linear(
    layer: dict,
    x: torch.Tensor,
    *,
    activation: Optional[str] = None,
    out_quant: Optional[ActQuant] = None,
    flags: Flags = DEFAULT_FLAGS,
) -> torch.Tensor:
    """Apply a dense layer {'w', optional 'b', 'aq', 'wsum', 'gemm', 'probe',
    'fq', 'tp'} to x[M, K].

    'tp' places the layer on the model axis (parallel/tensor.py): a column
    shard computes its N / mp output columns as the whole layer would (its
    input's gradient summed over the model axis); a row shard takes its
    K-slice of the input, and every reduction over K is made global (the
    absmax by an all-reduce max, the int32 accumulator by an int32 sum, an
    f32 product by `ordered_sum`), with the bias and the epilogue applied
    once after it."""
    w = layer["w"]
    b = layer.get("b")
    shard = layer.get("tp")
    row = shard is not None and shard.kind == "row"
    if shard is not None:
        set_column_shard(None if row else (shard.index, shard.size, w.shape[-1]))
        if not row:
            x = shard.enter(x)
    if layer.get("probe") is not None and not isinstance(w, QTensor):
        if shard is not None:
            raise NotImplementedError("the sensitivity probe runs on a layer that is not sharded")
        y = linear(probe_lane(layer), x, activation=activation, flags=flags)
        return maybe_requantize(y, out_quant)
    record_linear(x.shape[0], x.shape[1], w.shape[-1])
    # An f32 product of a row shard is a partial sum: reduced before the bias.
    reduce = shard.leave if row else (lambda y: y)
    fq = layer.get("fq")
    if fq is not None and not isinstance(w, QTensor):
        # QAT: the deployed layer simulated in f32 (see ops/conv.py).
        xq = fake_quant_act_ste(x, fq.scale, fq.zero_point) if fq.act_quant else x
        global_max = shard is not None and (row or not fq.per_channel)
        wq = fake_quant_weight_ste(w, fq.per_channel, fq.weight_bits, fq.weight_group_size,
                                   k=shard.k if row else None,
                                   reduce_max=shard.max if global_max else None)
        return float_epilogue(reduce(matmul_f32(xq, wq)), b, activation, out_quant)
    if not isinstance(w, QTensor):
        # bf16 params pull f32 activations down to bf16; f32 params leave the
        # activations' dtype as it is (the JAX package's narrow-dtype rule).
        # The product is accumulated and returned in f32 either way.
        cdtype = w.dtype if w.dtype == torch.bfloat16 else x.dtype
        y = reduce(matmul_f32(x.to(cdtype), w.to(cdtype)))
        return float_epilogue(y, b, activation, out_quant)

    aq = layer.get("aq")
    if aq is None:
        # Weight-only: the product in the activation dtype, f32 accumulation.
        # A per-channel scale moves past the product, (x @ q) * s; a grouped
        # one varies along K, so the weight is dequantized first.
        # A packed 4-bit payload is widened in torch ops for the product,
        # as XLA converts the int4 payload in its graph.
        if w.group_size is not None:
            y = reduce(matmul_f32(x, w.dequantize(x.dtype)))
        else:
            y = reduce(matmul_f32(x, w.int8_values().to(x.dtype))) * w.scale
        return float_epilogue(y, b, activation, out_quant)

    if w.group_size is not None and not isinstance(aq, ActQuant):
        # No kernel takes a (K // g, 1, N) scale on the dynamic path: fail
        # rather than broadcast it into a wrong-shaped output.
        raise NotImplementedError(
            "group-wise quantized weights need a frozen ActQuant (W4A8) or no "
            f"activation quant (weight-only); got {type(aq).__name__}"
        )

    if isinstance(aq, DynamicActQuant):
        n = w.shape[-1]
        if flags.dynamic_linear == "fused":
            if w.is_packed:
                raise NotImplementedError(
                    "the fused dynamic GEMM takes an int8-wide weight: a packed 4-bit dynamic "
                    "dense layer has no route (use dynamic_linear='unfused', K1's packed mode)")
            if row:
                y = _row_fused_dynamic(x, layer, shard, flags, relu_flag(activation))
                return maybe_requantize(y, out_quant)
            # x goes in as it arrives, f32 or the bf16 handoff of the layer
            # before, as the JAX package feeds it (linear.py:208); the kernel
            # then takes its block scales on bf16 values as the Pallas body does.
            gemm = fused_dynamic_gemm_plain if flags.plain else fused_dynamic_gemm
            g = _constants(layer)
            bias = g.bias if g.bias is not None else torch.zeros((n,), device=x.device)
            y = gemm(x.contiguous(), g.w_nk, g.w_scale, bias, relu_flag(activation))
            return maybe_requantize(y, out_quant)

        # Per-row symmetric activation quant, int8 GEMM, epilogue in the kernel.
        qx, x_scale = dynamic_quantize(x, axis=0, reduce_max=shard.max if row else None)
        epi = int8_epilogue(layer, x_scale, activation=activation, out_quant=out_quant, per_row=True)
        return _row_int8(qx, layer, shard, flags, epi) if row else int8_matmul(qx, layer, flags, epi)

    if isinstance(aq, ActQuant):
        # Static: (qx - zp) @ qw = qx @ qw - zp * colsum(qw), the colsum
        # baked as 'wsum' (W4A8: per group of K rows, [G, N], folded with
        # each group's scale in the kernel's grouped mode).
        qx = x if x.dtype == torch.int8 else quantize_affine(x, aq.scale, aq.zero_point)
        epi = int8_epilogue(layer, activation=activation, out_quant=out_quant)
        return _row_int8(qx, layer, shard, flags, epi) if row else int8_matmul(qx, layer, flags, epi)

    raise TypeError(f"unsupported activation-quant leaf {type(aq).__name__}")
