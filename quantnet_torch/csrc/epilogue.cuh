// The int8 layers' epilogue, shared by the int8 GEMM (int8_gemm.cu, K1) and
// the depthwise int8 conv (depthwise_conv.cu, K4), so that the two store the
// same bits for the same accumulator: in this order and in IEEE f32 without
// contraction (__fmul_rn / __fadd_rn, no fast math),
//     acc - zpw                          int32, static layers (zp * colsum)
//     y = float(acc) * s                 s per output channel (and row)
//     y = y + bias                       if a bias
//     y = activation(y)                  none, relu, or relu6
// then the store: f32, bf16 (round to nearest even) or the int8 requantize
// clamp(rint(y / out_s) + out_zp, -128, 127), the zero point added in f32
// after rounding, as quantize_affine does (relu6's upper clip folded into
// that clamp).
#pragma once

#include <cstdint>

namespace qt {

// Activation codes (ops/int8_matmul.py, ACTS).
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

// An activation as a kernel takes it: a relu switch and an upper clip, hi =
// 6 for relu6 and +inf otherwise. Behind the relu switch, the f32 and bf16
// stores clip with a select on hi, a value that is the same for the whole
// launch (with a branch on the activation's code, the int8 GEMM's variants
// took more registers and its fused stores up to 1.7x as long on an H100);
// the int8 store clips in its clamp, for free (see OutQuant::qhi).
struct Activation {
  int relu;
  float hi;
};

inline Activation make_activation(int act) {
  return Activation{act != ACT_NONE, act == ACT_RELU6 ? 6.0f : __builtin_huge_valf()};
}

// relu(-0) = +0, as jax.nn.relu jitted; relu6 is jnp.clip(y, 0, 6) as XLA
// runs it, max(0, y) then min(6, .): -0 gives +0. NaN passes through both.
// CLIP: apply the upper clip here (the f32 and bf16 stores).
template <bool CLIP>
__device__ __forceinline__ float activate(float y, const Activation& a) {
  if (a.relu) {
    y = y <= 0.0f ? 0.0f : y;
    if (CLIP) y = y > a.hi ? a.hi : y;
  }
  return y;
}

// The int8 store's domain, with RN(1 / out_s) made on the host, and the
// store's upper bound qhi: 127, or with relu6 min(127, rint(6 / out_s) +
// out_zp). y / out_s, its rounding and the zero point's add are monotone in
// y, so clamping the quantized value at the quantized 6 gives the bits of
// quantizing min(y, 6) (NaN included: both clamp to -128).
struct OutQuant {
  float s, zp;
  float r;    // RN(1 / s)
  int fast;   // s lies where fast_div is exact (see there)
  float qhi;  // the upper bound of the store
};

inline OutQuant make_out_quant(float s, float zp, float hi) {
  const float qhi = hi < __builtin_huge_valf() ? __builtin_rintf(hi / s) + zp : 127.0f;
  return OutQuant{s, zp, 1.0f / s, s >= 0x1p-60f && s <= 0x1p60f, qhi < 127.0f ? qhi : 127.0f};
}

// y / s rounded to nearest even, the bits of __fdiv_rn(y, s), in five
// branch-free operations from r = RN(1 / s): q0 = RN(y r); then twice
// q' = RN(q + (y - s q) r), the remainder exact by FMA. q0 is within 2 ulp of
// y / s, the first step brings it within 1 ulp (faithful), and the second is
// Markstein's theorem: r within half an ulp of 1 / s and q faithful give
// RN(q + r (y - s q)) = RN(y / s). That holds while nothing over- or
// underflows; `slow` is set where y or q0 leave [2^-90, 2^90] (y = 0 gives 0,
// exact), and the caller then takes __fdiv_rn (s is checked on the host).
// __fdiv_rn branches to its slow path per element, which keeps the compiler
// from overlapping the divisions of a chunk: on an H100 the int8 store took
// about three times as long with it.
__device__ __forceinline__ float fast_div(float y, float s, float r, bool& slow) {
  const float q0 = __fmul_rn(y, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, y), r, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-s, q1, y), r, q1);
  const float ay = fabsf(y), aq = fabsf(q0);
  slow |= !(y == 0.0f || (ay >= 0x1p-90f && ay <= 0x1p90f && aq >= 0x1p-90f && aq <= 0x1p90f));
  return q2;
}

// The int8 requantize: clamp(rint(y / out_s) + out_zp, -128, qhi), the zero
// point added in f32 after rounding, as quantize_affine does. FAST divides
// with fast_div and sets `slow` where that may not be exact: the caller then
// runs it again with FAST false (__fdiv_rn) for the whole warp.
template <bool FAST>
__device__ __forceinline__ int8_t requantize(float y, const OutQuant& o, bool& slow) {
  if (FAST && !o.fast) slow = true;
  const float d = FAST ? fast_div(y, o.s, o.r, slow) : __fdiv_rn(y, o.s);
  const float q = __fadd_rn(rintf(d), o.zp);
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(q, -128.0f), o.qhi)));
}

// The f32 epilogue of one int32 accumulator, given its channel's zpw, scale
// and bias (each used only where the layer has it). CLIP as for activate.
template <bool CLIP>
__device__ __forceinline__ float epilogue_value(int acc, bool has_zpw, int zpw, float s,
                                                bool has_bias, float bias, const Activation& act) {
  if (has_zpw) acc -= zpw;
  float y = __fmul_rn(__int2float_rn(acc), s);
  if (has_bias) y = __fadd_rn(y, bias);
  return activate<CLIP>(y, act);
}

// The same after an f32 accumulation (K1's grouped mode: the zero-point
// correction and the group scales are in already).
template <bool CLIP>
__device__ __forceinline__ float epilogue_value(float acc, bool, int, float s, bool has_bias,
                                                float bias, const Activation& act) {
  float y = __fmul_rn(acc, s);
  if (has_bias) y = __fadd_rn(y, bias);
  return activate<CLIP>(y, act);
}

}  // namespace qt
