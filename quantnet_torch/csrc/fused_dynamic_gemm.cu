// Fused dynamic-quant GEMM: out[M,N] = dynq(x[M,K] f32 or bf16) @ W[N,K]^T
// (s8), rescaled, in one kernel.
//
// Replaces the TPU kernel
// quantnet/ops/pallas_matmul.py:dynamic_int8_matmul_fused (body
// _fused_dynamic_kernel) and keeps its arithmetic: K is cut into blocks of
// block_k = min(512, round_up(K, 128)) columns, zero-padded past K. For every
// (row, K-block):
//     s    = max(absmax(x_block), 1e-8) * f32(1 / 127)   (as XLA jits / 127)
//     q    = clip(round_half_even(x_block / s), -127, 127)
//     acc += float(q @ W_block) * s                       (f32, K-block order)
// then out = acc * w_scale + bias. No --use_fast_math, and __fmul_rn /
// __fadd_rn keep nvcc from contracting the f32 steps into FMAs, so the result
// is the plain version's to the last bit when both run on the card. A block
// partial |q @ W_block| <= 127*127*512 < 2^24 converts to f32 exactly.
//
// bf16 x (the dynamic model feeds fc1 the bf16 handoff of conv6) takes the
// steps the Pallas body takes on bf16 values, as XLA rounds them (found
// against the interpret-mode original, quantnet_torch/ops/
// fused_dynamic_matmul.py): the floor is bf16(1e-8), s stays f32, the
// quotient divides by bf16(s) and is rounded to bf16 before the
// half-to-even rounding, and the accumulate multiplies by the f32 s.
//
// On the main path it carries fc1 (1024 x 4096 x 512, 8 K-blocks, bf16 x)
// and fc2 (1024 x 512 x 10, 1 K-block, f32 x). Bound on an H100 SXM: fc1
// reads 8.4 MB of bf16 x, 2.1 MB of int8 W and writes 2.1 MB of f32 out,
// about 12.6 MB or 4 us at 3.35 TB/s; its 4.3 G int8 operations take about
// 2 us at 1979 TOP/s, so it is memory-bound. The activations are quantized
// in shared memory and never written back as int8.
//
// Design: one block of 8 warps owns 32 rows x 128 columns. Per K-block, each
// warp quantizes 4 rows (absmax by warp shuffle) into shared memory, then the
// block streams 128x64 W tiles and runs mma.sync m16n8k32, each warp on 16
// rows x 32 columns. Making it fast (wgmma, TMA, one block per full row so x
// is read once across column tiles) is left to later work.
#include <cuda_bf16.h>

#include "mma_s8.cuh"

namespace {

constexpr int BM = 32, BN = 128, THREADS = 256, KB_MAX = 512;
constexpr int XROW = KB_MAX + 16;  // padded stride of the quantized-x tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive x values of one row, zero past M and K, as f32 (exact for
// bf16). VEC: K % 4 == 0, so a 4-vector lies wholly inside or outside the row.
template <bool VEC>
__device__ __forceinline__ void load4(float (&v)[4], const float* __restrict__ X,
                                      long long row, long long col, long long M,
                                      long long K) {
  if (VEC) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < M && col < K) f = *reinterpret_cast<const float4*>(X + row * K + col);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (row < M && col + i < K) ? X[row * K + col + i] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* __restrict__ X,
                                      long long row, long long col, long long M,
                                      long long K) {
  if (VEC) {
    uint2 raw = make_uint2(0u, 0u);
    if (row < M && col < K) raw = *reinterpret_cast<const uint2*>(X + row * K + col);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(b[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (row < M && col + i < K) ? __bfloat162float(X[row * K + col + i]) : 0.f;
  }
}

template <typename T, bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(THREADS) fused_dynamic_gemm_kernel(
    const T* __restrict__ X, const int8_t* __restrict__ W,
    const float* __restrict__ w_scale, const float* __restrict__ bias,
    float* __restrict__ out, long long M, long long N, long long K, int block_k) {
  __shared__ __align__(16) int8_t sX[BM * XROW];
  __shared__ __align__(16) int8_t sW[BN * qt::SROW];
  __shared__ float sScale[BM];
  const long long m0 = (long long)blockIdx.x * BM, n0 = (long long)blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 16 x 32
  const int g = lane >> 2, t = lane & 3;
  const int nj = block_k / 128;  // float4 columns per lane per row

  float acc[4][4] = {};
  for (long long kbase = 0; kbase < K; kbase += block_k) {
    // Quantize this K-block of the block's 32 rows: 4 rows per warp.
    for (int r = 0; r < BM / 8; ++r) {
      const int rl = warp * (BM / 8) + r;
      float v[4][4];
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < KB_MAX / 128; ++j) {
        if (j < nj) {
          load4<VEC_X>(v[j], X, m0 + rl, kbase + 128 * j + 4 * lane, M, K);
#pragma unroll
          for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(v[j][i]));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      constexpr bool BF16 = sizeof(T) == 2;
      // amax / 127 as the jitted Pallas body computes it: * f32(1 / 127).
      const float s = __fmul_rn(fmaxf(amax, BF16 ? round_bf16(1e-8f) : 1e-8f), 1.0f / 127.0f);
      const float sq = BF16 ? round_bf16(s) : s;  // the divisor of the quotient
#pragma unroll
      for (int j = 0; j < KB_MAX / 128; ++j) {
        if (j < nj) {
          char4 q;
          int qi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float quot = BF16 ? round_bf16(__fdiv_rn(v[j][i], sq)) : __fdiv_rn(v[j][i], s);
            qi[i] = min(127, max(-127, __float2int_rn(quot)));
          }
          q.x = (char)qi[0], q.y = (char)qi[1], q.z = (char)qi[2], q.w = (char)qi[3];
          *reinterpret_cast<char4*>(sX + rl * XROW + 128 * j + 4 * lane) = q;
        }
      }
      if (lane == 0) sScale[rl] = s;
    }
    __syncthreads();

    int part[1][4][4] = {};
    for (int kc = 0; kc < block_k; kc += qt::BK) {
      qt::load_tile_s8<BN, THREADS, VEC_W>(sW, W, N, K, n0, kbase + kc);
      __syncthreads();
      qt::warp_mma_bk<1, 4, XROW, qt::SROW>(part, sX + wm * 16 * XROW + kc,
                                            sW + wn * 32 * qt::SROW, lane);
      __syncthreads();
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sScale[wm * 16 + g + 8 * (e >> 1)];
        acc[ni][e] = __fadd_rn(acc[ni][e], __fmul_rn(__int2float_rn(part[0][ni][e]), s));
      }
    __syncthreads();  // sScale and sX are rewritten by the next K-block
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = m0 + wm * 16 + g + 8 * (e >> 1);
      const long long col = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
      if (row < M && col < N)
        out[row * N + col] = __fadd_rn(__fmul_rn(acc[ni][e], w_scale[col]), bias[col]);
    }
}

template <typename T>
int launch(const void* x, const void* w, const float* S, const float* Bp, float* O, long long M,
           long long N, long long K, int bk, cudaStream_t s) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  const auto X = static_cast<const T*>(x);
  const auto Wp = static_cast<const int8_t*>(w);
  const bool vx = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;
  const bool vw = K % 16 == 0 && qt::aligned16(w);
  if (vx && vw)
    fused_dynamic_gemm_kernel<T, true, true><<<grid, THREADS, 0, s>>>(X, Wp, S, Bp, O, M, N, K, bk);
  else if (vx)
    fused_dynamic_gemm_kernel<T, true, false><<<grid, THREADS, 0, s>>>(X, Wp, S, Bp, O, M, N, K, bk);
  else if (vw)
    fused_dynamic_gemm_kernel<T, false, true><<<grid, THREADS, 0, s>>>(X, Wp, S, Bp, O, M, N, K, bk);
  else
    fused_dynamic_gemm_kernel<T, false, false><<<grid, THREADS, 0, s>>>(X, Wp, S, Bp, O, M, N, K, bk);
  return (int)cudaGetLastError();
}

}  // namespace

// x: f32[M,K] (x_is_bf16 == 0) or bf16[M,K], w: int8[N,K], w_scale / bias:
// f32[N], out: f32[M,N], all contiguous on the device; block_k a multiple of
// 128 in [128, 512]. Launches on `stream`, allocates nothing, does not
// synchronize. Returns cudaGetLastError() after the launch.
extern "C" int fused_dynamic_gemm(const void* x, const void* w, const void* w_scale,
                                  const void* bias, void* out, long long M, long long N,
                                  long long K, long long block_k, long long x_is_bf16,
                                  void* stream) {
  if (block_k < 128 || block_k > KB_MAX || block_k % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const auto S = static_cast<const float*>(w_scale);
  const auto Bp = static_cast<const float*>(bias);
  const auto O = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return launch<__nv_bfloat16>(x, w, S, Bp, O, M, N, K, (int)block_k, s);
  return launch<float>(x, w, S, Bp, O, M, N, K, (int)block_k, s);
}
