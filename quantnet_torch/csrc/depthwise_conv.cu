// Depthwise 3x3 int8 convolution with the int8 layers' epilogue fused into
// its one store (K4).
//
// The JAX package runs grouped int8 convs on XLA's native conv, never through
// im2col (quantnet/ops/conv.py:123-128); on the TPU XLA wrote that kernel.
// This is the port's: MobileNetV2's 17 depthwise convs, NHWC int8 x and an
// HWIO (3, 3, 1, C) int8 weight, stride 1 or 2, explicit (top, bottom, left,
// right) pads filled with a pad value (0 on the dynamic path, the zero point
// on the static one). Each output is an int32 sum of nine products, exact,
// then csrc/epilogue.cuh's epilogue per channel (the int8 GEMM's, bit for
// bit): acc - zpw[c] (static), * s[c], + bias[c], relu6 or relu or none, and
// one store of f32, bf16 or int8 in the consumer's domain; or the int32
// accumulator alone (store 0), the kernel's oracle and yardstick.
//
// What bounds it on an H100 SXM: 9 multiply-adds per output and per input
// byte read, below the CUDA cores' rate, so bytes: x read once and y written
// once (MobileNetV2 1.0 at bs256, 224x224: 17 launches, C from 32 at 112x112
// to 960 at 7x7). A direct kernel, simple and exact by construction: a thread
// owns 8 consecutive channels of one output pixel (one 8-byte load of x per
// tap, neighbouring threads on neighbouring channels, so a warp reads whole
// lines), the nine taps and the epilogue run in registers, and the store is
// one vector per thread. A block stages the weight and the per-channel
// vectors in shared memory once and walks the work in grid-size steps. A
// channel count that is not a multiple of 8 takes byte loads. The taps of
// neighbouring pixels are read again from L1 / L2, not reused in registers
// or shared memory: that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CV = 8;  // channels a thread owns
constexpr int KH = 3, KW = 3;
constexpr int BLOCKS_PER_SM = 8;

enum Store { STORE_INT32 = 0, STORE_F32 = 1, STORE_BF16 = 2, STORE_INT8 = 3 };

struct Shape {
  int n, h, w, c;   // input
  int ho, wo;       // output
  int stride, pt, pl;
  int chunks;       // (c + CV - 1) / CV
};

struct Epilogue {
  const float* cs;     // [C] scale per channel
  const float* bias;   // [C] or null
  const int32_t* zpw;  // [C] or null
  qt::Activation act;  // none, relu or relu6
  qt::OutQuant oq;     // the int8 store's domain
};

// The 8 bytes of an 8-byte word, and back (register moves only).
__device__ __forceinline__ void unpack8(const uint2 r, int8_t (&v)[CV]) {
#pragma unroll
  for (int j = 0; j < CV; ++j) v[j] = static_cast<int8_t>((j < 4 ? r.x : r.y) >> (8 * (j % 4)));
}

__device__ __forceinline__ uint2 pack8(const int8_t (&v)[CV]) {
  unsigned words[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    words[i] = (v[4 * i] & 0xFFu) | (v[4 * i + 1] & 0xFFu) << 8 | (v[4 * i + 2] & 0xFFu) << 16 |
               (v[4 * i + 3] & 0xFFu) << 24;
  return make_uint2(words[0], words[1]);
}

// The 8 int8 values of x at (n, hi, wi, c0..c0 + 7), or `pad` outside the
// image (and, without VEC, past C).
template <bool VEC>
__device__ __forceinline__ void load_tap(const int8_t* __restrict__ x, const Shape& s, int n, int hi,
                                         int wi, int c0, int8_t pad, int8_t (&v)[CV]) {
  const bool in = hi >= 0 && hi < s.h && wi >= 0 && wi < s.w;
  const int8_t* p = x + ((static_cast<long long>(n) * s.h + hi) * s.w + wi) * s.c + c0;
  if (VEC) {
    if (in) {
      unpack8(__ldg(reinterpret_cast<const uint2*>(p)), v);
    } else {
#pragma unroll
      for (int j = 0; j < CV; ++j) v[j] = pad;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CV; ++j) v[j] = in && c0 + j < s.c ? p[j] : pad;
  }
}

// Shared memory of a block: the weight [9][C] int8, then (stores 1-3) the
// per-channel cs, bias and zpw, each [C], 8-byte aligned.
__host__ __device__ inline size_t vectors_offset(int c) { return (static_cast<size_t>(KH * KW * c) + 7) / 8 * 8; }
__host__ __device__ inline size_t smem_bytes(int c, int store) {
  return vectors_offset(c) + (store == STORE_INT32 ? 0 : 12 * static_cast<size_t>(c));
}

template <int STORE, bool VEC>
__global__ void __launch_bounds__(THREADS)
    depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, void* __restrict__ y,
                     Shape s, int8_t pad, Epilogue e, unsigned work) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sw = smem;  // the weight, [9][C]
  float* scs = reinterpret_cast<float*>(smem + vectors_offset(s.c));
  float* sbias = scs + s.c;
  int* szpw = reinterpret_cast<int*>(sbias + s.c);
  const int taps = KH * KW * s.c;
  if (VEC) {
    for (int i = threadIdx.x; i < taps / 8; i += THREADS)
      reinterpret_cast<uint2*>(sw)[i] = __ldg(reinterpret_cast<const uint2*>(w) + i);
  } else {
    for (int i = threadIdx.x; i < taps; i += THREADS) sw[i] = w[i];
  }
  if constexpr (STORE != STORE_INT32) {
    for (int i = threadIdx.x; i < s.c; i += THREADS) {
      scs[i] = __ldg(e.cs + i);
      sbias[i] = e.bias ? __ldg(e.bias + i) : 0.0f;
      szpw[i] = e.zpw ? __ldg(e.zpw + i) : 0;
    }
  }
  __syncthreads();

  // Grid-size steps over the work, the same number for every thread of a
  // block (a warp's vote below needs all its lanes). 32-bit index arithmetic
  // (the work is below 2^31, checked on the host): a 64-bit division is a
  // long instruction sequence on the card.
  const unsigned step = gridDim.x * THREADS;
  for (unsigned base = blockIdx.x * THREADS; base < work; base += step) {
    const unsigned idx = base + threadIdx.x;
    const bool live = idx < work;
    const unsigned t = live ? idx : 0;  // threads past the end compute a copy and store nothing
    const unsigned pix = t / s.chunks;
    const int c0 = static_cast<int>(t - pix * s.chunks) * CV;
    const unsigned row = pix / s.wo;
    const int wo = static_cast<int>(pix - row * s.wo);
    const int n = static_cast<int>(row / s.ho);
    const int ho = static_cast<int>(row - n * s.ho);

    int acc[CV];
#pragma unroll
    for (int j = 0; j < CV; ++j) acc[j] = 0;
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) {
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        int8_t v[CV];
        load_tap<VEC>(x, s, n, ho * s.stride - s.pt + kh, wo * s.stride - s.pl + kw, c0, pad, v);
        const int8_t* wt = sw + (kh * KW + kw) * s.c + c0;
        int8_t wv[CV];
        if (VEC) {
          unpack8(*reinterpret_cast<const uint2*>(wt), wv);
        } else {
#pragma unroll
          for (int j = 0; j < CV; ++j) wv[j] = c0 + j < s.c ? wt[j] : 0;
        }
#pragma unroll
        for (int j = 0; j < CV; ++j) acc[j] += static_cast<int>(v[j]) * static_cast<int>(wv[j]);
      }
    }

    const long long out0 = static_cast<long long>(pix) * s.c + c0;  // y is [N, Ho, Wo, C]
    if constexpr (STORE == STORE_INT32) {
      if (!live) continue;
      int32_t* out = static_cast<int32_t*>(y) + out0;
      if (VEC) {
        reinterpret_cast<int4*>(out)[0] = make_int4(acc[0], acc[1], acc[2], acc[3]);
        reinterpret_cast<int4*>(out)[1] = make_int4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int j = 0; j < CV; ++j)
          if (c0 + j < s.c) out[j] = acc[j];
      }
    } else {
      float v[CV];
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        const int c = VEC || c0 + j < s.c ? c0 + j : 0;
        // The int8 store takes relu6's upper clip in its clamp.
        v[j] = qt::epilogue_value<STORE != STORE_INT8>(acc[j], e.zpw != nullptr, szpw[c], scs[c],
                                                       e.bias != nullptr, sbias[c], e.act);
      }
      if constexpr (STORE == STORE_F32) {
        if (!live) continue;
        float* out = static_cast<float*>(y) + out0;
        if (VEC) {
          reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int j = 0; j < CV; ++j)
            if (c0 + j < s.c) out[j] = v[j];
        }
      } else if constexpr (STORE == STORE_BF16) {
        if (!live) continue;
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y) + out0;
        if (VEC) {
          unsigned pk[CV / 2];
#pragma unroll
          for (int j = 0; j < CV / 2; ++j) {
            const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
            pk[j] = *reinterpret_cast<const unsigned*>(&b);
          }
          reinterpret_cast<uint4*>(out)[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        } else {
#pragma unroll
          for (int j = 0; j < CV; ++j)
            if (c0 + j < s.c) out[j] = __float2bfloat16_rn(v[j]);
        }
      } else {
        // Every lane takes part in the warp's vote, live or not.
        bool slow = false;
        int8_t q[CV];
#pragma unroll
        for (int j = 0; j < CV; ++j) q[j] = qt::requantize<true>(v[j], e.oq, slow);
        if (__any_sync(~0u, slow)) {
#pragma unroll
          for (int j = 0; j < CV; ++j) q[j] = qt::requantize<false>(v[j], e.oq, slow);
        }
        if (!live) continue;
        int8_t* out = static_cast<int8_t*>(y) + out0;
        if (VEC) {
          *reinterpret_cast<uint2*>(out) = pack8(q);
        } else {
#pragma unroll
          for (int j = 0; j < CV; ++j)
            if (c0 + j < s.c) out[j] = q[j];
        }
      }
    }
  }
}

constexpr int ERR_ARGS = -2;

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (sms[dev & 63] == 0) cudaDeviceGetAttribute(&sms[dev & 63], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev & 63];
}

template <int STORE>
int launch(const int8_t* x, const int8_t* w, void* y, const Shape& s, int8_t pad,
           const Epilogue& e, bool vec, cudaStream_t stream) {
  const long long work = static_cast<long long>(s.n) * s.ho * s.wo * s.chunks;
  if (work + static_cast<long long>(sm_count()) * BLOCKS_PER_SM * THREADS >= (1LL << 32)) return ERR_ARGS;
  const long long most = static_cast<long long>(sm_count()) * BLOCKS_PER_SM;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > most) blocks = most;
  const size_t smem = smem_bytes(s.c, STORE);
  auto kernel = vec ? depthwise_kernel<STORE, true> : depthwise_kernel<STORE, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(x, w, y, s, pad, e,
                                                                    static_cast<unsigned>(work));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: int8[N, H, W, C]; w: int8[3, 3, 1, C] (HWIO); y: [N, Ho, Wo, C] of the
// store's type (0 int32, 1 f32, 2 bf16, 3 int8 in (out_s, out_zp)); all
// contiguous. Output pixel (ho, wo) takes taps ho * stride - pad_top + kh,
// wo * stride - pad_left + kw; taps outside the image read `pad`. cs: f32[C]
// (stores 1-3); bias: f32[C] or null; zpw: int32[C] or null; act: 0 none,
// 1 relu, 2 relu6. Launches on `stream`, allocates nothing, does not
// synchronize. Returns cudaGetLastError() after the launch, or a negative
// code if the kernel was not launched.
extern "C" int depthwise_conv(const void* x, const void* w, void* y, long long N, long long H,
                              long long W, long long C, long long Ho, long long Wo, long long stride,
                              long long pad_top, long long pad_left, long long pad, int store,
                              const void* cs, const void* bias, const void* zpw, int act,
                              float out_s, float out_zp, void* stream) {
  const long long big = 1LL << 31;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || stride <= 0 || N >= big ||
      H >= big || W >= big || C >= big / 32 || store < STORE_INT32 || store > STORE_INT8 || (store != STORE_INT32 && !cs) ||
      pad < -128 || pad > 127 || act < 0 || act > qt::ACT_RELU6)
    return ERR_ARGS;
  const Shape s{static_cast<int>(N), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C),
                static_cast<int>(Ho), static_cast<int>(Wo), static_cast<int>(stride),
                static_cast<int>(pad_top), static_cast<int>(pad_left),
                static_cast<int>((C + CV - 1) / CV)};
  const Epilogue e{static_cast<const float*>(cs), static_cast<const float*>(bias),
                   static_cast<const int32_t*>(zpw), qt::make_activation(act),
                   qt::make_out_quant(out_s, out_zp, qt::make_activation(act).hi)};
  const bool vec = C % CV == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (smem_bytes(static_cast<int>(C), store) > 227 * 1024) return ERR_ARGS;
  const auto X = static_cast<const int8_t*>(x);
  const auto Wt = static_cast<const int8_t*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  const int8_t p = static_cast<int8_t>(pad);
  switch (store) {
    case STORE_INT32: return launch<STORE_INT32>(X, Wt, y, s, p, e, vec, st);
    case STORE_F32: return launch<STORE_F32>(X, Wt, y, s, p, e, vec, st);
    case STORE_BF16: return launch<STORE_BF16>(X, Wt, y, s, p, e, vec, st);
    default: return launch<STORE_INT8>(X, Wt, y, s, p, e, vec, st);
  }
}
