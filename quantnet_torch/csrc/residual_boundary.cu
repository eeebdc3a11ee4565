// ResNet block boundary: q = int8(clip(round(relu(out + ident) / out_s) + out_zp,
// -128, 127)), one elementwise pass over the contiguous N*H*W*C buffer.
//
// Replaces the TPU kernel quantnet/ops/pallas_boundary.py:residual_boundary
// (bodies _boundary_kernel_i8 and _boundary_kernel_f32). Two variants:
//   int8 identity: ident = (float(id) - id_zp) * id_s   (a block without a
//                  downsample; the identity is the block's int8 input)
//   f32 identity:  ident = id                            (the downsample's
//                  f32 output, or a dequantized identity)
// and it is bit-exact against the JAX package's unfused route
// (dequantize -> relu(out + identity) -> quantize_affine): IEEE division
// (__fdiv_rn; nvcc builds without fast math), half-to-even rounding (rintf),
// no FMA contraction of out + (id - zp) * s (__fsub_rn / __fmul_rn /
// __fadd_rn), and the zero point added in f32 after rounding, then the clamp,
// then the cast.
//
// On ResNet-50's main path it runs at the 15 block boundaries that hand int8
// to the next block: 11 int8-identity and 4 f32-identity launches per
// forward. It moves 6 bytes per element (int8 identity: f32 out, int8 id,
// int8 q) or 9 (f32 identity) and does a handful of flops per element, so
// it is bound by memory: about 1.4 ms per forward at bs128 on an H100 SXM
// (3.35 TB/s). Design: a grid-stride loop in which each thread takes 16
// consecutive elements with 16-byte loads and one 16-byte store; the ragged
// tail, and buffers that are not 16-byte aligned, take a scalar loop. The
// scalars arrive by value. Not tuned.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;  // elements per thread per step: one 16-byte int8 store

template <bool I8_ID>
__device__ __forceinline__ float boundary_one(float out, float id, float id_s, float id_zp,
                                              float out_s, float out_zp) {
  const float ident = I8_ID ? __fmul_rn(__fsub_rn(id, id_zp), id_s) : id;
  const float y = fmaxf(__fadd_rn(out, ident), 0.0f);
  const float q = __fadd_rn(rintf(__fdiv_rn(y, out_s)), out_zp);
  return fminf(fmaxf(q, -128.0f), 127.0f);
}

template <bool I8_ID>
__device__ __forceinline__ float load_id(const void* id, long long i) {
  if (I8_ID) return (float)static_cast<const int8_t*>(id)[i];
  return static_cast<const float*>(id)[i];
}

template <bool I8_ID, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    residual_boundary_kernel(const float* __restrict__ out, const void* __restrict__ id,
                             int8_t* __restrict__ q, long long n, float id_s, float id_zp,
                             float out_s, float out_zp) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long tail = 0;
  if (VECTOR) {
    const long long nv = n / VEC;
    tail = nv * VEC;
    for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < nv; v += stride) {
      const long long base = v * VEC;
      float o[VEC], d[VEC];
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(out + base + 4 * j);
        o[4 * j] = f.x, o[4 * j + 1] = f.y, o[4 * j + 2] = f.z, o[4 * j + 3] = f.w;
      }
      if (I8_ID) {
        const int4 raw = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(id) + base);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) d[j] = (float)b[j];
      } else {
#pragma unroll
        for (int j = 0; j < VEC / 4; ++j) {
          const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(id) + base + 4 * j);
          d[4 * j] = f.x, d[4 * j + 1] = f.y, d[4 * j + 2] = f.z, d[4 * j + 3] = f.w;
        }
      }
      int4 packed;
      int8_t* p = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        p[j] = (int8_t)(int)boundary_one<I8_ID>(o[j], d[j], id_s, id_zp, out_s, out_zp);
      *reinterpret_cast<int4*>(q + base) = packed;
    }
  }
  for (long long i = tail + (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    q[i] = (int8_t)(int)boundary_one<I8_ID>(out[i], load_id<I8_ID>(id, i), id_s, id_zp, out_s,
                                            out_zp);
}

template <bool I8_ID>
void launch(const float* out, const void* id, int8_t* q, long long n, float id_s, float id_zp,
            float out_s, float out_zp, cudaStream_t s) {
  const bool vector = ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(id) |
                        reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  const long long work = vector ? (n / VEC > 0 ? n / VEC : 1) : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks < 1) blocks = 1;
  if (vector)
    residual_boundary_kernel<I8_ID, true><<<(unsigned)blocks, THREADS, 0, s>>>(
        out, id, q, n, id_s, id_zp, out_s, out_zp);
  else
    residual_boundary_kernel<I8_ID, false><<<(unsigned)blocks, THREADS, 0, s>>>(
        out, id, q, n, id_s, id_zp, out_s, out_zp);
}

}  // namespace

// out: f32[n]; identity: int8[n] (int8_identity != 0) or f32[n]; q: int8[n];
// all contiguous on the device. id_scale / id_zero_point are read only for
// the int8 identity. Launches on `stream`, allocates nothing, does not
// synchronize. Returns cudaGetLastError() after the launch.
extern "C" int residual_boundary(const void* out, const void* identity, void* q, long long n,
                                 long long int8_identity, float id_scale, float id_zero_point,
                                 float out_scale, float out_zero_point, void* stream) {
  const auto O = static_cast<const float*>(out);
  const auto Q = static_cast<int8_t*>(q);
  const auto s = static_cast<cudaStream_t>(stream);
  if (int8_identity)
    launch<true>(O, identity, Q, n, id_scale, id_zero_point, out_scale, out_zero_point, s);
  else
    launch<false>(O, identity, Q, n, id_scale, id_zero_point, out_scale, out_zero_point, s);
  return (int)cudaGetLastError();
}
