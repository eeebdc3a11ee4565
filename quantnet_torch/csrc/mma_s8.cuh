// Shared building blocks of the int8 GEMM kernels: an s8 x s8 -> s32
// tensor-core product (mma.sync m16n8k32) on tiles held in shared memory,
// and a masked global -> shared tile copy.
//
// Both operands are "row by K": A is [rows, K] and B is [N, K], K contiguous
// (B pre-transposed once at quantize time). Shared tiles keep that layout with
// a padded row stride, so every fragment load is one 32-bit word and a warp's
// 32 word loads fall in 32 different banks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qt {

constexpr int BK = 64;         // K depth of one shared tile
constexpr int SROW = BK + 16;  // padded row stride of a [rows][BK] tile, bytes

// d += a (16x32, row-major) * b (32x8, col-major), s8 x s8 -> s32.
// Fragment layout (PTX ISA, mma.m16n8k32 .s8), g = lane / 4, t = lane % 4:
//   a[0]: row g,   k 4t..4t+3      a[1]: row g+8, k 4t..4t+3
//   a[2]: row g,   k 16+4t..+3     a[3]: row g+8, k 16+4t..+3
//   b[0]: col g,   k 4t..4t+3      b[1]: col g,   k 16+4t..+3
//   d[0], d[1]: row g, cols 2t, 2t+1;  d[2], d[3]: row g+8, cols 2t, 2t+1
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld_word(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// One warp: acc[MI][NI] += sA[16*MI rows][BK] * sB[8*NI cols][BK]^T.
// sA / sB point at the warp's first row / column; strides are in bytes.
template <int MI, int NI, int ASTRIDE, int BSTRIDE>
__device__ __forceinline__ void warp_mma_bk(int (&acc)[MI][NI][4], const int8_t* sA,
                                            const int8_t* sB, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    unsigned a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int8_t* p = sA + (mi * 16 + g) * ASTRIDE + kk + 4 * t;
      a[mi][0] = ld_word(p);
      a[mi][1] = ld_word(p + 8 * ASTRIDE);
      a[mi][2] = ld_word(p + 16);
      a[mi][3] = ld_word(p + 8 * ASTRIDE + 16);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int8_t* q = sB + (ni * 8 + g) * BSTRIDE + kk + 4 * t;
      b[ni][0] = ld_word(q);
      b[ni][1] = ld_word(q + 16);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_s8_16832(acc[mi][ni], a[mi], b[ni]);
  }
}

// Copy rows [row0, row0+ROWS) x k [k0, k0+BK) of a row-major int8 [nrows, K]
// matrix into a shared [ROWS][SROW] tile; out-of-range elements become 0,
// which is exact for an integer product. VEC: 16-byte loads, valid when
// K % 16 == 0 and the matrix is 16-byte aligned; otherwise byte loads.
template <int ROWS, int NTHREADS, bool VEC>
__device__ __forceinline__ void load_tile_s8(int8_t* s, const int8_t* g, long long nrows,
                                             long long K, long long row0, long long k0) {
  if (VEC) {
    constexpr int CPR = BK / 16;  // 16-byte chunks per row
    constexpr int ITERS = (ROWS * CPR + NTHREADS - 1) / NTHREADS;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      if (c < ROWS * CPR) {
        const int r = c / CPR, kc = (c % CPR) * 16;
        const long long gr = row0 + r, gk = k0 + kc;
        int4 v = make_int4(0, 0, 0, 0);
        if (gr < nrows && gk < K) v = *reinterpret_cast<const int4*>(g + gr * K + gk);
        *reinterpret_cast<int4*>(s + r * SROW + kc) = v;
      }
    }
  } else {
    constexpr int ITERS = (ROWS * BK + NTHREADS - 1) / NTHREADS;
#pragma unroll 4
    for (int i = 0; i < ITERS; ++i) {
      const int e = threadIdx.x + i * NTHREADS;
      if (e < ROWS * BK) {
        const int r = e / BK, kk = e % BK;
        const long long gr = row0 + r, gk = k0 + kk;
        s[r * SROW + kk] = (gr < nrows && gk < K) ? g[gr * K + gk] : int8_t(0);
      }
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace qt
