// int8 GEMM with int32 accumulation: C[M,N] = A[M,K] @ B[N,K]^T, exact.
//
// Replaces the TPU kernel quantnet/ops/pallas_matmul.py:int8_matmul_pallas
// (body _matmul_kernel). On the main path it carries all six convs of the
// SimpleConvNet through im2col (quantnet_torch/ops/conv.py), so its shapes
// at bs1024 are M x K x N = 1048576x27x64, 1048576x576x64, 262144x576x128,
// 262144x1152x128, 65536x1152x256 and 65536x2304x256.
//
// Bound on an H100 SXM (3.35 TB/s, 1979 int8 TOP/s): every one of those six
// GEMMs is memory-bound, since K and N are small against M. Reading A and B
// once and writing the int32 C once moves about 2.25 GB in all, about
// 0.67 ms; the operations alone would take about 0.1 ms.
//
// Design: one block of 8 warps computes a 128 x 64 output tile; the K loop
// stages 128x64 A and 64x64 B tiles through shared memory and each warp runs
// mma.sync m16n8k32 on its 32 x 32 sub-tile. Ragged M, N and K are masked to
// zero on load (conv1 has K = 27) and masked on store. Kept simple and
// exact; making it fast (wgmma, TMA, a pipelined K loop, im2col fused into
// the A load) is left to later work.
#include "mma_s8.cuh"

namespace {

constexpr int BM = 128, BN = 64, THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                     int32_t* __restrict__ C, long long M, long long N, long long K) {
  __shared__ __align__(16) int8_t sA[BM * qt::SROW];
  __shared__ __align__(16) int8_t sB[BN * qt::SROW];
  const long long m0 = (long long)blockIdx.x * BM, n0 = (long long)blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps of 32 x 32

  int acc[2][4][4] = {};
  for (long long k0 = 0; k0 < K; k0 += qt::BK) {
    qt::load_tile_s8<BM, THREADS, VEC>(sA, A, M, K, m0, k0);
    qt::load_tile_s8<BN, THREADS, VEC>(sB, B, N, K, n0, k0);
    __syncthreads();
    qt::warp_mma_bk<2, 4, qt::SROW, qt::SROW>(acc, sA + wm * 32 * qt::SROW,
                                              sB + wn * 32 * qt::SROW, lane);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
        const long long col = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (row < M && col < N) C[row * N + col] = acc[mi][ni][e];
      }
}

}  // namespace

// a: int8[M,K], b: int8[N,K], c: int32[M,N], all contiguous on the device.
// Launches on `stream`, allocates nothing, does not synchronize. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_gemm_nt(const void* a, const void* b, void* c, long long M,
                            long long N, long long K, void* stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  const auto A = static_cast<const int8_t*>(a);
  const auto B = static_cast<const int8_t*>(b);
  const auto C = static_cast<int32_t*>(c);
  const auto s = static_cast<cudaStream_t>(stream);
  if (K % 16 == 0 && qt::aligned16(a) && qt::aligned16(b))
    int8_gemm_kernel<true><<<grid, THREADS, 0, s>>>(A, B, C, M, N, K);
  else
    int8_gemm_kernel<false><<<grid, THREADS, 0, s>>>(A, B, C, M, N, K);
  return (int)cudaGetLastError();
}
