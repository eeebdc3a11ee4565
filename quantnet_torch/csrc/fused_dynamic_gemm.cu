// Fused dynamic-quant GEMM on Hopper: out[M,N] = dynq(x[M,K] f32 or bf16) @
// W[N,K]^T (s8), rescaled, + bias, relu if asked, in one launch.
//
// Replaces the TPU kernel quantnet/ops/pallas_matmul.py:dynamic_int8_matmul_fused
// (body _fused_dynamic_kernel) and keeps its arithmetic to the bit: K is cut
// into blocks of block_k = min(512, round_up(K, 128)) columns, zero-padded
// past K. For every (row, K-block):
//     s    = max(absmax(x_block), eps) * f32(1 / 127)    (as XLA jits / 127)
//     q    = clip(rint(x_block / s), -127, 127)           f32 x, eps = 1e-8
//     q    = clip(rint(bf16(x_block / bf16(s))), -127, 127)  bf16 x, eps = bf16(1e-8)
//     acc += float(q @ W_block) * s                        f32, from +0.0, K-block order
// then out = acc * w_scale + bias, and relu (+0 for -0) where the layer has
// one. Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// fast math), and a block partial |q @ W_block| <= 127 * 127 * 512 < 2^24
// converts to f32 exactly, so the result is the plain version's
// (fused_dynamic_gemm_plain) bit for bit. The division is fast_div (as in
// int8_gemm.cu): a reciprocal made once per (row, K-block) and two FMA
// corrections, exact by Markstein's theorem in its range; __fdiv_rn for a
// row whose absmax lies outside it.
//
// On the main path it carries the convnet's fc1 (M x 4096 x 512, bf16 x, relu)
// and fc2 (M x 512 x 10, f32 x). Bound on an H100 SXM (3.35 TB/s, 1979 int8
// TOP/s), bytes: at M = 1024 fc1 reads 8.4 MB of x and 2.1 MB of W and writes
// 2.1 MB (3.76 us), fc2 moves 2.1 MB (0.64 us); at M = 32, 2.43 MB (0.73 us)
// and 0.07 MB (0.02 us). fc1's 4.3 G operations take 2.2 us at bs1024.
//
// Design. A block owns 64 rows x NB = 2 BNW columns (NB = 512 for fc1, 32 for
// fc2) and one K-block at a time, and quantizes that (row, K-block) tile
// once, for all NB columns:
//   * One thread brings the K-block of x in by TMA (boxes of 64 rows x 256
//     values, evict-first) and, once it is in, W's first stages (128-byte
//     swizzle, 128 bytes of K a stage, evict-last: every row tile reads it)
//     into a ring of 1-8 stages with full / empty mbarriers, refilled as the
//     products free the slots.
//   * All twelve warps quantize the staged tile: absmax by warp shuffle, the
//     division by fast_div on every row whose absmax is at most 2^60 (a
//     warp-uniform test), and the int8 tile written into shared memory in
//     the 128-byte-swizzled K-major layout the wgmma descriptor describes
//     (16-byte chunk index XOR row % 8, as TMA writes it), then
//     fence.proxy.async and a barrier. A goes through shared memory, not
//     registers: both multiplying warpgroups read the same 64 rows, each
//     against its own BNW columns, so the tile is quantized once for both.
//   * Warpgroups 1 and 2 run wgmma m64nBNWk32 (s8, A and B from shared
//     memory) as the W stages arrive.
//   * The K-blocks of a tile are split over a group of C = min(nkb, 8)
//     blocks, one K-block each (fc1: 8, so 16 row tiles x 8 = 128 blocks at
//     bs1024, 8 at bs32; fc2 has one K-block): the quantize and products of
//     all K-blocks run at once on their SMs. Each block writes its f32
//     partial float(q @ W_block) * s into the group's plane for its K-block
//     in device memory (L2; the rows it adds up itself stay in its shared
//     memory), and counts it on the group's `arrive` counter; when all have
//     arrived, each block copies the others' partials of its rows (r % C ==
//     rank) into shared memory by cp.async, adds the C partials in K-block
//     order from +0.0, applies the epilogue and stores. The sum
//     keeps the plain version's order, so the bits do not change. With more
//     than 8 K-blocks (K > 4096) a group takes them in rounds of 8, and the
//     running sums wait in `out` between rounds. The launch is cooperative:
//     every block is resident at once (one a SM), so the waits cannot hang,
//     and a group takes one tile after another when there are more tiles
//     than groups. The workspace (planes and counters) is the wrapper's,
//     allocated once per device and stream; the kernel leaves the counters
//     at zero. A cluster of 8 with the partials in distributed shared memory
//     was tried first: at most 15 such clusters are resident on an H100, so
//     bs1024's 16 row tiles took two waves.
//   * Past M and K the tile holds zeros (TMA zero fill), and past M and N
//     nothing is stored. N > NB takes more column tiles, each quantizing the
//     rows again (twice at N <= 1024).
// What this does about PR 4's kernel: x is read and quantized once per launch
// (was once per 128 columns), W once per 64 rows by TMA (was per 32 rows by
// synchronous copies), wgmma (was mma.sync), the W copies overlap the
// quantize, at bs32 fc1 runs on 8 SMs and at bs1024 on 128 (was 4 and 128
// blocks of 32 x 128), and relu is fused into the store (was a separate
// PyTorch launch).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_s8.cuh"

namespace {

constexpr int BM = 64;            // rows of a block: one wgmma M
constexpr int KB_MAX = 512;       // the widest K-block
constexpr int CHUNK = 128;        // K bytes of a swizzle row and of a ring stage
constexpr int JMAX = KB_MAX / CHUNK;
constexpr int THREADS = 384;      // three warpgroups: all quantize, 1 and 2 multiply
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT = 8;      // the most blocks a row tile's K-blocks are split over
constexpr int ALIGN = 1024;       // the 128-byte swizzle repeats every 8 rows
constexpr int A_BYTES = BM * KB_MAX;
constexpr int A_CHUNK = BM * CHUNK;  // one swizzled [64][128] tile of A

constexpr int XBOX = 256;         // x columns of one TMA box
constexpr int XBOXES = KB_MAX / XBOX;

// Shared memory: A (the quantized tile), the x tile of the K-block (XBOXES
// boxes of [64][256] elements), the ring of W stages, the row scales, the
// barriers.
template <typename T, int BNW>
struct Layout {
  static constexpr int NB = 2 * BNW;
  static constexpr int STAGE_BYTES = NB * CHUNK;
  static constexpr int X_BYTES = XBOXES * BM * XBOX * static_cast<int>(sizeof(T));
  static constexpr int FIXED = ALIGN + A_BYTES + X_BYTES + BM * 4 + (2 * MAX_STAGES + 1) * 8;
};

struct Args {
  const float* w_scale;
  const float* bias;
  float* out;
  float* planes;     // per group: nkb partial planes of [64][NB] f32
  unsigned* count;   // per group: arrive, depart; zero between launches
  int M, N, K, block_k, nkb, relu;
  int C, rounds;     // blocks of a group (K-block split), rounds of K-blocks
  int tiles_n, tiles;  // output tiles along N, in all
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of `parity` to complete, polling with test_wait: with
// try_wait, which may suspend the thread, fc1 at bs1024 took about 4 us more
// a launch on an H100.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// One TMA tile load: box at (c0 along K, c1 along rows) -> dst, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (wgmma reads, TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma region.
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// 16 bytes from global to shared memory, read at L2 (.cg: another SM wrote
// them), asynchronously; cp_async_wait_all waits for this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Counters that the blocks of a group share in device memory: `arrive`
// counts partial planes written, `depart` blocks done reading them.
__device__ __forceinline__ void signal(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* counter) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
  return v;
}

// Thread 0 waits until *counter >= target; then the whole block goes on.
__device__ __forceinline__ void wait_count(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0)
    while (load_acquire(counter) < target) {
    }
  __syncthreads();
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// y / d rounded to nearest even, the bits of __fdiv_rn(y, d), from r = RN(1 /
// d): q0 = RN(y r), then twice q' = RN(q + (y - d q) r), the remainder exact
// by FMA; q0 is within 2 ulp, the first step makes it faithful, the second is
// Markstein's theorem (as int8_gemm.cu's fast_div). That holds while y and q0
// lie in [2^-90, 2^90] and d in [2^-60, 2^60]. A row whose absmax is at most
// 2^60 has d in [2^-34, 2^54] and |y / d| <= 128; outside the range there the
// quotient is below 2^-56, and it and this result both round to 0. Other
// rows divide with __fdiv_rn.
__device__ __forceinline__ float fast_div(float y, float d, float r) {
  const float q0 = __fmul_rn(y, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-d, q0, y), r, q0);
  return __fmaf_rn(__fmaf_rn(-d, q1, y), r, q1);
}

// clip(rint(quot), -127, 127) of four quotients, packed into four int8s: the
// clamp commutes with rint at integer bounds, and adding 1.5 * 2^23 rounds to
// an integer, half to even, whose two's complement is the low byte of the sum.
__device__ __forceinline__ uint32_t pack_q(const float (&q)[4]) {
  uint32_t b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    b[e] = __float_as_uint(__fadd_rn(fminf(fmaxf(q[e], -127.0f), 127.0f), 12582912.0f));
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// Four values quantized (see the file header); FAST: fast_div, else __fdiv_rn.
template <bool BF16, bool FAST>
__device__ __forceinline__ uint32_t quantize4(const float (&v)[4], float d, float r) {
  float q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float quot = FAST ? fast_div(v[e], d, r) : __fdiv_rn(v[e], d);
    q[e] = BF16 ? round_bf16(quot) : quot;
  }
  return pack_q(q);
}

// Four x values of row r, columns c .. c + 3 of the staged K-block, as f32
// (exact for bf16).
__device__ __forceinline__ void load4(float (&v)[4], const float* xs, int r, int c) {
  const float4 f = *reinterpret_cast<const float4*>(xs + ((c / XBOX) * BM + r) * XBOX + c % XBOX);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* xs, int r, int c) {
  const uint2 u = *reinterpret_cast<const uint2*>(xs + ((c / XBOX) * BM + r) * XBOX + c % XBOX);
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// All twelve warps quantize rows m0 .. m0 + 63 (those below M) of the staged
// K-block xs into A (JMAX swizzled [64][128] tiles) and their scales into sS.
// Warp w takes rows w, w + 12, ..., two at a time; lane l holds columns
// 128 j + 4 l .. + 3, j < block_k / 128.
template <typename T>
__device__ __forceinline__ void quantize_tile(const Args& a, int m0, const T* xs, uint8_t* A,
                                              float* sS) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nj = a.block_k / CHUNK;
  const float eps = BF16 ? round_bf16(1e-8f) : 1e-8f;
#pragma unroll 2
  for (int r = warp; r < BM && m0 + r < a.M; r += WARPS) {
    float v[JMAX][4];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      if (j < nj) {
        load4(v[j], xs, r, CHUNK * j + 4 * lane);
      } else {
        v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(~0u, amax, o));
    // amax / 127 as the jitted Pallas body computes it: * f32(1 / 127).
    const float s = __fmul_rn(fmaxf(amax, eps), 1.0f / 127.0f);
    const float d = BF16 ? round_bf16(s) : s;  // the divisor of the quotient
    const float rcp = __frcp_rn(d);
    uint32_t w[JMAX];
    if (amax <= 0x1p60f) {  // the whole warp: amax is the row's
#pragma unroll
      for (int j = 0; j < JMAX; ++j) w[j] = quantize4<BF16, true>(v[j], d, rcp);
    } else {
#pragma unroll
      for (int j = 0; j < JMAX; ++j) w[j] = quantize4<BF16, false>(v[j], d, rcp);
    }
    // Byte column 4 lane of the 128-byte row: 16-byte chunk lane / 4,
    // swizzled with the row.
    const int off = r * CHUNK + (((lane >> 2) ^ (r & 7)) << 4) + ((lane & 3) << 2);
#pragma unroll
    for (int j = 0; j < JMAX; ++j)
      if (j < nj) *reinterpret_cast<uint32_t*>(A + j * A_CHUNK + off) = w[j];
    if (lane == 0) sS[r] = s;
  }
}

// out[row, col .. col + 3] = acc * w_scale + bias (relu), within N.
__device__ __forceinline__ void store4(const Args& a, float4 acc, const float (&ws)[4],
                                       const float (&bs)[4], int row, int col) {
  float y[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (col + e < a.N) {
      y[e] = __fadd_rn(__fmul_rn(y[e], ws[e]), bs[e]);
      if (a.relu) y[e] = y[e] <= 0.0f ? 0.0f : y[e];  // relu(-0) = +0; NaN passes
    }
  }
  float* dst = a.out + static_cast<long long>(row) * a.N + col;
  if ((a.N & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < a.N) dst[e] = y[e];
  }
}

// Between rounds (K > 4096) a block parks its rows' running sums in `out`,
// where they are stored at the end; elements past N are not kept, and
// nothing reads them.
__device__ __forceinline__ void park4(const Args& a, float4 v, int row, int col) {
  float* dst = a.out + static_cast<long long>(row) * a.N + col;
  const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < a.N) dst[e] = y[e];
}

__device__ __forceinline__ float4 parked4(const Args& a, int row, int col) {
  const float* src = a.out + static_cast<long long>(row) * a.N + col;
  float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < a.N) y[e] = src[e];
  return make_float4(y[0], y[1], y[2], y[3]);
}

template <typename T, int BNW>
__global__ void __launch_bounds__(THREADS, 1)
    fused_dynamic_gemm_kernel(const __grid_constant__ CUtensorMap tmap_x,
                              const __grid_constant__ CUtensorMap tmap_w, const Args a,
                              int stages) {
  using L = Layout<T, BNW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* A = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  T* xs = reinterpret_cast<T*>(A + A_BYTES);
  uint8_t* ring = A + A_BYTES + L::X_BYTES;
  float* sS = reinterpret_cast<float*>(ring + stages * L::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sS + BM);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xfull = empty + MAX_STAGES;

  const int C = a.C, groups = gridDim.x / C;
  const int group = blockIdx.x / C, rank = blockIdx.x % C;
  unsigned* arrive = a.count + 2 * group;
  unsigned* depart = arrive + 1;
  float* planes = a.planes + static_cast<long long>(group) * a.nkb * BM * L::NB;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int nst = a.block_k / CHUNK;
  // The partials of this block's own rows, [ceil(64 / C)][NB + 8] f32 over
  // x (free once the tile is quantized), where that fits.
  constexpr int OWN_STRIDE = L::NB + 8;
  float* own = reinterpret_cast<float*>(xs);
  const bool own_local = ((BM + C - 1) / C) * OWN_STRIDE * 4 <= L::X_BYTES;

  // W's K-block, one 128-byte column of K a stage, each multiplying
  // warpgroup's BNW rows of W one box. Load g goes to slot g % stages, and
  // waits there for the products of load g - stages.
  const uint64_t keep = l2_policy_evict_last();
  const CUtensorMap* map = &tmap_w;
  int n0 = 0;
  int base_w = 0;  // W loads issued before this round
  auto issue = [&](int g, int kb) {
    const int slot = g % stages;
    if (g >= stages) mbar_wait(&empty[slot], ((g / stages) - 1) & 1);
    uint8_t* dst = ring + slot * L::STAGE_BYTES;
    const bool second = n0 + BNW < a.N;  // warpgroup 2 has columns
    mbar_expect_tx(&full[slot], second ? L::STAGE_BYTES : L::STAGE_BYTES / 2);
    const int k = kb * a.block_k + (g % nst) * CHUNK;
    tma_load(dst, map, &full[slot], k, n0, keep);
    if (second) tma_load(dst + BNW * CHUNK, map, &full[slot], k, n0 + BNW, keep);
  };

  // x's K-block kb of rows m0.. (read once: evict-first): thread 0, at the
  // start of each round. W's stages follow once x is in, so that the two do
  // not share the memory system while the quantize waits for x.
  auto load_x = [&](int kb, int m0) {
    const int boxes = (a.block_k + XBOX - 1) / XBOX;
    mbar_expect_tx(xfull, boxes * BM * XBOX * static_cast<int>(sizeof(T)));
    for (int b = 0; b < boxes; ++b)
      tma_load(xs + b * BM * XBOX, &tmap_x, xfull, kb * a.block_k + b * XBOX, m0,
               l2_policy_evict_first());
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // the threads of warpgroups 1 and 2
    }
    mbar_init(xfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (group < a.tiles) load_x(rank, (group / a.tiles_n) * BM);  // the first round's
  }
  __syncthreads();

  // The column group and rows this thread adds up: column 4 c4 of the tile,
  // rows rank + C i for i = r0, r0 + RSTEP, ...
  const int c4 = threadIdx.x % (L::NB / 4), r0 = threadIdx.x / (L::NB / 4);
  constexpr int RSTEP = THREADS / (L::NB / 4);

  int xloads = 0;  // x tiles loaded so far
  int iter = 0;    // tiles this group has done
  for (int tile = group; tile < a.tiles; tile += groups, ++iter) {
    const int m0 = (tile / a.tiles_n) * BM;
    n0 = (tile % a.tiles_n) * L::NB;
    const int c = wg - 1;  // a multiplying warpgroup's columns: n0 + c BNW ..
    const bool mine = wg > 0 && n0 + c * BNW < a.N;
    float ws[4], bs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + 4 * c4 + e;
      ws[e] = col < a.N ? __ldg(a.w_scale + col) : 0.0f;
      bs[e] = col < a.N ? __ldg(a.bias + col) : 0.0f;
    }
    for (int t = 0; t < a.rounds; ++t) {
      const int kb = t * C + rank;
      const bool active = kb < a.nkb;
      if (active) {
        if (threadIdx.x == 0 && (iter > 0 || t > 0)) load_x(kb, m0);
        mbar_wait(xfull, xloads & 1);
        ++xloads;
        if (threadIdx.x == 0)
          for (int li = 0; li < nst && li < stages; ++li) issue(base_w + li, kb);
        quantize_tile<T>(a, m0, xs, A, sS);
        fence_proxy_async();  // A, written by threads, is read by wgmma
        __syncthreads();
        if (wg > 0) {
          int acc[BNW / 2];
#pragma unroll
          for (int i = 0; i < BNW / 2; ++i) acc[i] = 0;
          for (int li = 0; li < nst; ++li) {
            const int g = base_w + li, slot = g % stages;
            mbar_wait(&full[slot], (g / stages) & 1);
            if (mine) {
              const uint8_t* sb = ring + slot * L::STAGE_BYTES + c * BNW * CHUNK;
#pragma unroll
              for (int i = 0; i < BNW / 2; ++i) fence_reg(acc[i]);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < CHUNK / 32; ++kk)
                qt::WgmmaS8<BNW>::mma(acc, smem_desc(A + li * A_CHUNK + 32 * kk),
                                      smem_desc(sb + 32 * kk));
              wgmma_commit();
              wgmma_wait0();
#pragma unroll
              for (int i = 0; i < BNW / 2; ++i) fence_reg(acc[i]);
            }
            mbar_arrive(&empty[slot]);
          }
          if (mine) {
            // Plane kb may still be read for the group's last tile.
            if (iter > 0 && t == 0 && tid == 0)
              while (load_acquire(depart) < static_cast<unsigned>(iter * a.rounds * C))
                __nanosleep(64);
            asm volatile("bar.sync %0, 128;" ::"r"(wg) : "memory");
            // The partial float(q @ W_block) * s from the fragments (d[4j + r]:
            // row 16 (tid / 32) + (tid % 32) / 4 + 8 (r / 2), column 8j + 2
            // (tid % 4) + r % 2) into plane kb, kept in L2 for its readers.
            // This block's own rows (r % C == rank) stay in shared memory,
            // over x, where they fit.
            const int rq = (tid >> 5) * 16 + ((tid & 31) >> 2), cq = c * BNW + 2 * (tid & 3);
            float* plane = planes + static_cast<long long>(kb) * BM * L::NB;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rq + 8 * h;
              if (m0 + r < a.M) {
                const float s = sS[r];
                const bool local = own_local && r % C == rank;
                float* dst = local ? own + (r / C) * OWN_STRIDE : plane + r * L::NB;
#pragma unroll
                for (int j = 0; j < BNW / 8; ++j) {
                  const float p0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s);
                  const float p1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s);
                  *reinterpret_cast<float2*>(dst + cq + 8 * j) = make_float2(p0, p1);
                }
              }
            }
            __threadfence();
          }
        } else if (threadIdx.x == 0) {
          for (int li = stages; li < nst; ++li) issue(base_w + li, kb);  // as the slots free up
        }
        base_w += nst;
        __syncthreads();
        if (threadIdx.x == 0) signal(arrive);
      }
      // Every partial of the round written: add this block's rows, in
      // K-block order, from +0.0 (or the running sum parked in out), then
      // store (or park).
      const int planes_in = min(C, a.nkb - t * C);
      wait_count(arrive, static_cast<unsigned>(iter * a.nkb + t * C + planes_in));
      const bool first = t == 0, last = t == a.rounds - 1;
      const int col = n0 + 4 * c4;
      const int rpr = (BM + C - 1) / C;  // rows of this block: rank + C i
      // The other blocks' partials of these rows, copied into shared memory
      // (after this block's own, over x and the ring) by cp.async: every
      // copy in flight at once, none of them holding a register. Plane b
      // goes to slot b, or b - 1 past this block's own plane where that is
      // local.
      float* recv = own + (own_local ? rpr * OWN_STRIDE : 0);
      auto slot = [&](int b) { return own_local && b > rank ? b - 1 : b; };
      const int per_plane = rpr * (L::NB / 4);
      for (int u = threadIdx.x; u < planes_in * per_plane; u += THREADS) {
        const int b = u / per_plane, i = (u % per_plane) / (L::NB / 4), q = u % (L::NB / 4);
        const int r = rank + C * i;
        if ((own_local && b == rank) || r >= BM || m0 + r >= a.M) continue;
        cp_async16(recv + (slot(b) * rpr + i) * L::NB + 4 * q,
                   planes + (static_cast<long long>(t * C + b) * BM + r) * L::NB + 4 * q);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int i = r0; i < rpr; i += RSTEP) {
        const int r = rank + C * i;
        if (r >= BM || m0 + r >= a.M || col >= a.N) continue;
        float4 sum = first ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : parked4(a, m0 + r, col);
        for (int b = 0; b < planes_in; ++b) {
          const float4 p = *reinterpret_cast<const float4*>(
              own_local && b == rank ? own + i * OWN_STRIDE + 4 * c4
                                     : recv + (slot(b) * rpr + i) * L::NB + 4 * c4);
          sum.x = __fadd_rn(sum.x, p.x);
          sum.y = __fadd_rn(sum.y, p.y);
          sum.z = __fadd_rn(sum.z, p.z);
          sum.w = __fadd_rn(sum.w, p.w);
        }
        if (last)
          store4(a, sum, ws, bs, m0 + r, col);
        else
          park4(a, sum, m0 + r, col);
      }
      __syncthreads();  // shared memory is the next round's; the planes are read
      if (threadIdx.x == 0) {
        fence_proxy_async();  // x and the ring are TMA's again
        // The last block of the group to be done leaves the counters at zero
        // for the next launch.
        const unsigned total = static_cast<unsigned>(
            ((a.tiles - group + groups - 1) / groups) * a.rounds * C);
        if (atomicAdd(depart, 1u) + 1u == total) {
          *arrive = 0u;
          *depart = 0u;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, cols] matrix, `ld` elements a row, as TMA tiles of
// box_rows x box_cols; loads fill zeros past the edges. W: int8, 128-byte
// swizzle; x: f32 or bf16, as it lies.
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type, int esize, int rows,
            long long cols, long long ld, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ERR_ENCODE = -1;  // the tensor map could not be made
constexpr int ERR_ARGS = -2;    // shapes or alignment the kernel does not take
constexpr int MAX_GROUPS = 1024;
constexpr long long COUNT_BYTES = 2LL * 4 * MAX_GROUPS;

// Per device: SM count and the shared memory a block may opt in to.
struct DeviceInfo {
  int sms = 0, smem = 0;
};

const DeviceInfo& device_info() {
  static DeviceInfo info[64];
  int dev = 0;
  cudaGetDevice(&dev);
  DeviceInfo& d = info[dev & 63];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return d;
}

// How a launch is laid out: every block of the grid resident at once (one a
// SM), in groups of C blocks that each take one K-block of a tile a round.
struct Plan {
  int nb = 0, C = 0, rounds = 0, tiles_n = 0, tiles = 0, groups = 0;
};

Plan plan(long long M, long long N, long long K, long long block_k, int sms) {
  Plan p;
  p.nb = N <= 32 ? 32 : N <= 128 ? 128 : N <= 256 ? 256 : 512;  // 2 BNW, see dispatch
  const int nkb = static_cast<int>((K + block_k - 1) / block_k);
  p.C = nkb < MAX_SPLIT ? nkb : MAX_SPLIT;
  p.rounds = (nkb + p.C - 1) / p.C;
  p.tiles_n = static_cast<int>((N + p.nb - 1) / p.nb);
  p.tiles = static_cast<int>((M + BM - 1) / BM) * p.tiles_n;
  const int most = sms / p.C;
  p.groups = p.tiles < most ? p.tiles : most;
  return p;
}

template <typename T, int BNW>
int launch(const Args& a, const Plan& p, const void* x, const void* w, long long ldw,
           cudaStream_t stream) {
  using L = Layout<T, BNW>;
  const DeviceInfo& d = device_info();
  int stages = (d.smem - L::FIXED) / L::STAGE_BYTES;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 1) return ERR_ARGS;
  const int smem = L::FIXED + stages * L::STAGE_BYTES;
  // A block's partials, its own rows and those it receives, fit over x and
  // the ring: C ceil(64 / C) <= 71 rows of at most NB + 8 floats.
  if ((BM + MAX_SPLIT - 1) * (L::NB + 8) * 4 > L::X_BYTES + stages * L::STAGE_BYTES)
    return ERR_ARGS;
  CUtensorMap tx, tw;
  constexpr bool BF16 = sizeof(T) == 2;
  if (!encode(&tx, x, BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              sizeof(T), a.M, a.K, a.K, BM, XBOX, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.N, ldw, ldw, BNW, CHUNK,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return ERR_ENCODE;
  auto kernel = fused_dynamic_gemm_kernel<T, BNW>;
  static int smem_set = 0;  // per instantiation: the opt-in is made once
  if (smem_set < smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = d.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.groups * p.C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  // The blocks of a group wait for each other: the launch fails, and does
  // not hang, if they cannot all be resident.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, a, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, const Plan& p, const void* x, const void* w, long long ldw,
             cudaStream_t s) {
  // The narrowest pair of wgmma widths that covers N, up to 2 x 256.
  switch (p.nb) {
    case 32: return launch<T, 16>(a, p, x, w, ldw, s);
    case 128: return launch<T, 64>(a, p, x, w, ldw, s);
    case 256: return launch<T, 128>(a, p, x, w, ldw, s);
    default: return launch<T, 256>(a, p, x, w, ldw, s);
  }
}

}  // namespace

// Bytes of the workspace fused_dynamic_gemm needs for these sizes on the
// current device: two counters per group at the start, the same place for
// every launch (zero before the first; the kernel leaves them zero), then a
// partial plane per K-block for every group (f32).
extern "C" long long fused_dynamic_gemm_workspace(long long M, long long N, long long K,
                                                  long long block_k) {
  if (M <= 0 || N <= 0 || K <= 0 || block_k < CHUNK) return ERR_ARGS;
  const Plan p = plan(M, N, K, block_k, device_info().sms);
  const long long nkb = (K + block_k - 1) / block_k;
  return COUNT_BYTES + static_cast<long long>(p.groups) * nkb * BM * p.nb * 4;
}

// x: f32[M,K] (x_is_bf16 == 0) or bf16[M,K], contiguous, rows of a multiple
// of 16 bytes, 16-byte aligned; w: int8[N, ldw], its first K columns the
// weight and the rest zeros, ldw % 16 == 0, 16-byte aligned; w_scale, bias:
// f32[N]; out: f32[M,N], contiguous; block_k a multiple of 128 in [128, 512]
// (the block rule's, of the unpadded K); relu: 0 or 1; workspace: as
// fused_dynamic_gemm_workspace says, 16-byte aligned, used by one stream at a
// time. Launches on `stream`, allocates nothing, does not synchronize.
// Returns cudaGetLastError() after the launch, or a negative code if the
// kernel was not launched.
extern "C" int fused_dynamic_gemm(const void* x, const void* w, const void* w_scale,
                                  const void* bias, void* out, long long M, long long N,
                                  long long K, long long ldw, long long block_k,
                                  long long x_is_bf16, long long relu, void* workspace,
                                  void* stream) {
  const long long big = 1LL << 31;
  const int esize = x_is_bf16 ? 2 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || M >= big || N >= big || K >= big || ldw < K ||
      ldw % 16 != 0 || (K * esize) % 16 != 0 || (reinterpret_cast<uintptr_t>(w) & 15) ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(workspace) & 15) ||
      block_k < CHUNK || block_k > KB_MAX || block_k % CHUNK != 0)
    return ERR_ARGS;
  const Plan p = plan(M, N, K, block_k, device_info().sms);
  if (p.groups < 1 || p.groups > MAX_GROUPS) return ERR_ARGS;
  Args a{};
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.M = static_cast<int>(M), a.N = static_cast<int>(N), a.K = static_cast<int>(K);
  a.block_k = static_cast<int>(block_k);
  a.nkb = static_cast<int>((K + block_k - 1) / block_k);
  a.relu = relu != 0;
  a.C = p.C, a.rounds = p.rounds, a.tiles_n = p.tiles_n, a.tiles = p.tiles;
  a.count = static_cast<unsigned*>(workspace);
  a.planes = reinterpret_cast<float*>(static_cast<char*>(workspace) + COUNT_BYTES);
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return dispatch<__nv_bfloat16>(a, p, x, w, ldw, s);
  return dispatch<float>(a, p, x, w, ldw, s);
}
