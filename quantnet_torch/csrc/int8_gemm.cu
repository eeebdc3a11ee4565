// int8 GEMM on Hopper: C[M,N] = A[M,K] @ B[N,K]^T with int32 accumulation,
// exact, and an optional epilogue fused into the one store.
//
// Replaces the TPU kernel quantnet/ops/pallas_matmul.py:int8_matmul_pallas
// (body _matmul_kernel). It carries every int8 conv (through im2col) and
// every int8 linear of the port: the convnet's six convs at bs1024
// (M x K x N = 1048576x32x64 after conv1's K = 27 is zero-padded,
// 1048576x576x64, 262144x576x128, 262144x1152x128, 65536x1152x256,
// 65536x2304x256) and ResNet-50's 52 convs and fc at bs128 (20 shapes).
//
// What bounds it on an H100 SXM (3.35 TB/s, 1979 int8 TOP/s): K and N are
// small against M, so all but one shape are bound by bytes: reading A once
// and writing C once is most of the work. The exception is ResNet-50's
// 6272x4608x512, bound by operations. So the design streams A from HBM once
// and keeps the tensor cores fed from shared memory:
//
//   * Output tile BM x BN = 128 x (64, 128 or 256): BN covers all of N up to
//     256, so A is read once; for N > 256 the tiles of one M block are
//     consecutive in the schedule, so the blocks running side by side share
//     that A tile through L2 (as do the 128-wide tiles taken for the int8
//     store and where 256-wide ones would leave most of the last wave of SMs
//     idle).
//   * A persistent grid (one block per SM) walks the tiles. Warpgroup 0 is
//     the producer: one thread issues TMA loads (cp.async.bulk.tensor,
//     128-byte swizzle, 128 bytes of K per stage) into a ring of 4-8 stages,
//     tracked by mbarriers in both directions (full: the bytes arrived;
//     empty: both consumers are done with the stage). It runs ahead across
//     tile boundaries, so loads overlap the consumers' epilogue.
//   * Warpgroups 1 and 2 are the consumers, 64 rows each: wgmma.mma_async
//     m64nBNk32 .s32.s8.s8 with both operands K-major in shared memory (the
//     only layout wgmma takes for s8), four per stage.
//   * TMA fills rows and columns past M, N and K with zeros, exact for an
//     integer product, and the TMA store skips them. K must be a multiple of
//     16 and C's rows a multiple of 16 bytes (TMA's row strides): the wrapper
//     zero-pads K and may give C a wider row than N.
//
// The epilogue (a template parameter, STORE) reads the accumulators out of
// the wgmma fragments and applies csrc/epilogue.cuh's epilogue, shared with
// the depthwise conv (K4): acc - zpw[n] (static), float(acc) * s with
// s = cs[n] or rs[m] * cs[n], + bias[n], then none, relu or relu6 (+0 for
// -0, as XLA's max and clamp), then one store: int32 (no epilogue; the TPU
// kernel's own function), f32, bf16 or int8 requantized into the consumer's
// domain. Each 128-byte column chunk of a consumer's 64 rows goes through a
// swizzled staging buffer in shared memory and out by one TMA store (full
// lines), double-buffered, so the stores drain while the next tile is
// computed.
//
// Grouped-K mode (W4A8, quantnet/ops/linear.py:228-253, whose G-batched
// int8 dot_general is not a Pallas kernel): the weight's scale changes every
// `group` rows of K, so the reduction splits into G = K / group products,
// each a K-slice of the same A and B. At each group boundary of the K loop a
// consumer waits for its wgmmas, folds the int32 accumulator into an f32 one
// in registers, facc += float(acc - gzpw[g, n]) * gs[g, n] in group order
// 0..G-1 (the order of the JAX package's jnp.sum over G), and restarts acc
// at zero; the epilogue then takes facc with s = cs[n] (the activation
// scale). The (G, M, N) accumulator of the JAX package never reaches device
// memory. The group is a multiple of 32 (one k32 wgmma) and divides K; the
// mode runs 64-wide tiles (BN = 64: a second accumulator set in registers,
// and more tiles for the small-M products of the classifier layers) and
// stores f32 or int8.
//
// Packed-B mode (the s4 runtime's 4-bit weights; built as a library of its
// own with QT_PACKED_B=1, quantnet_torch/_build.py VARIANTS, in both the
// normal and the grouped-K mode and for every store): B is uint8[N, K/2],
// two's-complement nibbles packed along K, the even k in the low nibble, K a
// multiple of 32. At bs1 the weight's bytes bound the product, and halving
// them is the lever; at the convnet's bs1024 shapes A's bytes dominate. A
// stage then loads BN x 64 bytes of B (128 nibbles of K a row) by a tensor
// map of its own (64-byte box, no swizzle) into a packed buffer beside the
// int8 B tile. The producer warpgroup's three idle warps widen it into that
// tile, in the 128-byte swizzle wgmma reads: each nibble sign-extended by
// ((x & 0x0F0F0F0F) ^ 0x08080808) - 0x08080808 per byte (__vsub4), lo and
// hi interleaved by __byte_perm; then fence.proxy.async (wgmma reads
// through the async proxy what they wrote through the generic one) and an
// arrive on the stage's third mbarrier ("unpacked"), which the consumers
// wait on after "full". One widening serves both consumers. TMA's zero fill
// past N and K gives zero bytes, which widen to zeros: so the integers, and
// every store, are the int8-wide launch's on the widened weight, bit for bit.
#ifndef QT_PACKED_B
#define QT_PACKED_B 0
#endif
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int BM = 128;           // rows of an output tile: two consumer warpgroups
constexpr int BK = 128;           // K bytes per stage: one 128-byte swizzle row
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int MAX_STAGES = 8;
constexpr int ALIGN = 1024;       // the 128-byte swizzle repeats every 8 rows
constexpr bool PACKED = QT_PACKED_B != 0;  // B nibble-packed (this library's mode)
constexpr int UNPACKERS = 96;     // packed mode: warps 1-3 of the producer warpgroup

enum Store { STORE_INT32 = 0, STORE_F32 = 1, STORE_BF16 = 2, STORE_INT8 = 3 };

struct Epilogue {
  const float* cs;      // [N] per-column scale
  const float* rs;      // [M] per-row scale, or null
  const float* bias;    // [N] or null
  const int32_t* zpw;   // [N] or null
  qt::Activation act;   // none, relu or relu6
  qt::OutQuant oq;      // the int8 store's domain
  const float* gs;      // grouped mode: [G, N] weight scale of each group
  const int32_t* gzpw;  // grouped mode: [G, N] zero_point * colsum of each group
  int group;            // grouped mode: K rows of a group; 0 otherwise
};

template <int STORE>
struct StoreTraits {
  static constexpr int BYTES = STORE == STORE_INT8 ? 1 : STORE == STORE_BF16 ? 2 : 4;
};

// Shared memory of one block: the ring, then each consumer's staging buffers
// for the TMA store, then the barriers.
template <int BN>
struct Smem {
  static constexpr int A_BYTES = BM * BK;
  // Packed mode: the TMA-loaded half-width B (BN rows of 64 bytes) sits
  // after the int8 B tile that the unpackers fill.
  static constexpr int B_LOAD = PACKED ? A_BYTES + BN * BK : A_BYTES;
  static constexpr int LOAD_BYTES = A_BYTES + (PACKED ? BN * BK / 2 : BN * BK);
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK + (PACKED ? BN * BK / 2 : 0);
  static constexpr int OUT_BUF = 64 * 128;  // 64 rows x one 128-byte swizzle row
  // Staging buffers of a consumer (TMA stores in flight): two at BN = 256,
  // where more would cost a stage of the ring.
  static constexpr int OUT_BUFS = BN == 256 ? 2 : 4;
  static constexpr int STAGING = 2 * OUT_BUFS * OUT_BUF;
  static constexpr int BARRIERS = (PACKED ? 3 : 2) * MAX_STAGES * 8;
  static size_t bytes(int stages) { return ALIGN + (size_t)stages * STAGE_BYTES + STAGING + BARRIERS; }
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

// Waits for the phase of `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// L2 policies: C is written once (evict first); B is read again by every
// tile, and A by the tiles of its other column blocks (evict last). A's loads
// are kept too where it is read once: each 128-byte row of a stage is
// promoted to a 256-byte L2 fetch, whose second half is the next stage's, and
// evict-first dropped it before that stage came (on an H100, ResNet-50's
// int32 GEMMs took 4% longer per forward with A evict-first).
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

// One TMA tile store: the 64-row box at (c0 along N, c1 along M) <- src.
// Rows and columns past the tensor's edge are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's TMA stores still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte offset), the
// leading byte offset unused by a swizzled K-major layout.
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
// Waits until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma region.
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// Whether a tile's store is narrower than a 128-byte row: the int8 store of a
// 64-wide tile in the grouped mode, which may have more tiles to its right
// (elsewhere plan() takes 64-wide int8 tiles only for N <= 64, where the
// row's second half lies past N and TMA skips it). Such a store goes out
// through a 64-byte box without swizzle, from a staging buffer of 64-byte rows.
__host__ __device__ constexpr bool narrow_store(int bn, int store, bool grouped) {
  return grouped && bn == 64 && store == STORE_INT8;
}

// Chunk geometry of a store: a chunk is one 128-byte row of the staging
// buffer, CW columns; a tile of BN columns has CHUNKS of them (BN = 64 with
// int8: one chunk, half of it past N, not stored), each JC 8-column fragment
// blocks wide.
template <int BN, int STORE>
struct Chunks {
  static constexpr int CW = 128 / StoreTraits<STORE>::BYTES;
  static constexpr int CHUNKS = BN >= CW ? BN / CW : 1;
  static constexpr int JC = (BN >= CW ? CW : BN) / 8;
  static constexpr int PV = JC / 4;  // per-column values a lane holds per vector
};

// One chunk's per-column vectors, spread over a warp: lane l holds column
// base + 32 i + l of cs, bias and zpw (zeros past N or where the epilogue
// has none). Read coalesced, one chunk ahead of their use (the first before
// the tile's products), so their latency is hidden; a thread takes its own
// columns by shuffle.
template <int PV>
struct ChunkCols {
  float cs[PV], bias[PV];
  int zpw[PV];
};

template <int PV>
__device__ __forceinline__ void load_cols(ChunkCols<PV>& v, const Epilogue& e, int base, int N,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < PV; ++i) {
    const int c = base + 32 * i + lane;
    const bool in = c < N;
    v.cs[i] = in ? __ldg(e.cs + c) : 0.0f;
    v.bias[i] = in && e.bias ? __ldg(e.bias + c) : 0.0f;
    v.zpw[i] = in && e.zpw ? __ldg(e.zpw + c) : 0;
  }
}

// The f32 epilogue of one accumulator (int32, or f32 in the grouped mode),
// given its column's zpw, cs and bias and its row's rs (each used only where
// the epilogue has it).
template <bool CLIP, typename T>
__device__ __forceinline__ float epilogue_value(T acc, int zpw, float cs, float rs, float bias,
                                                const Epilogue& e) {
  const float s = e.rs ? __fmul_rn(rs, cs) : cs;
  return qt::epilogue_value<CLIP>(acc, e.zpw != nullptr, zpw, s, e.bias != nullptr, bias, e.act);
}

// The fragments of chunk q of a consumer's tile, through the epilogue, into
// the staging buffer in the 128-byte swizzle. FAST: the int8 store divides
// with fast_div and reports in `slow` where it may not be exact.
template <int BN, int STORE, bool FAST, bool NARROW, typename T>
__device__ __forceinline__ void write_chunk(const T (&acc)[BN / 2], int q, int M, int N, int row0,
                                            int n0, const Epilogue& e,
                                            const ChunkCols<Chunks<BN, STORE>::PV>& cols,
                                            const float (&rs)[2], uint8_t* buf, int tid,
                                            bool& slow) {
  using C = Chunks<BN, STORE>;
  constexpr int ESZ = StoreTraits<STORE>::BYTES;
  const int rq = (tid >> 5) * 16 + ((tid & 31) >> 2);  // fragment row of r = 0, 1
  const int cq = 2 * (tid & 3);                        // fragment column offset
#pragma unroll
  for (int jj = 0; jj < C::JC; ++jj) {
    const int j = q * C::JC + jj;
    const int col = n0 + 8 * j + cq;
    float2 cs = make_float2(0.0f, 0.0f), bias = cs;
    int2 zpw = make_int2(0, 0);
    if constexpr (STORE != STORE_INT32) {
      const int i = jj / 4, lane = 8 * (jj % 4) + cq;  // who holds columns col, col + 1
      cs = make_float2(__shfl_sync(~0u, cols.cs[i], lane), __shfl_sync(~0u, cols.cs[i], lane + 1));
      if (e.bias)
        bias = make_float2(__shfl_sync(~0u, cols.bias[i], lane),
                           __shfl_sync(~0u, cols.bias[i], lane + 1));
      if (e.zpw)
        zpw = make_int2(__shfl_sync(~0u, cols.zpw[i], lane), __shfl_sync(~0u, cols.zpw[i], lane + 1));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rq + 8 * h;
      const int row = row0 + r;
      const int b = (8 * jj + cq) * ESZ;  // byte column in the chunk
      uint8_t* dst = NARROW ? buf + r * 64 + b : buf + r * 128 + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
      const T a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      if constexpr (STORE == STORE_INT32) {
        *reinterpret_cast<int2*>(dst) = make_int2(a0, a1);
      } else {
        float y0 = 0.0f, y1 = 0.0f;  // past M or N: not stored
        if (row < M) {
          // The int8 store takes relu6's upper clip in its clamp.
          constexpr bool CLIP = STORE != STORE_INT8;
          if (col < N) y0 = epilogue_value<CLIP>(a0, zpw.x, cs.x, rs[h], bias.x, e);
          if (col + 1 < N) y1 = epilogue_value<CLIP>(a1, zpw.y, cs.y, rs[h], bias.y, e);
        }
        if constexpr (STORE == STORE_F32) {
          *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
        } else if constexpr (STORE == STORE_BF16) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(y0);
          v.y = __float2bfloat16_rn(y1);
          *reinterpret_cast<__nv_bfloat162*>(dst) = v;
        } else {
          char2 v;
          v.x = qt::requantize<FAST>(y0, e.oq, slow);
          v.y = qt::requantize<FAST>(y1, e.oq, slow);
          *reinterpret_cast<char2*>(dst) = v;
        }
      }
    }
  }
}

// Consumer warpgroup's store of its 64 x BN tile (rows row0.., cols n0..):
// column chunks of one 128-byte row each (32 int32 / f32, 64 bf16, 128 int8
// columns) are written from the fragments into a staging buffer in the
// 128-byte swizzle (conflict-free), then stored by one TMA store. The
// buffers are taken in turn across tiles (`seq` counts the chunks), so up
// to Smem::OUT_BUFS stores drain while the next chunks, and the next tile's
// products, are computed. `cols` holds the first chunk's per-column vectors
// and `rs` the two rows' per-row scales, read before the products.
template <int BN, int STORE, bool NARROW, typename T>
__device__ __forceinline__ void store_tile(T (&acc)[BN / 2], const CUtensorMap* tmap_c, int M,
                                           int N, int row0, int n0, const Epilogue& e,
                                           ChunkCols<Chunks<BN, STORE>::PV> cols,
                                           const float (&rs)[2], uint8_t* stg, int tid,
                                           int barrier_id, unsigned& seq) {
  using C = Chunks<BN, STORE>;
#pragma unroll
  for (int q = 0; q < C::CHUNKS; ++q, ++seq) {
    constexpr int NBUF = Smem<BN>::OUT_BUFS;
    uint8_t* buf = stg + (seq % NBUF) * Smem<BN>::OUT_BUF;
    ChunkCols<C::PV> next{};  // the next chunk's vectors, read now
    if (STORE != STORE_INT32 && q + 1 < C::CHUNKS)
      load_cols(next, e, n0 + (q + 1) * C::JC * 8, N, tid & 31);
    // The store that last used buf, NBUF stores ago, has read it.
    if (tid == 0) tma_store_wait_read<NBUF - 1>();
    named_sync(barrier_id);
    bool slow = false;
    write_chunk<BN, STORE, true, NARROW>(acc, q, M, N, row0, n0, e, cols, rs, buf, tid, slow);
    // A lane whose division left fast_div's range: the warp writes its part
    // of the chunk again with __fdiv_rn (int8 only).
    if (STORE == STORE_INT8 && __any_sync(~0u, slow))
      write_chunk<BN, STORE, false, NARROW>(acc, q, M, N, row0, n0, e, cols, rs, buf, tid, slow);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to TMA
    named_sync(barrier_id);
    if (tid == 0) tma_store(tmap_c, buf, n0 + q * C::JC * 8, row0, l2_policy_evict_first());
    if (q + 1 < C::CHUNKS) cols = next;
  }
}

// Eight 4-bit values packed in x (two's complement, the even one in the low
// nibble of each byte) -> eight int8 values in a (the first four) and b.
__device__ __forceinline__ void unpack_nibbles8(uint32_t x, uint32_t& a, uint32_t& b) {
  const uint32_t lo = __vsub4((x & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  const uint32_t hi = __vsub4(((x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  a = __byte_perm(lo, hi, 0x5140);
  b = __byte_perm(lo, hi, 0x7362);
}

// Packed mode: one stage's packed B (BN rows of 64 bytes, unswizzled) widened
// into the int8 B tile (BN rows of 128 bytes, 128-byte swizzle) by UNPACKERS
// threads, u = 0 .. UNPACKERS - 1. A 16-byte chunk c of a packed row holds K
// 32c .. 32c + 31: the tile row's chunks 2c and 2c + 1.
template <int BN>
__device__ __forceinline__ void unpack_stage(const uint8_t* src, uint8_t* dst, int u) {
  for (int i = u; i < BN * 4; i += UNPACKERS) {
    const int r = i >> 2, c = i & 3;
    const uint4 p = *reinterpret_cast<const uint4*>(src + r * 64 + c * 16);
    uint4 lo, hi;
    unpack_nibbles8(p.x, lo.x, lo.y);
    unpack_nibbles8(p.y, lo.z, lo.w);
    unpack_nibbles8(p.z, hi.x, hi.y);
    unpack_nibbles8(p.w, hi.z, hi.w);
    uint8_t* row = dst + r * 128;
    *reinterpret_cast<uint4*>(row + (((2 * c) ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
  }
}

// Grouped mode: at the end of group gi, acc (this thread's fragments of the
// tile, columns n0..) folds into facc in f32, facc += float(acc - gzpw[gi, n])
// * gs[gi, n], and restarts at zero. Columns past N hold zeros on both sides.
template <int BN>
__device__ __forceinline__ void fold_group(int (&acc)[BN / 2], float (&facc)[BN / 2], int gi,
                                           int n0, int N, const Epilogue& e, int tid) {
  const int32_t* z = e.gzpw + static_cast<size_t>(gi) * N;
  const float* s = e.gs + static_cast<size_t>(gi) * N;
  const int cq = 2 * (tid & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + cq;
    const int z0 = col < N ? __ldg(z + col) : 0, z1 = col + 1 < N ? __ldg(z + col + 1) : 0;
    const float s0 = col < N ? __ldg(s + col) : 0.0f, s1 = col + 1 < N ? __ldg(s + col + 1) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      facc[i] = __fadd_rn(facc[i], __fmul_rn(__int2float_rn(acc[i] - z0), s0));
      facc[i + 1] = __fadd_rn(facc[i + 1], __fmul_rn(__int2float_rn(acc[i + 1] - z1), s1));
      acc[i] = 0;
      acc[i + 1] = 0;
    }
  }
}

template <int BN, int STORE, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
                     const __grid_constant__ CUtensorMap tmap_b,
                     const __grid_constant__ CUtensorMap tmap_c, int M, int N, int K, int stages,
                     Epilogue epi) {
  using L = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  uint8_t* staging = ring + stages * L::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + L::STAGING);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* unpacked = empty + MAX_STAGES;  // packed mode only

  const int num_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * num_n;
  const int ksteps = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
      if constexpr (PACKED) mbar_init(&unpacked[s], UNPACKERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if (tid >= 32) {
      // Packed mode: warps 1-3 widen each stage's B once it has arrived.
      if constexpr (PACKED) {
        int stage = 0;
        unsigned phase = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          for (int ks = 0; ks < ksteps; ++ks) {
            mbar_wait(&full[stage], phase);
            uint8_t* st = ring + stage * L::STAGE_BYTES;
            unpack_stage<BN>(st + L::B_LOAD, st + L::A_BYTES, tid - 32);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
            mbar_arrive(&unpacked[stage]);
            if (++stage == stages) stage = 0, phase ^= 1;
          }
        }
      }
      return;
    }
    // Producer: one thread keeps the ring full, across tile boundaries.
    if (tid != 0) return;
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmap_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmap_b)) : "memory");
    const uint64_t keep_a = l2_policy_evict_last(), keep_b = keep_a;
    int stage = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / num_n) * BM, n0 = (t % num_n) * BN;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sa = ring + stage * L::STAGE_BYTES;
        mbar_expect_tx(&full[stage], L::LOAD_BYTES);
        tma_load(sa, &tmap_a, &full[stage], ks * BK, m0, keep_a);
        tma_load(sa + L::B_LOAD, &tmap_b, &full[stage], PACKED ? ks * BK / 2 : ks * BK, n0, keep_b);
        if (++stage == stages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // Consumers: warpgroup c = wg - 1 owns rows 64c .. 64c + 63 of each tile.
  const int c = wg - 1;
  uint8_t* stg = staging + c * L::OUT_BUFS * L::OUT_BUF;
  unsigned seq = 0;  // chunks stored so far
  int acc[BN / 2];
  float facc[GROUPED ? BN / 2 : 1];  // grouped mode: the f32 sum over the groups so far
  int stage = 0, prev = 0;
  unsigned phase = 0;
  const int rq = (tid >> 5) * 16 + ((tid & 31) >> 2);  // this thread's first fragment row
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / num_n) * BM, n0 = (t % num_n) * BN;
    // The epilogue's per-column and per-row values, read while the products run.
    ChunkCols<Chunks<BN, STORE>::PV> cols{};
    float rs[2] = {0.0f, 0.0f};
    if constexpr (STORE != STORE_INT32) {
      load_cols(cols, epi, n0, N, tid & 31);
      if (epi.rs) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * c + rq + 8 * h;
          if (row < M) rs[h] = __ldg(epi.rs + row);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int gi = 0;  // grouped mode: the group in progress
    if constexpr (GROUPED) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) facc[i] = 0.0f;
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&full[stage], phase);
      if constexpr (PACKED) mbar_wait(&unpacked[stage], phase);
      const uint8_t* sa = ring + stage * L::STAGE_BYTES + c * 64 * BK;
      const uint8_t* sb = ring + stage * L::STAGE_BYTES + L::A_BYTES;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const int k0 = ks * BK + kk * 32;
        // Past K the tile holds zeros: skip those products.
        if (k0 < K) {
          qt::WgmmaS8<BN>::mma(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk));
          if constexpr (GROUPED) {
            if ((k0 + 32) % epi.group == 0) {  // the group ends here: fold it into facc
              wgmma_commit();
              wgmma_wait<0>();
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
              fold_group<BN>(acc, facc, gi++, n0, N, epi, tid);
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
              wgmma_fence();
            }
          }
        }
      }
      wgmma_commit();
      // Keep this stage's products in flight; the previous stage's are done,
      // so its buffers go back to the producer.
      wgmma_wait<1>();
      if (ks > 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == stages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    mbar_arrive(&empty[prev]);
    if constexpr (GROUPED)
      store_tile<BN, STORE, narrow_store(BN, STORE, GROUPED)>(facc, &tmap_c, M, N, m0 + 64 * c, n0,
                                                              epi, cols, rs, stg, tid, 1 + c, seq);
    else
      store_tile<BN, STORE, narrow_store(BN, STORE, GROUPED)>(acc, &tmap_c, M, N, m0 + 64 * c, n0,
                                                              epi, cols, rs, stg, tid, 1 + c, seq);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The int8 store's requantize alone, elementwise, as the epilogue runs it
// (fast_div, and __fdiv_rn for a warp with a lane out of its range): for
// holding the division against PyTorch's on inputs a GEMM seldom makes.
#if !QT_PACKED_B
__global__ void requantize_kernel(const float* __restrict__ y, int8_t* __restrict__ q, long long n,
                                  Epilogue e) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float v = i < n ? y[i] : 0.0f;
  bool slow = false;
  int8_t r = qt::requantize<true>(v, e.oq, slow);
  if (__any_sync(~0u, slow)) r = qt::requantize<false>(v, e.oq, slow);
  if (i < n) q[i] = r;
}
#endif

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

// A row-major [rows, cols] matrix of `esize`-byte elements, `ld` elements
// a row, as TMA tiles of box_rows x (128 bytes), 128-byte swizzle (narrow:
// 64 bytes, no swizzle); loads fill zeros past the edges and stores skip them.
bool encode(CUtensorMap* map, const void* base, int esize, int rows, int cols, long long ld,
            int box_rows, bool narrow = false) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const CUtensorMapDataType type = esize == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                : CU_TENSOR_MAP_DATA_TYPE_INT32;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>((narrow ? 64 : 128) / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            narrow ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ERR_ENCODE = -1;  // the tensor maps could not be made
constexpr int ERR_ARGS = -2;    // shapes or alignment the kernel does not take

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

// The share of the SMs busy over the waves of a persistent grid of `tiles`.
double wave_fill(long long tiles, int sms) {
  const long long waves = (tiles + sms - 1) / sms;
  return static_cast<double>(tiles) / static_cast<double>(waves * sms);
}

// How a launch is laid out: tile width, ring stages, dynamic shared memory
// and grid.
struct Plan {
  int bn = 0, stages = 0, smem = 0, grid = 0;
};

template <int BN>
void fill_plan(Plan& p, const DeviceInfo& d, int M, int N) {
  using L = Smem<BN>;
  const int stages = static_cast<int>((d.smem - L::bytes(0)) / L::STAGE_BYTES);
  p.bn = BN;
  p.stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  p.smem = static_cast<int>(L::bytes(p.stages));
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  p.grid = static_cast<int>(tiles < d.sms ? tiles : d.sms);
}

// The narrowest tile that covers N, up to 256 (A is read once). Past 128,
// 128-wide tiles for the int8 store (its epilogue's registers spill beside
// 128 accumulators a thread) and where 256-wide ones would leave much of the
// last wave idle (ResNet-50's 25088 x K x 256 GEMMs: 196 tiles on 132 SMs,
// against 392); their A tile is read again from L2. The grouped mode takes
// 64-wide tiles.
Plan plan(int M, int N, int store, bool grouped) {
  const DeviceInfo& d = device_info();
  Plan p;
  const long long mt = (M + BM - 1) / BM;
  if (N <= 64 || grouped)
    fill_plan<64>(p, d, M, N);
  else if (N <= 128 || store == STORE_INT8 ||
           wave_fill(mt * ((N + 127) / 128), d.sms) > wave_fill(mt * ((N + 255) / 256), d.sms) + 0.15)
    fill_plan<128>(p, d, M, N);
  else
    fill_plan<256>(p, d, M, N);
  return p;
}

template <int BN, int STORE, bool GROUPED = false>
int launch(const Plan& p, const void* a, const void* b, void* c, int M, int N, int K,
           long long ldc, const Epilogue& epi, cudaStream_t stream) {
  if (p.stages < 2) return ERR_ARGS;
  CUtensorMap ta, tb, tc;
  // B: int8[N, K], or packed uint8[N, K / 2] in 64-byte unswizzled boxes.
  const int kb = PACKED ? K / 2 : K;
  if (!encode(&ta, a, 1, M, K, K, BM) || !encode(&tb, b, 1, N, kb, kb, BN, PACKED) ||
      !encode(&tc, c, StoreTraits<STORE>::BYTES, M, N, ldc, 64, narrow_store(BN, STORE, GROUPED)))
    return ERR_ENCODE;
  auto kernel = int8_gemm_kernel<BN, STORE, GROUPED>;
  static int smem_set = 0;  // per instantiation: the opt-in is made once
  if (smem_set < p.smem) {
    const int most = device_info().smem;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = most;
  }
  kernel<<<p.grid, THREADS, p.smem, stream>>>(ta, tb, tc, M, N, K, p.stages, epi);
  return static_cast<int>(cudaGetLastError());
}

template <int STORE>
int dispatch(const Plan& p, const void* a, const void* b, void* c, int M, int N, int K,
             long long ldc, const Epilogue& epi, cudaStream_t s) {
  if (epi.group) {  // the grouped mode stores f32 or int8, in 64-wide tiles
    if constexpr (STORE == STORE_F32 || STORE == STORE_INT8)
      return launch<64, STORE, true>(p, a, b, c, M, N, K, ldc, epi, s);
    else
      return ERR_ARGS;
  }
  if (p.bn == 64) return launch<64, STORE>(p, a, b, c, M, N, K, ldc, epi, s);
  if constexpr (STORE == STORE_INT8) {  // plan() keeps the int8 store at BN <= 128
    return launch<128, STORE>(p, a, b, c, M, N, K, ldc, epi, s);
  } else {
    return p.bn == 128 ? launch<128, STORE>(p, a, b, c, M, N, K, ldc, epi, s)
                       : launch<256, STORE>(p, a, b, c, M, N, K, ldc, epi, s);
  }
}

}  // namespace

// a: int8[M,K], b: int8[N,K], both contiguous, 16-byte aligned, K % 16 == 0
// (this library built with QT_PACKED_B: b is uint8[N, K/2] nibble-packed,
// K % 32 == 0).
// The epilogue's vectors are contiguous and 8-byte aligned.
// store: 0 int32 (no epilogue), 1 f32, 2 bf16, 3 int8 (out_s, out_zp); c is
// [M, ldc] of that type (ldc >= N, ldc * its size % 16 == 0, 16-byte
// aligned), of which the kernel writes the first N columns. cs: f32[N]
// (stores 1-3); rs: f32[M] or null; bias: f32[N] or null; zpw: int32[N] or
// null; act: 0 none, 1 relu, 2 relu6. group > 0 is the grouped mode: gs
// f32[G, N] and gzpw int32[G, N] with G = K / group, group a multiple of 32
// that divides K, store 1 or 3, no zpw and no rs. Launches on `stream`,
// allocates nothing, does not synchronize. Returns cudaGetLastError() after
// the launch, or a negative code if the kernel was not launched.
extern "C" int int8_gemm(const void* a, const void* b, void* c, long long M, long long N,
                         long long K, long long ldc, int store, const void* cs, const void* rs,
                         const void* bias, const void* zpw, int act, float out_s, float out_zp,
                         const void* gs, const void* gzpw, long long group, void* stream) {
  const long long big = 1LL << 31;
  const int esize = store == STORE_INT8 ? 1 : store == STORE_BF16 ? 2 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || M >= big || N >= big || K >= big || K % (PACKED ? 32 : 16) != 0 ||
      ldc < N || (ldc * esize) % 16 != 0 || (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(b) & 15) || (reinterpret_cast<uintptr_t>(c) & 15) ||
      store < STORE_INT32 || store > STORE_INT8 || (store != STORE_INT32 && !cs) || act < 0 ||
      act > qt::ACT_RELU6)
    return ERR_ARGS;
  if (group != 0 && (group < 0 || group % 32 != 0 || K % group != 0 || !gs || !gzpw || zpw || rs ||
                     (store != STORE_F32 && store != STORE_INT8)))
    return ERR_ARGS;
  const Epilogue epi{static_cast<const float*>(cs), static_cast<const float*>(rs),
                     static_cast<const float*>(bias), static_cast<const int32_t*>(zpw),
                     qt::make_activation(act), qt::make_out_quant(out_s, out_zp, qt::make_activation(act).hi),
                     static_cast<const float*>(gs),
                     static_cast<const int32_t*>(gzpw), static_cast<int>(group)};
  const auto s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), n = static_cast<int>(N), k = static_cast<int>(K);
  const Plan p = plan(m, n, store, group != 0);
  switch (store) {
    case STORE_INT32: return dispatch<STORE_INT32>(p, a, b, c, m, n, k, ldc, epi, s);
    case STORE_F32: return dispatch<STORE_F32>(p, a, b, c, m, n, k, ldc, epi, s);
    case STORE_BF16: return dispatch<STORE_BF16>(p, a, b, c, m, n, k, ldc, epi, s);
    default: return dispatch<STORE_INT8>(p, a, b, c, m, n, k, ldc, epi, s);
  }
}

#if !QT_PACKED_B
// q[i] = the int8 store's requantize of y[i] into (out_s, out_zp); y: f32[n],
// q: int8[n]. Launches on `stream`; returns cudaGetLastError().
extern "C" int int8_requantize(const void* y, void* q, long long n, float out_s, float out_zp,
                               void* stream) {
  if (n <= 0) return ERR_ARGS;
  Epilogue e{};
  e.oq = qt::make_out_quant(out_s, out_zp, qt::make_activation(qt::ACT_NONE).hi);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  requantize_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<int8_t*>(q), n, e);
  return static_cast<int>(cudaGetLastError());
}
#endif
