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
// Grouped-K mode (W4A8, quantnet/ops/linear.py:228-253, whose G-batched int8
// dot_general is not a Pallas kernel): the weight's scale changes every `group`
// rows of K, so the reduction splits into G = K / group products, each a
// K-slice of the same A and B, folded in f32 in group order: facc = ((0 + t_0)
// + t_1) + ... with t_g = float(acc_g - gzpw[g, n]) * gs[g, n] (the JAX
// package's jnp.sum over G); the epilogue then takes facc with s = cs[n] (the
// activation scale). The (G, M, N) accumulator of the JAX package never reaches
// device memory. The group is a multiple of 32 (one k32 wgmma) and divides K;
// the mode runs 64-wide tiles and stores f32 or int8. A consumer keeps two
// int32 accumulator sets and issues its wgmmas in steps (a group's part of one
// stage), each its own commit group: while the wgmmas of group g run into one
// set, the other set's group g - 1 is waited for (wgmma_wait<1>) and folded, so
// the tensor cores do not drain at a group boundary; a group's first wgmma does
// not accumulate (scale-d 0), so no instruction clears a set while the other's
// wgmmas run. Each group's gs and gzpw are read into registers two groups
// before its fold. Where the tiles number fewer than the SMs and M <= 64, a
// thread-block cluster of up to 8 CTAs splits each tile's groups: CTA r takes a
// contiguous range of whole groups (and of stages), folds nothing itself but
// keeps each group's t_g apart in shared memory as its products complete (rank
// 0 folds into registers from 0), then waits for the running sum from CTA r - 1
// (stored into its shared memory through the cluster's distributed shared
// memory, with an arrive on its mbarrier), adds its t_g in order and hands the
// sum on; the last CTA runs the epilogue and the store. So the sum is the same
// sequence of f32 adds, bit for bit, and only those adds are serial.
//
// Packed-B mode (the s4 runtime's 4-bit weights; built as a library of its
// own with QT_PACKED_B=1, quantnet_torch/_build.py VARIANTS, in both the
// normal and the grouped-K mode and for every store): B is uint8[N, K/2],
// two's-complement nibbles packed along K, the even k in the low nibble, K a
// multiple of 32. At bs1 the weight's bytes bound the product, and halving
// them is the lever; at the convnet's bs1024 shapes A's bytes dominate. A
// ring stage carries A and BN x 64 bytes of packed B (a tensor map of its
// own, 64-byte box, no swizzle). The producer warpgroup's three idle warps
// widen it into one of `slots` widened slots outside the ring (BN rows of
// 128 bytes in the 128-byte swizzle wgmma reads), then fence.proxy.async
// (wgmma reads through the async proxy what they wrote through the generic
// one). A nibble goes into its byte's high half, 16 times its value (two
// logic ops and two byte permutes per four bytes, no sign extension); the
// int32 sums are shifted right by 4, exactly. Each slot has a pair of
// mbarriers (widened: the unpackers to the consumers; free: the consumers'
// wgmmas on it have completed), so widening runs up to `slots` stages ahead
// of the wgmmas: four slots where the ring keeps the int8-wide launch's
// stage count (the int8 store's staging buffers give up the room). Keeping
// the whole widened B resident per block, where N fits one tile, measured
// no faster than four slots, so B always streams. Where the tiles number
// fewer than the SMs (a bs1 forward) and K runs to 16 stages or more, a
// cluster of up to 8 CTAs splits each tile's K stages; ranks 1.. add their
// int32 partials into rank 0's shared memory (red.shared::cluster.add,
// exact in any order) and arrive on its mbarrier, and rank 0 runs the
// epilogue and the one store.
// TMA's zero fill past N and K gives zero bytes, which widen to zeros: so
// the integers, and every store, are the int8-wide launch's on the widened
// weight, bit for bit.
//
// The launch plan (tile width, stages, grid, split, widened slots, held
// groups, shared memory bytes) is made in Python, ops/int8_matmul.py::
// k1_plan, with the same shared-memory arithmetic as Layout below, and
// passed in. The host side here checks it (the int8-wide normal mode: equal
// to plan() below) and returns ERR_ARGS on a plan it does not take.
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
constexpr int MAX_SPLIT = 8;      // CTAs of a cluster (the portable most)
constexpr int MAX_SLOTS = 4;      // packed mode: widened B slots
constexpr int ALIGN = 1024;       // the 128-byte swizzle repeats every 8 rows
constexpr bool PACKED = QT_PACKED_B != 0;  // B nibble-packed (this library's mode)
constexpr int UNPACKERS = 96;     // packed mode: warps 1-3 of the producer warpgroup
constexpr int OUT_BUF = 64 * 128; // a staging buffer: 64 rows x one 128-byte swizzle row

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

// Staging buffers of a consumer (TMA stores in flight): two at BN = 256,
// where more would cost a stage of the ring, and for the int8 store of the
// packed and grouped modes (one chunk a tile), whose space goes to widened
// slots and stages.
__host__ __device__ constexpr int out_bufs(int bn, int store, bool modes) {
  return bn == 256 || (modes && store == STORE_INT8) ? 2 : 4;
}

// The launch's plan (ops/int8_matmul.py::k1_plan makes it; the host side
// checks it) and what the kernel needs of it.
struct Params {
  int M, N, K;
  int stages;     // ring stages
  int split;      // CTAs of a cluster sharing one tile's K (1: none)
  int slots;      // packed mode: widened B slots (2-4)
  int held;       // grouped split: groups a rank keeps apart
  int held_rows;  // grouped split: rows of a tile those groups keep (16 | it)
  int unit;       // grouped split: K rows of the unit ranks split by, lcm(group, BK)
};

// Shared memory of one block, in this order (byte offsets from the
// 1024-aligned base): the ring of `stages` stages (A, then B: int8 BN x
// 128, or packed BN x 64); the packed mode's `slots` widened B slots (BN x
// 128 each); a packed split's int32
// partials (rank 0 sums them there); the grouped split's held t_g (held x
// held_rows x BN f32); both consumers' staging buffers for the TMA store (in
// a grouped split, also where the running sum is handed in); the mbarriers.
// ops/int8_matmul.py::layout_bytes is the same arithmetic.
struct Layout {
  int stage, ring, wide, reduce, held, staging, bars, total;
};

__host__ __device__ inline Layout make_layout(int bn, bool grouped, int store, int stages, int slots,
                                              int split, int held, int held_rows) {
  Layout l;
  l.stage = BM * BK + (PACKED ? bn * BK / 2 : bn * BK);
  l.ring = stages * l.stage;
  l.wide = l.ring;
  l.reduce = l.wide + (PACKED ? slots * bn * BK : 0);
  l.held = l.reduce + (PACKED && !grouped && split > 1 ? 2 * 64 * bn * 4 : 0);
  l.staging = l.held + (grouped && split > 1 ? held * held_rows * bn * 4 : 0);
  l.bars = l.staging + 2 * out_bufs(bn, store, PACKED || grouped) * OUT_BUF;
  l.total = ALIGN + l.bars + (!PACKED && split == 1 ? 2 * MAX_STAGES * 8 : 256);
  return l;
}

// mbarrier slots after the staging buffers: the ring's (full: the bytes
// arrived; empty: both consumers are done with the stage); the packed
// mode's widened slots (widened, free); a split's hand-off (one per
// consumer warpgroup) and reduction.
enum Bar {
  BAR_FULL = 0, BAR_EMPTY = MAX_STAGES, BAR_WIDE = 2 * MAX_STAGES, BAR_FREE = BAR_WIDE + MAX_SLOTS,
  BAR_HAND = BAR_FREE + MAX_SLOTS, BAR_REDUCE = BAR_HAND + 2
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

// The same wait with acquire at cluster scope: for a barrier that another
// CTA of the cluster arrives on after writing this CTA's shared memory.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Thread-block clusters: this CTA's rank, the address of `p` in the shared
// memory of CTA `rank`, stores, integer adds and mbarrier arrives there, and
// a barrier over every thread of the cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void red_cluster_add(uint32_t addr, int v) {
  asm volatile("red.shared::cluster.add.s32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote_bar) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::: "memory");
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
// to NBUF stores drain while the next chunks, and the next tile's
// products, are computed. `cols` holds the first chunk's per-column vectors
// and `rs` the two rows' per-row scales, read before the products.
template <int BN, int STORE, bool NARROW, int NBUF, typename T>
__device__ __forceinline__ void store_tile(T (&acc)[BN / 2], const CUtensorMap* tmap_c, int M,
                                           int N, int row0, int n0, const Epilogue& e,
                                           ChunkCols<Chunks<BN, STORE>::PV> cols,
                                           const float (&rs)[2], uint8_t* stg, int tid,
                                           int barrier_id, unsigned& seq) {
  using C = Chunks<BN, STORE>;
#pragma unroll
  for (int q = 0; q < C::CHUNKS; ++q, ++seq) {
    uint8_t* buf = stg + (seq % NBUF) * OUT_BUF;
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
// nibble of each byte) -> eight int8 values in a (the first four) and b,
// each 16 times its nibble's value: the nibble moved into its byte's high
// half, the low half zero (two logic ops and two byte permutes; no sign
// extension). Every product, and so every int32 sum, is then 16 times the
// int8-wide one, which an arithmetic shift right by 4 gives back exactly.
__device__ __forceinline__ void unpack_nibbles8(uint32_t x, uint32_t& a, uint32_t& b) {
  const uint32_t lo = (x << 4) & 0xF0F0F0F0u, hi = x & 0xF0F0F0F0u;
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

template <int BN, int STORE, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
                     const __grid_constant__ CUtensorMap tmap_b,
                     const __grid_constant__ CUtensorMap tmap_c, const Params p, const Epilogue epi) {
  // The packed library and the grouped mode take the plan's split, widened
  // slots and held groups; the int8-wide normal mode is one persistent block
  // per SM with the plan's stages.
  constexpr bool MODES = PACKED || GROUPED;
  const int M = p.M, N = p.N, K = p.K, stages = p.stages;
  const int split = MODES ? p.split : 1;
  const int ksteps = (K + BK - 1) / BK;
  const Layout lay = make_layout(BN, GROUPED, STORE, stages, p.slots, split, p.held, p.held_rows);
  constexpr int NBUF = out_bufs(BN, STORE, MODES);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  uint8_t* wide = ring + lay.wide;
  uint8_t* reduce = ring + lay.reduce;
  float* held = reinterpret_cast<float*>(ring + lay.held);
  uint8_t* staging = ring + lay.staging;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + lay.bars);
  uint64_t* full = bars + BAR_FULL;
  uint64_t* empty = bars + BAR_EMPTY;

  const int num_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * num_n;
  // The warpgroup index; in the packed and grouped modes warp-uniform to
  // the compiler (as it is): wgmma in a branch on a value it takes for
  // divergent is serialized.
  const int wg = MODES ? __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0)
                       : static_cast<int>(threadIdx.x) / 128;
  const int tid = threadIdx.x % 128;
  // A split: cluster t takes tile t and CTA `rank` its part of K; otherwise
  // the persistent grid walks the tiles. This CTA's K rows [kb, ke) are
  // whole stages ks0 .. ks1 - 1 (a grouped split's ranks take whole units
  // of lcm(group, BK) rows, so whole groups).
  const int rank = split > 1 ? __shfl_sync(~0u, static_cast<int>(cluster_rank()), 0) : 0;
  const int t_first = split > 1 ? static_cast<int>(blockIdx.x) / split : static_cast<int>(blockIdx.x);
  const int t_step = split > 1 ? tiles : static_cast<int>(gridDim.x);
  int kb = 0, ke = K;
  if (split > 1) {
    if (GROUPED) {
      const int units = K / p.unit;
      kb = units * rank / split * p.unit;
      ke = units * (rank + 1) / split * p.unit;
    } else {
      kb = ksteps * rank / split * BK;
      ke = min(ksteps * (rank + 1) / split * BK, K);
    }
  }
  const int ks0 = kb / BK, ks1 = (ke + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    if constexpr (PACKED) {
      for (int s = 0; s < p.slots; ++s) {
        mbar_init(&bars[BAR_WIDE + s], UNPACKERS);
        mbar_init(&bars[BAR_FREE + s], CONSUMERS);
      }
    }
    if (split > 1) {
      mbar_init(&bars[BAR_HAND], 128);
      mbar_init(&bars[BAR_HAND + 1], 128);
      mbar_init(&bars[BAR_REDUCE], (split - 1) * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  // A split of the packed normal mode: rank 0's reduce area takes the other
  // ranks' int32 partials by atomic adds, from zero.
  if (PACKED && !GROUPED && split > 1 && rank == 0) {
    uint4* z = reinterpret_cast<uint4*>(reduce);
    for (int i = threadIdx.x; i < 2 * 64 * BN * 4 / 16; i += THREADS) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (split > 1) cluster_sync();  // every CTA's barriers (and rank 0's zeros) before any remote access

  if (wg == 0) {
    // The packed and grouped modes hand the producer warpgroup's registers
    // to the consumers (two accumulator sets, or a 256-wide tile, and the
    // epilogue).
    if constexpr (MODES) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid >= 32) {
      // Packed mode: warps 1-3 widen each stage's B into the next free slot
      // once the stage has arrived.
      if constexpr (PACKED) {
        const int u = tid - 32;
        int stage = 0, slot = 0;
        unsigned phase = 0, sphase = 0;
        for (int t = t_first; t < tiles; t += t_step) {
          for (int ks = ks0; ks < ks1; ++ks) {
            mbar_wait(&full[stage], phase);
            mbar_wait(&bars[BAR_FREE + slot], sphase ^ 1);
            unpack_stage<BN>(ring + stage * lay.stage + BM * BK, wide + slot * (BN * BK), u);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
            mbar_arrive(&bars[BAR_WIDE + slot]);
            if (++stage == stages) stage = 0, phase ^= 1;
            if (++slot == p.slots) slot = 0, sphase ^= 1;
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
    const unsigned bytes = BM * BK + (PACKED ? BN * BK / 2 : BN * BK);
    int stage = 0;
    unsigned phase = 0;
    for (int t = t_first; t < tiles; t += t_step) {
      const int m0 = (t / num_n) * BM, n0 = (t % num_n) * BN;
      for (int ks = ks0; ks < ks1; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sa = ring + stage * lay.stage;
        mbar_expect_tx(&full[stage], bytes);
        tma_load(sa, &tmap_a, &full[stage], ks * BK, m0, keep_a);
        tma_load(sa + BM * BK, &tmap_b, &full[stage], PACKED ? ks * BK / 2 : ks * BK, n0, keep_b);
        if (++stage == stages) stage = 0, phase ^= 1;
      }
    }
    return;
  } else {
    if constexpr (MODES) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    // Consumers: warpgroup c = wg - 1 owns rows 64c .. 64c + 63 of each tile.
    const int c = wg - 1;
    uint8_t* stg = staging + c * NBUF * OUT_BUF;
    unsigned seq = 0;  // chunks stored so far
    const int rq = (tid >> 5) * 16 + ((tid & 31) >> 2);  // this thread's first fragment row
    int stage = 0;
    unsigned phase = 0;
    if constexpr (!MODES) {
      int acc[BN / 2];
      int prev = 0;
      for (int t = t_first; t < tiles; t += t_step) {
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
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(&full[stage], phase);
          const uint8_t* sa = ring + stage * lay.stage + c * 64 * BK;
          const uint8_t* sb = ring + stage * lay.stage + BM * BK;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk) {
            // Past K the tile holds zeros: skip those products.
            if (ks * BK + kk * 32 < K)
              qt::WgmmaS8<BN>::mma(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk));
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
        store_tile<BN, STORE, false, NBUF>(acc, &tmap_c, M, N, m0 + 64 * c, n0, epi, cols, rs, stg, tid,
                                     1 + c, seq);
      }
    } else {
      // The packed mode's widened slots and the stages given back, in order:
      // the ring's and, in the packed mode, the slot's.
      int slot = 0, rel = 0, rel_slot = 0;
      unsigned sphase = 0;
      // The epilogue's per-column and per-row values of a tile, read while its
      // products run.
      auto load_epilogue = [&](ChunkCols<Chunks<BN, STORE>::PV>& cols, float (&rs)[2], int m0, int n0) {
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
      };
      auto acquire = [&](const uint8_t*& sa, const uint8_t*& sb) {
        mbar_wait(&full[stage], phase);
        sa = ring + stage * lay.stage + c * 64 * BK;
        if constexpr (PACKED) {
          mbar_wait(&bars[BAR_WIDE + slot], sphase);
          sb = wide + slot * (BN * BK);
        } else {
          sb = ring + stage * lay.stage + BM * BK;
        }
      };
      auto advance = [&]() {
        if (++stage == stages) stage = 0, phase ^= 1;
        if (PACKED && ++slot == p.slots) slot = 0, sphase ^= 1;
      };
      auto release = [&]() {
        mbar_arrive(&empty[rel]);
        if (++rel == stages) rel = 0;
        if (PACKED) {
          mbar_arrive(&bars[BAR_FREE + rel_slot]);
          if (++rel_slot == p.slots) rel_slot = 0;
        }
      };
      if constexpr (!GROUPED) {
        // Packed mode, normal: as above, over this CTA's stages.
        int acc[BN / 2];
        for (int t = t_first; t < tiles; t += t_step) {
          const int m0 = (t / num_n) * BM, n0 = (t % num_n) * BN;
          ChunkCols<Chunks<BN, STORE>::PV> cols{};
          float rs[2] = {0.0f, 0.0f};
          load_epilogue(cols, rs, m0, n0);
          const bool active = m0 + 64 * c < M;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
          for (int ks = ks0; ks < ks1; ++ks) {
            const uint8_t *sa, *sb;
            acquire(sa, sb);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 32; ++kk) {
              if (ks * BK + kk * 32 < K)
                qt::WgmmaS8<BN>::mma(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk));
            }
            wgmma_commit();
            wgmma_wait<1>();
            if (ks > ks0) release();
            advance();
          }
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
          release();
          if (split > 1) {
            // Ranks 1.. add their int32 partials into rank 0's reduce area
            // (this warpgroup's half, thread-major; none where its rows all lie
            // past M), then arrive on its barrier.
            uint8_t* part_c = reduce + c * 64 * BN * 4;
            if (rank != 0) {
              const uint32_t dst = map_rank(part_c, 0);
              if (active) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) red_cluster_add(dst + 4 * (i * 128 + tid), acc[i]);
              }
              mbar_arrive_cluster(map_rank(&bars[BAR_REDUCE], 0));
              continue;
            }
            mbar_wait_cluster(&bars[BAR_REDUCE], 0);
            const int* part = reinterpret_cast<const int*>(part_c);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] += part[i * 128 + tid];
          }
          // The widened weight is 16 x the nibbles: so is every sum.
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] >>= 4;
          store_tile<BN, STORE, false, NBUF>(acc, &tmap_c, M, N, m0 + 64 * c, n0, epi, cols, rs, stg, tid,
                                       1 + c, seq);
        }
      } else {
        // Grouped mode: two accumulator sets, steps of (a group) x (a stage),
        // each a commit group. After a group's first step is issued, the
        // previous group's set is waited for and folded (rank 0: into facc,
        // in order; ranks 1..: its t_g kept in `held`), and the gs and gzpw
        // of the group after this one are read into that set's vectors, two
        // groups ahead of their fold (a load's latency is longer than one
        // group's products).
        int acc0[BN / 2], acc1[BN / 2];
        float facc[BN / 2];
        int z0[BN / 4], z1[BN / 4];
        float s0[BN / 4], s1[BN / 4];
        const int gc = epi.group / 32;  // k32 chunks of a group
        const int warp = __shfl_sync(~0u, tid >> 5, 0), lane = tid & 31, cq = 2 * (tid & 3);
        const int gw = 4 * c + warp;  // this warp's rows of the tile: 16 gw .. 16 gw + 15
        const bool holds = 16 * gw < p.held_rows;
        const int hw = p.held_rows / 16;
        for (int t = t_first; t < tiles; t += t_step) {
          const int m0 = (t / num_n) * BM, n0 = (t % num_n) * BN;
          ChunkCols<Chunks<BN, STORE>::PV> cols{};
          float rs[2] = {0.0f, 0.0f};
          load_epilogue(cols, rs, m0, n0);
          const int c_end = ke / 32, g0 = kb / epi.group, g1 = ke / epi.group;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) facc[i] = 0.0f;
          bool pend = false;  // the last step ended a stage: give it back once done
          const uint8_t *sa = nullptr, *sb = nullptr;
          // Group g's gs and gzpw at this thread's columns, in pairs where N
          // is even (8-byte aligned rows).
          auto load_vec = [&](int (&vz)[BN / 4], float (&vs)[BN / 4], int g) {
            const int32_t* z = epi.gzpw + static_cast<size_t>(g) * N;
            const float* s = epi.gs + static_cast<size_t>(g) * N;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = n0 + 8 * j + cq;
              if ((N & 1) == 0) {
                const int2 zz = col < N ? __ldg(reinterpret_cast<const int2*>(z + col)) : make_int2(0, 0);
                const float2 ss =
                    col < N ? __ldg(reinterpret_cast<const float2*>(s + col)) : make_float2(0.0f, 0.0f);
                vz[2 * j] = zz.x, vz[2 * j + 1] = zz.y, vs[2 * j] = ss.x, vs[2 * j + 1] = ss.y;
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  vz[2 * j + e] = col + e < N ? __ldg(z + col + e) : 0;
                  vs[2 * j + e] = col + e < N ? __ldg(s + col + e) : 0.0f;
                }
              }
            }
          };
          // t_g = float(acc_g - gzpw[g, n]) * gs[g, n], columns past N zeros
          // (a packed B's acc_g is 16 x the int8-wide one); rank 0 adds it to
          // facc, a later rank keeps it. The set is not cleared: the next
          // group's first wgmma into it does not accumulate.
          auto retire = [&](int (&x)[BN / 2], const int (&vz)[BN / 4], const float (&vs)[BN / 4], int g) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) fence_reg(x[i]);
            auto term = [&](int i) {
              const int v = (i / 4) * 2 + (i & 1);  // column 8 (i / 4) + cq + (i & 1)
              return __fmul_rn(__int2float_rn((PACKED ? x[i] >> 4 : x[i]) - vz[v]), vs[v]);
            };
            if (rank == 0) {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) facc[i] = __fadd_rn(facc[i], term(i));
            } else if (holds) {
              float* h = held + ((g - g0) * hw + gw) * (BN / 2) * 32 + lane;
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) h[i * 32] = term(i);
            }
          };
          // Group g into x (vectors zx, sx, read before); group g - 1 is in y
          // (vectors zy, sy), which then take group g + 1's.
          auto run_group = [&](int (&x)[BN / 2], int (&y)[BN / 2], int (&zy)[BN / 4], float (&sy)[BN / 4],
                               int g) {
            for (int ci = g * gc; ci < (g + 1) * gc;) {
              const int kk = ci & 3;
              if (kk == 0) acquire(sa, sb);
              const int n = min((g + 1) * gc - ci, 4 - kk);
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) fence_reg(x[i]);
              wgmma_fence();
              for (int q = 0; q < n; ++q)
                qt::WgmmaS8<BN>::mma(x, smem_desc(sa + 32 * (kk + q)), smem_desc(sb + 32 * (kk + q)),
                                     q > 0 || ci > g * gc);
              wgmma_commit();
              const bool ends = kk + n == 4 || ci + n == c_end;
              wgmma_wait<1>();  // the step before this one is done
              if (pend) release();
              if (ci == g * gc) {
                if (g > g0) retire(y, zy, sy, g - 1);
                if (g + 1 < g1) load_vec(zy, sy, g + 1);
              }
              pend = ends;
              if (ends) advance();
              ci += n;
            }
          };
          // Groups g0, g0 + 2, .. run in acc0 with vectors z0, s0; the others
          // in acc1 with z1, s1.
          load_vec(z0, s0, g0);
          run_group(acc0, acc1, z1, s1, g0);
          int g = g0 + 1;
          for (; g + 1 < g1; g += 2) {
            run_group(acc1, acc0, z0, s0, g);
            run_group(acc0, acc1, z1, s1, g + 1);
          }
          if (g < g1) {
            run_group(acc1, acc0, z0, s0, g);
            wgmma_wait<0>();
            retire(acc1, z1, s1, g);
          } else {
            wgmma_wait<0>();
            retire(acc0, z0, s0, g - 1);
          }
          if (pend) release();
          if (split > 1) {
            // The ordered hand-off: the running sum from rank - 1, this rank's
            // t_g added in order, the sum on to rank + 1 (into this warpgroup's
            // staging buffers there, warp-major); the last rank stores.
            if (rank > 0) {
              mbar_wait_cluster(&bars[BAR_HAND + c], 0);
              const float* sum = reinterpret_cast<const float*>(stg);
              if (holds) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) facc[i] = sum[(warp * (BN / 2) + i) * 32 + lane];
                for (int j = 0; j < g1 - g0; ++j) {
#pragma unroll
                  for (int i = 0; i < BN / 2; ++i)
                    facc[i] = __fadd_rn(facc[i], held[((j * hw + gw) * (BN / 2) + i) * 32 + lane]);
                }
              }
            }
            if (rank + 1 < split) {
              const uint32_t dst = map_rank(stg, rank + 1);
              if (holds) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i)
                  st_cluster(dst + 4 * ((warp * (BN / 2) + i) * 32 + lane), facc[i]);
              }
              mbar_arrive_cluster(map_rank(&bars[BAR_HAND + c], rank + 1));
              continue;
            }
          }
          store_tile<BN, STORE, narrow_store(BN, STORE, true), NBUF>(facc, &tmap_c, M, N, m0 + 64 * c, n0, epi,
                                                               cols, rs, stg, tid, 1 + c, seq);
        }
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
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

// How a launch is laid out (ops/int8_matmul.py::Plan).
struct Plan {
  int bn = 0, stages = 0, grid = 0, smem = 0, split = 1, slots = 0, held = 0, held_rows = 0;
};

int gcd_int(int a, int b) { return b ? gcd_int(b, a % b) : a; }

// The int8-wide normal mode's plan. The narrowest tile that covers N, up to
// 256 (A is read once). Past 128, 128-wide tiles for the int8 store (its
// epilogue's registers spill beside 128 accumulators a thread) and where
// 256-wide ones would leave much of the last wave idle (ResNet-50's 25088 x
// K x 256 GEMMs: 196 tiles on 132 SMs, against 392); their A tile is read
// again from L2. As many stages as fit, one persistent block per SM.
Plan plan(int M, int N, int K, int store) {
  const DeviceInfo& d = device_info();
  Plan p;
  const long long mt = (M + BM - 1) / BM;
  if (N <= 64)
    p.bn = 64;
  else if (N <= 128 || store == STORE_INT8 ||
           wave_fill(mt * ((N + 127) / 128), d.sms) > wave_fill(mt * ((N + 255) / 256), d.sms) + 0.15)
    p.bn = 128;
  else
    p.bn = 256;
  const Layout none = make_layout(p.bn, false, store, 0, 0, 1, 0, 0);
  const int stages = (d.smem - none.total) / make_layout(p.bn, false, store, 1, 0, 1, 0, 0).stage;
  p.stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  p.smem = make_layout(p.bn, false, store, p.stages, 0, 1, 0, 0).total;
  const long long tiles = mt * ((N + p.bn - 1) / p.bn);
  p.grid = static_cast<int>(tiles < d.sms ? tiles : d.sms);
  return p;
}

// Whether the kernel takes `p` for this launch: the int8-wide normal mode
// exactly plan() above; the packed library and the grouped mode a plan
// whose tile, stages, split, slots and held groups fit the shapes and
// whose shared memory is Layout's and within the device's.
bool takes(const Plan& p, int M, int N, int K, int store, int group) {
  const DeviceInfo& d = device_info();
  const bool grouped = group != 0;
  const int ksteps = (K + BK - 1) / BK;
  if (!PACKED && !grouped) {
    const Plan q = plan(M, N, K, store);
    return p.bn == q.bn && p.stages == q.stages && p.grid == q.grid && p.smem == q.smem && p.split == 1 &&
           !p.slots && !p.held && !p.held_rows;
  }
  if ((p.bn != 64 && p.bn != 128 && p.bn != 256) || (grouped && p.bn != 64) ||
      (store == STORE_INT8 && p.bn == 256) || p.stages < 2 || p.stages > MAX_STAGES || p.split < 1 ||
      p.split > MAX_SPLIT || p.held < 0 || p.held_rows < 0)
    return false;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + p.bn - 1) / p.bn);
  // The packed mode widens into 2 to MAX_SLOTS slots.
  if (PACKED ? p.slots < 2 || p.slots > MAX_SLOTS : p.slots != 0) return false;
  if (p.split == 1) {
    if (p.grid != (tiles < d.sms ? tiles : d.sms) || p.held || p.held_rows) return false;
  } else if (tiles * p.split != p.grid) {
    return false;
  } else if (!grouped) {
    if (!PACKED || p.bn > 128 || p.split > ksteps || p.held || p.held_rows) return false;
  } else {
    const int unit = group / gcd_int(group, BK) * BK;
    if (K % unit) return false;
    const int units = K / unit;
    if (p.split > units) return false;
    int need = 0;  // the most groups a rank past 0 holds
    for (int r = 1; r < p.split; ++r) {
      const int n = (units * (r + 1) / p.split - units * r / p.split) * (unit / group);
      need = n > need ? n : need;
    }
    const int rows = M >= BM ? BM : (M + 15) / 16 * 16;
    if (p.held < need || p.held_rows != rows) return false;
  }
  const Layout l = make_layout(p.bn, grouped, store, p.stages, p.slots, p.split, p.held, p.held_rows);
  return l.total == p.smem && p.smem <= d.smem;
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Params, Epilogue);

// The kernel's instantiation for a tile width, a store and the mode (13:
// the int8 store has no 256-wide tile; the grouped mode stores f32 or int8
// at BN = 64), or null.
Kernel kernel_for(int bn, int store, bool grouped) {
  if (grouped) {
    if (bn != 64) return nullptr;
    return store == STORE_F32 ? int8_gemm_kernel<64, STORE_F32, true>
           : store == STORE_INT8 ? int8_gemm_kernel<64, STORE_INT8, true> : nullptr;
  }
  switch (bn * 4 + store) {
    case 64 * 4 + STORE_INT32: return int8_gemm_kernel<64, STORE_INT32, false>;
    case 64 * 4 + STORE_F32: return int8_gemm_kernel<64, STORE_F32, false>;
    case 64 * 4 + STORE_BF16: return int8_gemm_kernel<64, STORE_BF16, false>;
    case 64 * 4 + STORE_INT8: return int8_gemm_kernel<64, STORE_INT8, false>;
    case 128 * 4 + STORE_INT32: return int8_gemm_kernel<128, STORE_INT32, false>;
    case 128 * 4 + STORE_F32: return int8_gemm_kernel<128, STORE_F32, false>;
    case 128 * 4 + STORE_BF16: return int8_gemm_kernel<128, STORE_BF16, false>;
    case 128 * 4 + STORE_INT8: return int8_gemm_kernel<128, STORE_INT8, false>;
    case 256 * 4 + STORE_INT32: return int8_gemm_kernel<256, STORE_INT32, false>;
    case 256 * 4 + STORE_F32: return int8_gemm_kernel<256, STORE_F32, false>;
    case 256 * 4 + STORE_BF16: return int8_gemm_kernel<256, STORE_BF16, false>;
    default: return nullptr;
  }
}

// The shared-memory opt-in, made once per instantiation (the device's most).
cudaError_t opt_in(Kernel kernel) {
  static Kernel done[16];
  for (Kernel k : done)
    if (k == kernel) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               device_info().smem);
  if (err != cudaSuccess) return err;
  for (Kernel& k : done)
    if (!k) {
      k = kernel;
      break;
    }
  return cudaSuccess;
}

// A launch configuration of `grid` CTAs in clusters of `split` (none at 1).
struct LaunchConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  LaunchConfig(int grid, int split, int smem, cudaStream_t stream) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = split > 1 ? 1 : 0;
  }
};

int launch(const Plan& p, const void* a, const void* b, void* c, int M, int N, int K, long long ldc,
           int store, const Epilogue& epi, cudaStream_t stream) {
  const bool grouped = epi.group != 0;
  const Kernel kernel = kernel_for(p.bn, store, grouped);
  if (!kernel) return ERR_ARGS;
  CUtensorMap ta, tb, tc;
  // B: int8[N, K], or packed uint8[N, K / 2] in 64-byte unswizzled boxes.
  const int kb = PACKED ? K / 2 : K;
  const int esize = store == STORE_INT8 ? 1 : store == STORE_BF16 ? 2 : 4;
  if (!encode(&ta, a, 1, M, K, K, BM) || !encode(&tb, b, 1, N, kb, kb, p.bn, PACKED) ||
      !encode(&tc, c, esize, M, N, ldc, 64, narrow_store(p.bn, store, grouped)))
    return ERR_ENCODE;
  const cudaError_t err = opt_in(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int unit = grouped ? epi.group / gcd_int(epi.group, BK) * BK : 0;
  const Params prm{M, N, K, p.stages, p.split, p.slots, p.held, p.held_rows, unit};
  if (p.split > 1) {
    LaunchConfig lc(p.grid, p.split, p.smem, stream);
    cudaLaunchKernelEx(&lc.cfg, kernel, ta, tb, tc, prm, epi);
  } else {
    kernel<<<p.grid, THREADS, p.smem, stream>>>(ta, tb, tc, prm, epi);
  }
  return static_cast<int>(cudaGetLastError());
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
// that divides K, store 1 or 3, no zpw and no rs. bn .. held_rows: the
// launch's plan (ops/int8_matmul.py::k1_plan), which the kernel checks.
// Launches on `stream`, allocates nothing, does not synchronize. Returns
// cudaGetLastError() after the launch, or a negative code if the kernel was
// not launched (ERR_ARGS: shapes, alignment or a plan it does not take).
extern "C" int int8_gemm(const void* a, const void* b, void* c, long long M, long long N,
                         long long K, long long ldc, int store, const void* cs, const void* rs,
                         const void* bias, const void* zpw, int act, float out_s, float out_zp,
                         const void* gs, const void* gzpw, long long group, int bn, int stages,
                         int grid, int smem, int split, int slots, int held, int held_rows,
                         void* stream) {
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
  const int m = static_cast<int>(M), n = static_cast<int>(N), k = static_cast<int>(K);
  Plan p;
  p.bn = bn, p.stages = stages, p.grid = grid, p.smem = smem, p.split = split, p.slots = slots,
  p.held = held, p.held_rows = held_rows;
  if (!takes(p, m, n, k, store, static_cast<int>(group))) return ERR_ARGS;
  return launch(p, a, b, c, m, n, k, ldc, store, epi, static_cast<cudaStream_t>(stream));
}

// The clusters of `split` CTAs of one instantiation (bn, store, grouped)
// with `smem` bytes of dynamic shared memory each that the device can run
// at once (cudaOccupancyMaxActiveClusters), or a negative code.
extern "C" int int8_gemm_max_clusters(int bn, int store, int grouped, int split, int smem) {
  const Kernel kernel = kernel_for(bn, store, grouped != 0);
  if (!kernel || split < 1 || split > MAX_SPLIT) return ERR_ARGS;
  const cudaError_t err = opt_in(kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  LaunchConfig lc(split, split, smem, nullptr);
  lc.cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t q =
      cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &lc.cfg);
  return q == cudaSuccess ? clusters : -static_cast<int>(q);
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
