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
// bit): acc - zpw (static), * s[c], + bias[c], relu6 or relu or none, and
// one store of f32, bf16 or int8 in the consumer's domain; or the int32
// accumulator alone (store 0), the kernel's oracle and yardstick.
//
// What bounds it on an H100 SXM: the bytes (x read once, y written once) if
// the instructions keep up; a direct kernel that unpacks every tap and runs
// the epilogue through the conversion unit is bound by instruction issue
// instead (its int8 store was slower than its int32 store). The design cuts
// the instructions per output:
// - A block owns one image, a band of output rows, a run of output columns
//   and a chunk of channels (the plan, ops/depthwise_conv.py::depthwise_plan).
//   It stages the band's input rows with their halo in shared memory once,
//   by 16-byte cp.async, and writes the pad value into the halo itself
//   (outside the image; the padding is the layer's zero point on the static
//   path, so no zero-filling copy will do). Three blocks a SM overlap one
//   band's staging with the others' arithmetic. (Persistent blocks that
//   double-buffer their windows measured slower on an H100: the kernel is
//   bound by instruction issue, and the second window cost resident blocks.)
// - A thread owns 4 channels (one 32-bit word of NHWC) and a strip of 4
//   output columns, and walks down the band. Each staged input row is read
//   once a thread, as 4-channel words, and transposed in registers with
//   __byte_perm into words of 4 columns of one channel. One __dp4a then sums
//   a row's three taps of one output: at stride 1 the row words [x0..x3]
//   and [x2..x5] against the weights [w0 w1 w2 0] and [0 w0 w1 w2] give the
//   4 outputs of a strip, 4 __dp4a a row and channel; at stride 2 the words
//   [x0..x3], [x2..x5], [x4..x7], [x6..x8] against [w0 w1 w2 0]. The rows
//   slide: at stride 1 each new output row loads one input row, at stride 2
//   two. The weights, in that form, and the per-channel vectors stay in
//   registers for the whole band.
// - The epilogue keeps off the conversion unit, far narrower than the FP32
//   pipes: the accumulator starts at 0x4B400000 - zpw, so its bits are the
//   float 1.5 * 2^23 + (acc - zpw) and one subtraction gives float(acc -
//   zpw) exactly; the int8 store clamps y / out_s to its range less the zero
//   point (a clamp at whole numbers commutes with rint), rounds it half to
//   even by adding 1.5 * 2^23, and adds the zero point to the bits.
//   K1's five-operation division (epilogue.cuh::fast_div) needs no check per
//   output: each thread checks once that its channels keep |y| <= 2^30 and
//   the launch that out_s lies in [2^-30, 2^30]; then every quotient is in
//   fast_div's exact range, or so small that both divisions round it to 0.
//   A warp with a channel outside those bounds (or a zero point too large
//   for the float trick) takes the exact path, __int2float_rn and __fdiv_rn,
//   by the warp's vote. Both paths store the same bits as the plain version.
// - A row's 16 outputs are computed before any is stored, so that their
//   epilogues interleave; stores are one vector a thread and output pixel:
//   16 bytes of int32 or f32, 8 of bf16, 4 of int8; neighbouring threads on
//   neighbouring channels.
// A channel count that is not a multiple of 16 (or a pointer off 16 bytes)
// takes the masked variant: byte-wise staging and per-channel stores, the
// same arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256;  // at most, a block (the plan's bound)
constexpr int STRIP = 4;      // output columns a thread owns
constexpr int QUAD = 4;       // channels a thread owns: one 32-bit word of NHWC int8
constexpr int KH = 3, KW = 3;
constexpr float MAGIC = 12582912.0f;          // 1.5 * 2^23
constexpr unsigned MAGIC_BITS = 0x4B400000u;  // its bits
// The largest |acc| of nine int8 products, and the largest |zpw| that keeps
// acc - zpw inside the float trick's (-2^22, 2^22).
constexpr int ACC_MAX = KH * KW * 128 * 128;
constexpr int ZPW_MAX = (1 << 22) - ACC_MAX - 1;

enum Store { STORE_INT32 = 0, STORE_F32 = 1, STORE_BF16 = 2, STORE_INT8 = 3 };

// The launch's geometry: the plan's numbers and what follows from them.
struct Geometry {
  int n, h, w, c;     // input
  int ho, wo;         // output
  int pt, pl;         // top and left pads
  int band, chunk;    // output rows and channels a tile owns
  int groups;         // strips of STRIP output columns a tile owns
  int bands, col_blocks, chunks;
  int rows_in, cols_in, pitch;  // the staged window: rows, columns, bytes a pixel
  int8_t pad;
};

// The int8 store without a conversion or a per-output check (see the note
// at the top): usable where `ok`.
struct FastQuant {
  int ok;        // out_s in [2^-30, 2^30], its zero point whole and |zp| <= 2^20
  float lo, hi;  // clamp of y / out_s: -128 - zp (at least 0 under relu), qhi - zp
  int k;         // zp - MAGIC_BITS: (bits of rint(d) + MAGIC) + k = rint(d) + zp
};

struct Epilogue {
  const float* cs;     // [C] scale per channel
  const float* bias;   // [C] or null
  const int32_t* zpw;  // [C] or null
  qt::Activation act;  // none, relu or relu6
  qt::OutQuant oq;     // the int8 store's domain
  FastQuant fq;
};

FastQuant make_fast_quant(const qt::OutQuant& o, const qt::Activation& act) {
  FastQuant f{0, 0.0f, 0.0f, 0};
  if (!(o.s >= 0x1p-30f && o.s <= 0x1p30f && o.zp == __builtin_rintf(o.zp) &&
        __builtin_fabsf(o.zp) <= 0x1p20f && o.qhi == __builtin_rintf(o.qhi)))
    return f;
  const float a = -128.0f - o.zp;
  f.ok = 1;
  f.lo = act.relu && a < 0.0f ? 0.0f : a;
  f.hi = o.qhi - o.zp;
  f.k = static_cast<int>(o.zp) - static_cast<int>(MAGIC_BITS);
  return f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A block's place: image, first output row, first strip, first channel.
// Adjacent blocks take adjacent bands, so a halo row is read again from L2.
struct Tile {
  int nn, ho0, strip0, c0;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, unsigned t) {
  const int band_i = static_cast<int>(t % g.bands);
  t /= g.bands;
  const int cb_i = static_cast<int>(t % g.col_blocks);
  t /= g.col_blocks;
  const int chunk_i = static_cast<int>(t % g.chunks);
  return Tile{static_cast<int>(t / g.chunks), band_i * g.band, cb_i * g.groups, chunk_i * g.chunk};
}

// Stage a block's window: rows_in x cols_in pixels of `pitch` bytes, the
// chunk's channels of x from input row hi0 and column wi0 on, the pad value
// outside the image and 0 past C. Each thread keeps its (column, 16-byte
// unit) pairs and walks the rows, so no division runs a row.
template <bool VEC, int STRIDE>
__device__ __forceinline__ void stage(const int8_t* __restrict__ x, int8_t* sx, const Geometry& g,
                                      const Tile& t) {
  const int nn = t.nn, c0 = t.c0;
  const int hi0 = t.ho0 * STRIDE - g.pt, wi0 = t.strip0 * STRIP * STRIDE - g.pl;
  const int units = g.pitch / 16;
  const unsigned padw = (static_cast<unsigned>(g.pad) & 0xFFu) * 0x01010101u;
  const uint4 fill = make_uint4(padw, padw, padw, padw);
  const long long row_stride = static_cast<long long>(g.w) * g.c;
  const int row_bytes = g.cols_in * g.pitch;
  for (int e = threadIdx.x; e < g.cols_in * units; e += blockDim.x) {
    const int col = e / units, unit = e - col * units;
    const int wi = wi0 + col, cb = c0 + unit * 16;
    const bool col_in = wi >= 0 && wi < g.w;
    const int8_t* src = x + (static_cast<long long>(nn) * g.h * g.w + (col_in ? wi : 0)) * g.c;
    int8_t* dst = sx + col * g.pitch + unit * 16;
    for (int r = 0; r < g.rows_in; ++r, dst += row_bytes) {
      const int hi = hi0 + r;
      const bool in = col_in && hi >= 0 && hi < g.h;
      const int8_t* p = src + (in ? hi : 0) * row_stride + cb;
      if (VEC) {
        if (in && cb < g.c) {
          cp_async16(dst, p);
        } else {
          *reinterpret_cast<uint4*>(dst) = in ? make_uint4(0u, 0u, 0u, 0u) : fill;
        }
      } else {
        unsigned v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          unsigned word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int ci = cb + 4 * k + b;
            const int8_t byte = in ? (ci < g.c ? p[4 * k + b] : int8_t(0)) : g.pad;
            word |= (static_cast<unsigned>(byte) & 0xFFu) << (8 * b);
          }
          v[k] = word;
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// A staged row as the thread's four channels need it: word i holds channel
// i at 4 consecutive columns. Stride 1: x0 = columns 0-3 and y = 2-5 of the
// strip's 6. Stride 2: x0 = 0-3, y = 2-5, x1 = 4-7 and z = 6-8 of its 9.
struct Row1 {
  unsigned x0[QUAD], y[QUAD];
};
struct Row2 {
  unsigned x0[QUAD], y[QUAD], x1[QUAD], z[QUAD];
};

// Two 4-channel words a, b (pixels p, p+1) -> [a.c0 b.c0 a.c1 b.c1] and
// [a.c2 b.c2 a.c3 b.c3].
__device__ __forceinline__ void pair(unsigned a, unsigned b, unsigned& lo, unsigned& hi) {
  lo = __byte_perm(a, b, 0x5140);
  hi = __byte_perm(a, b, 0x7362);
}

// Four pixels' pairs (p, p+1) and (p+2, p+3) -> channel i at p..p+3.
__device__ __forceinline__ void columns(unsigned lo01, unsigned hi01, unsigned lo23, unsigned hi23,
                                        unsigned (&out)[QUAD]) {
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ unsigned lds(const int8_t* p) { return *reinterpret_cast<const unsigned*>(p); }

__device__ __forceinline__ void load_row(const int8_t* p, int pitch, Row1& r) {
  unsigned l0, h0, l2, h2, l4, h4;
  pair(lds(p), lds(p + pitch), l0, h0);
  pair(lds(p + 2 * pitch), lds(p + 3 * pitch), l2, h2);
  pair(lds(p + 4 * pitch), lds(p + 5 * pitch), l4, h4);
  columns(l0, h0, l2, h2, r.x0);
  columns(l2, h2, l4, h4, r.y);
}

__device__ __forceinline__ void load_row(const int8_t* p, int pitch, Row2& r) {
  unsigned l0, h0, l2, h2, l4, h4, l6, h6;
  pair(lds(p), lds(p + pitch), l0, h0);
  pair(lds(p + 2 * pitch), lds(p + 3 * pitch), l2, h2);
  pair(lds(p + 4 * pitch), lds(p + 5 * pitch), l4, h4);
  pair(lds(p + 6 * pitch), lds(p + 7 * pitch), l6, h6);
  const unsigned p8 = lds(p + 8 * pitch);
  columns(l0, h0, l2, h2, r.x0);
  columns(l2, h2, l4, h4, r.y);
  columns(l4, h4, l6, h6, r.x1);
  // [p6 p7 p8 .]: the last byte meets the weight's 0.
  r.z[0] = __byte_perm(l6, p8, 0x4410);
  r.z[1] = __byte_perm(l6, p8, 0x5532);
  r.z[2] = __byte_perm(h6, p8, 0x6610);
  r.z[3] = __byte_perm(h6, p8, 0x7732);
}

// One input row's three taps into the strip's accumulators acc[channel][column].
__device__ __forceinline__ void taps(const Row1& r, const int (&w0)[QUAD], const int (&w1)[QUAD],
                                     int (&acc)[QUAD][STRIP]) {
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    acc[i][0] = __dp4a(static_cast<int>(r.x0[i]), w0[i], acc[i][0]);
    acc[i][1] = __dp4a(static_cast<int>(r.x0[i]), w1[i], acc[i][1]);
    acc[i][2] = __dp4a(static_cast<int>(r.y[i]), w0[i], acc[i][2]);
    acc[i][3] = __dp4a(static_cast<int>(r.y[i]), w1[i], acc[i][3]);
  }
}

__device__ __forceinline__ void taps(const Row2& r, const int (&w0)[QUAD], const int (&)[QUAD],
                                     int (&acc)[QUAD][STRIP]) {
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    acc[i][0] = __dp4a(static_cast<int>(r.x0[i]), w0[i], acc[i][0]);
    acc[i][1] = __dp4a(static_cast<int>(r.y[i]), w0[i], acc[i][1]);
    acc[i][2] = __dp4a(static_cast<int>(r.x1[i]), w0[i], acc[i][2]);
    acc[i][3] = __dp4a(static_cast<int>(r.z[i]), w0[i], acc[i][3]);
  }
}

// The accumulator (started at MAGIC_BITS - zpw) -> y before the store.
// FAST: the float trick; else the exact conversion of the wrapped int32
// acc - zpw, as the plain version computes it.
template <bool FAST>
__device__ __forceinline__ float scaled(int acc, float cs, bool has_bias, float bias) {
  const float v = FAST ? __fadd_rn(__int_as_float(acc), -MAGIC)
                       : __int2float_rn(static_cast<int>(static_cast<unsigned>(acc) - MAGIC_BITS));
  const float y = __fmul_rn(v, cs);
  return has_bias ? __fadd_rn(y, bias) : y;
}

// The int8 store of one accumulator, as an int in [-128, 127].
template <bool FAST>
__device__ __forceinline__ int quantized(int acc, float cs, bool has_bias, float bias, const Epilogue& e) {
  if (FAST) {
    // relu lies in fq.lo, relu6 in fq.hi (see make_fast_quant).
    const float y = scaled<true>(acc, cs, has_bias, bias);
    const float q0 = __fmul_rn(y, e.oq.r);
    const float q1 = __fmaf_rn(__fmaf_rn(-e.oq.s, q0, y), e.oq.r, q0);
    const float q2 = __fmaf_rn(__fmaf_rn(-e.oq.s, q1, y), e.oq.r, q1);
    const float d = fminf(fmaxf(q2, e.fq.lo), e.fq.hi);
    return __float_as_int(__fadd_rn(d, MAGIC)) + e.fq.k;
  }
  const float y = qt::activate<false>(scaled<false>(acc, cs, has_bias, bias), e.act);
  bool unused = false;
  return qt::requantize<false>(y, e.oq, unused);
}

// The low bytes of four ints, in order.
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Store one output row of the strip: acc[channel][column] at pixels
// pix..pix+3 (those below `cols`), channels ch..ch+3 (those below C). The
// 16 epilogues run before the first store, so none waits on a branch.
template <int STORE, bool VEC, bool FAST>
__device__ __forceinline__ void store_row(void* __restrict__ y, const int (&acc)[QUAD][STRIP],
                                          long long pix, int cols, int ch, int c,
                                          const float (&cs)[QUAD], const float (&bias)[QUAD],
                                          bool has_bias, const Epilogue& e) {
  if constexpr (STORE == STORE_INT32) {
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      if (j >= cols) break;
      int32_t* out = static_cast<int32_t*>(y) + (pix + j) * c + ch;
      if (VEC) {
        *reinterpret_cast<int4*>(out) = make_int4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      } else {
#pragma unroll
        for (int i = 0; i < QUAD; ++i)
          if (ch + i < c) out[i] = acc[i][j];
      }
    }
  } else if constexpr (STORE == STORE_INT8) {
    int q[QUAD][STRIP];
#pragma unroll
    for (int j = 0; j < STRIP; ++j)
#pragma unroll
      for (int i = 0; i < QUAD; ++i) q[i][j] = quantized<FAST>(acc[i][j], cs[i], has_bias, bias[i], e);
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      if (j >= cols) break;
      int8_t* out = static_cast<int8_t*>(y) + (pix + j) * c + ch;
      if (VEC) {
        *reinterpret_cast<unsigned*>(out) = pack4(q[0][j], q[1][j], q[2][j], q[3][j]);
      } else {
#pragma unroll
        for (int i = 0; i < QUAD; ++i)
          if (ch + i < c) out[i] = static_cast<int8_t>(q[i][j]);
      }
    }
  } else {
    float v[QUAD][STRIP];
#pragma unroll
    for (int j = 0; j < STRIP; ++j)
#pragma unroll
      for (int i = 0; i < QUAD; ++i)
        v[i][j] = qt::activate<true>(scaled<FAST>(acc[i][j], cs[i], has_bias, bias[i]), e.act);
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      if (j >= cols) break;
      const long long o = (pix + j) * c + ch;
      if constexpr (STORE == STORE_F32) {
        float* out = static_cast<float*>(y) + o;
        if (VEC) {
          *reinterpret_cast<float4*>(out) = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
        } else {
#pragma unroll
          for (int i = 0; i < QUAD; ++i)
            if (ch + i < c) out[i] = v[i][j];
        }
      } else {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y) + o;
        if (VEC) {
          const __nv_bfloat162 a = __floats2bfloat162_rn(v[0][j], v[1][j]);
          const __nv_bfloat162 b = __floats2bfloat162_rn(v[2][j], v[3][j]);
          *reinterpret_cast<uint2*>(out) = make_uint2(*reinterpret_cast<const unsigned*>(&a),
                                                      *reinterpret_cast<const unsigned*>(&b));
        } else {
#pragma unroll
          for (int i = 0; i < QUAD; ++i)
            if (ch + i < c) out[i] = __float2bfloat16_rn(v[i][j]);
        }
      }
    }
  }
}

// The band: rows_out output rows of the strip, each from its three staged
// rows (sliding: stride 1 loads one new row an output row, stride 2 two).
template <int STORE, bool VEC, int STRIDE, bool FAST>
__device__ __forceinline__ void run_band(const int8_t* sbase, int row_bytes, int pitch, int rows_out,
                                         void* __restrict__ y, long long pix0, long long row_pix, int cols,
                                         int ch, int c, const int (&w0)[KH][QUAD], const int (&w1)[KH][QUAD],
                                         const int (&init)[QUAD], const float (&cs)[QUAD],
                                         const float (&bias)[QUAD], bool has_bias, bool live,
                                         const Epilogue& e) {
  using Row = typename std::conditional<STRIDE == 1, Row1, Row2>::type;
  Row r0, r1, r2;
  load_row(sbase, pitch, r0);
  if (STRIDE == 1) load_row(sbase + row_bytes, pitch, r1);
  for (int rr = 0; rr < rows_out; ++rr) {
    int acc[QUAD][STRIP];
#pragma unroll
    for (int i = 0; i < QUAD; ++i)
#pragma unroll
      for (int j = 0; j < STRIP; ++j) acc[i][j] = init[i];
    const int8_t* p = sbase + STRIDE * rr * row_bytes;
    taps(r0, w0[0], w1[0], acc);
    if (STRIDE == 2) load_row(p + row_bytes, pitch, r1);
    taps(r1, w0[1], w1[1], acc);
    load_row(p + 2 * row_bytes, pitch, r2);
    taps(r2, w0[2], w1[2], acc);
    if (live) store_row<STORE, VEC, FAST>(y, acc, pix0 + rr * row_pix, cols, ch, c, cs, bias, has_bias, e);
    if (STRIDE == 1) {
      r0 = r1;
      r1 = r2;
    } else {
      r0 = r2;
    }
  }
}

// Three blocks a SM (at most 80 registers a thread): more warps to hide the
// shared-memory and FMA latencies (two blocks a SM measured slower on an
// H100, PERF.md §6).
template <int STORE, bool VEC, int STRIDE>
__global__ void __launch_bounds__(THREADS, 3)
    depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, void* __restrict__ y,
                     Geometry g, Epilogue e) {
  extern __shared__ __align__(16) int8_t smem[];
  const Tile tl = tile_of(g, blockIdx.x);
  stage<VEC, STRIDE>(x, smem, g, tl);
  const bool has_bias = e.bias != nullptr;
  const int row_bytes = g.cols_in * g.pitch;
  const int ng = (g.wo + STRIP - 1) / STRIP;

  // The thread's item: a quad of channels and a strip of columns.
  const int cc = min(g.chunk, g.c - tl.c0);
  const int quads = (cc + QUAD - 1) / QUAD;
  const int strips = min(g.groups, ng - tl.strip0);
  const int t = threadIdx.x;
  const bool live = t < quads * strips;
  const int q = live ? t % quads : 0;
  const int s = live ? t / quads : 0;
  const int ch = tl.c0 + QUAD * q;

  // Its weights as the rows' dot products take them: w0[kh][i] = [w(kh,0)
  // w(kh,1) w(kh,2) 0] of channel ch + i, w1 = the same a byte up.
  int w0[KH][QUAD], w1[KH][QUAD];
#pragma unroll
  for (int kh = 0; kh < KH; ++kh) {
    unsigned tap[KW];
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      const int8_t* p = w + (kh * KW + kw) * g.c + ch;
      if (VEC) {
        tap[kw] = __ldg(reinterpret_cast<const unsigned*>(p));
      } else {
        unsigned word = 0;
#pragma unroll
        for (int i = 0; i < QUAD; ++i)
          word |= (ch + i < g.c ? static_cast<unsigned>(p[i]) & 0xFFu : 0u) << (8 * i);
        tap[kw] = word;
      }
    }
    unsigned lo, hi;
    pair(tap[0], tap[1], lo, hi);
    w0[kh][0] = static_cast<int>(__byte_perm(lo, tap[2], 0x0410) & 0x00FFFFFFu);
    w0[kh][1] = static_cast<int>(__byte_perm(lo, tap[2], 0x0532) & 0x00FFFFFFu);
    w0[kh][2] = static_cast<int>(__byte_perm(hi, tap[2], 0x0610) & 0x00FFFFFFu);
    w0[kh][3] = static_cast<int>(__byte_perm(hi, tap[2], 0x0732) & 0x00FFFFFFu);
#pragma unroll
    for (int i = 0; i < QUAD; ++i) w1[kh][i] = static_cast<int>(static_cast<unsigned>(w0[kh][i]) << 8);
  }

  // The per-channel vectors and the accumulators' start, and whether the
  // fast epilogue is exact for these channels (see the note at the top).
  int init[QUAD];
  float cs[QUAD], bias[QUAD];
  bool fast = STORE != STORE_INT8 || e.fq.ok;
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    const bool in = ch + i < g.c;
    const int z = in && e.zpw ? __ldg(e.zpw + ch + i) : 0;
    cs[i] = in && STORE != STORE_INT32 ? __ldg(e.cs + ch + i) : 0.0f;
    bias[i] = in && has_bias ? __ldg(e.bias + ch + i) : 0.0f;
    init[i] = STORE == STORE_INT32 ? 0 : static_cast<int>(MAGIC_BITS - static_cast<unsigned>(z));
    fast = fast && z >= -ZPW_MAX && z <= ZPW_MAX;
    if (STORE == STORE_INT8)
      fast = fast && __fmaf_rn(fabsf(cs[i]), static_cast<float>(ACC_MAX + abs(z)), fabsf(bias[i])) <= 0x1p29f;
  }
  // Every lane votes, live or not: the warp takes one path.
  fast = __all_sync(0xFFFFFFFFu, fast || !live);

  cp_async_wait_all();
  __syncthreads();  // the window, staged by every thread, has landed

  const int ho_rows = min(g.band, g.ho - tl.ho0);
  const int wo0 = (tl.strip0 + s) * STRIP;
  const int cols = min(STRIP, g.wo - wo0);
  const long long pix0 = (static_cast<long long>(tl.nn) * g.ho + tl.ho0) * g.wo + wo0;
  const int8_t* sbase = smem + s * STRIP * STRIDE * g.pitch + QUAD * q;
  if (STORE == STORE_INT32 || fast) {
    run_band<STORE, VEC, STRIDE, true>(sbase, row_bytes, g.pitch, ho_rows, y, pix0, g.wo, cols, ch, g.c,
                                       w0, w1, init, cs, bias, has_bias, live, e);
  } else {
    run_band<STORE, VEC, STRIDE, false>(sbase, row_bytes, g.pitch, ho_rows, y, pix0, g.wo, cols, ch, g.c,
                                        w0, w1, init, cs, bias, has_bias, live, e);
  }
}

constexpr int ERR_ARGS = -2;

template <int STORE, bool VEC, int STRIDE>
int launch(const int8_t* x, const int8_t* w, void* y, const Geometry& g, const Epilogue& e, int threads,
           int smem, unsigned grid, cudaStream_t stream) {
  auto kernel = depthwise_kernel<STORE, VEC, STRIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(x, w, y, g, e);
  return static_cast<int>(cudaGetLastError());
}

template <int STORE>
int launch(const int8_t* x, const int8_t* w, void* y, const Geometry& g, const Epilogue& e, bool vec,
           int stride, int threads, int smem, unsigned grid, cudaStream_t st) {
  if (vec) {
    return stride == 1 ? launch<STORE, true, 1>(x, w, y, g, e, threads, smem, grid, st)
                       : launch<STORE, true, 2>(x, w, y, g, e, threads, smem, grid, st);
  }
  return stride == 1 ? launch<STORE, false, 1>(x, w, y, g, e, threads, smem, grid, st)
                     : launch<STORE, false, 2>(x, w, y, g, e, threads, smem, grid, st);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// x: int8[N, H, W, C]; w: int8[3, 3, 1, C] (HWIO); y: [N, Ho, Wo, C] of the
// store's type (0 int32, 1 f32, 2 bf16, 3 int8 in (out_s, out_zp)); all
// contiguous. Output pixel (ho, wo) takes taps ho * stride - pad_top + kh,
// wo * stride - pad_left + kw; taps outside the image read `pad`. stride 1
// or 2. cs: f32[C] (stores 1-3); bias: f32[C] or null; zpw: int32[C] or
// null; act: 0 none, 1 relu, 2 relu6. The plan (ops/depthwise_conv.py::
// depthwise_plan): `band` output rows, `groups` strips of `strip` columns
// and `chunk` channels a block, `threads` a block, `smem_bytes` of staged
// window, `grid` blocks; `vec` the 16-byte variant (C % 16 == 0, pointers
// 16-byte aligned). The plan is checked against the shape, not trusted.
// Launches on `stream`, allocates nothing, does not synchronize. Returns
// cudaGetLastError() after the launch, or a negative code if the kernel was
// not launched.
extern "C" int depthwise_conv(const void* x, const void* w, void* y, long long N, long long H, long long W,
                              long long C, long long Ho, long long Wo, long long stride, long long pad_top,
                              long long pad_left, long long pad, int store, const void* cs,
                              const void* bias, const void* zpw, int act, float out_s, float out_zp,
                              long long band, long long strip, long long chunk, long long groups,
                              long long threads, long long smem_bytes, long long grid, int vec,
                              void* stream) {
  const long long big = 1LL << 31;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || N >= big || H >= big || W >= big ||
      C >= big / 32 || Ho >= big || Wo >= big || (stride != 1 && stride != 2) || store < STORE_INT32 ||
      store > STORE_INT8 || (store != STORE_INT32 && !cs) || pad < -128 || pad > 127 || act < 0 ||
      act > qt::ACT_RELU6)
    return ERR_ARGS;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y);
  if (vec && (C % 16 != 0 || (addr & 15) != 0)) return ERR_ARGS;
  // The plan against the shape.
  const long long unit = vec ? 16 : QUAD;
  if (strip != STRIP || band < 1 || chunk < unit || chunk % unit != 0 || groups < 1 || threads < 32 ||
      threads > THREADS || threads % 32 != 0)
    return ERR_ARGS;
  const long long ng = ceil_div(Wo, STRIP);
  const long long bands = ceil_div(Ho, band), col_blocks = ceil_div(ng, groups), chunks = ceil_div(C, chunk);
  const long long rows_in = (band - 1) * stride + 3, cols_in = (STRIP * groups - 1) * stride + 3;
  const long long pitch = ceil_div(chunk, 16) * 16;
  if (band > Ho || groups > ng || threads < chunk / QUAD * groups ||
      rows_in * cols_in * pitch != smem_bytes || smem_bytes > 227 * 1024 ||
      N * chunks * bands * col_blocks != grid || grid >= big)
    return ERR_ARGS;
  const Geometry g{static_cast<int>(N), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C),
                   static_cast<int>(Ho), static_cast<int>(Wo), static_cast<int>(pad_top),
                   static_cast<int>(pad_left), static_cast<int>(band), static_cast<int>(chunk),
                   static_cast<int>(groups), static_cast<int>(bands), static_cast<int>(col_blocks),
                   static_cast<int>(chunks), static_cast<int>(rows_in), static_cast<int>(cols_in),
                   static_cast<int>(pitch), static_cast<int8_t>(pad)};
  const qt::Activation a = qt::make_activation(act);
  const qt::OutQuant oq = qt::make_out_quant(out_s, out_zp, a.hi);
  const Epilogue e{static_cast<const float*>(cs), static_cast<const float*>(bias),
                   static_cast<const int32_t*>(zpw), a, oq, make_fast_quant(oq, a)};
  const auto X = static_cast<const int8_t*>(x);
  const auto Wt = static_cast<const int8_t*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  const int s = static_cast<int>(stride), th = static_cast<int>(threads), sm = static_cast<int>(smem_bytes);
  const unsigned gr = static_cast<unsigned>(grid);
  switch (store) {
    case STORE_INT32: return launch<STORE_INT32>(X, Wt, y, g, e, vec, s, th, sm, gr, st);
    case STORE_F32: return launch<STORE_F32>(X, Wt, y, g, e, vec, s, th, sm, gr, st);
    case STORE_BF16: return launch<STORE_BF16>(X, Wt, y, g, e, vec, s, th, sm, gr, st);
    default: return launch<STORE_INT8>(X, Wt, y, g, e, vec, s, th, sm, gr, st);
  }
}
