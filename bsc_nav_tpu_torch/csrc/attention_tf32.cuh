// The f32 attention tile on the tensor cores, shared by K1
// short_attention_qkv (FusedQKV policy: q, k and v read in place from the
// fused [B, S, 3D] rows) and K3 short_attention (Contiguous policy): the
// non-causal or square-causal softmax attention of the Pallas
// _qkv_kernel_3in and _short_kernel in f32 -- q scaled by the f32 scale
// (1/sqrt(hd) rounded once from double) before the dot, keys past Sk
// masked (the kv_len mask), ragged Sq and Sk -- with every product of two
// f32 operands a, b taken as three TF32 products,
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi   (small terms first),
//   a_hi = rna(a), a_lo = rna(a - a_hi),
// summed in f32.  rna rounds to TF32's 10-bit mantissa, to nearest with
// ties away from zero, on the bits: (bits + 2^12) with the low 13 bits
// cleared, i.e. cvt.rna.tf32.f32 with its don't-care bits cleared.  Every
// operand reaches the tensor cores with those 13 bits zero, so how they
// would treat raw f32 (truncation) never matters.  The split leaves
// |a - a_hi - a_lo| <= 2^-22 |a| and drops a_lo b_lo (<= 2^-22 |a b|), so
// the result sits at plain f32's error (emulated on the CPU by
// tests/torch_parity.py tf32x3_tile), inside the f32 paths' 2e-5 bound,
// which one TF32 product misses by an order of magnitude.
//
// Bound on the H100: the products.  f32-accurate products run at a third
// of the TF32 rate, 495 / 3 = 165 TFLOP/s.  ViT-L's K1 call (B 8, 16 x 64,
// S 261) is 2.23 GFLOP against 34 MB of f32 qkv and out: 0.0135 ms of
// products, 0.0102 ms of bytes.  MetaCLIP ViT-H's K3 vision call (B 12,
// 16 x 80, S 257) is 4.06 GFLOP against 63 MB: 0.0246 ms against 0.0189.
// The CUDA-core kernels these replace ran scalar f32 FMAs (67 TFLOP/s
// peak) at 15-17 TFLOP/s.
//
// Design (sm_90a): a block owns one (batch*head) and 128 query rows held
// by two warpgroups of 64, and streams 64-key K/V tiles through a
// cp.async ring (3 stages at hd <= 64, 2 at hd 80, 1 above: f32 tiles are
// twice bf16's and the split doubles what is stored split).  Q lands once
// in the prologue; the threads that copied each of its 16-byte chunks
// read it back after cp.async.wait_group, scale it, and write q_hi in
// place and q_lo beside it.  Each K tile is split the same way as it
// lands, so the barrier that publishes a tile publishes it split and no
// barrier is added (the JointQKV pattern of attention_mma.cuh).  Q and K
// are stored as 8-row x 16-byte core matrices without swizzle, K-major,
// the only layout TF32 wgmma takes.  Per tile a warpgroup issues
//   S = Q K^T   wgmma m64n64k8 .tf32, Q and K from shared memory, three
//               passes of hd/8 steps (q_lo k_hi, q_hi k_lo, q_hi k_hi)
//               into f32 accumulators,
// then runs the online softmax on the S registers (row max and sum over a
// quad of lanes by shuffles; p = exp2((s - m) * log2 e) in f32), and
//   O += P V    mma.sync m16n8k8 .tf32 per warp on its 16 rows: P from the
//               S registers, split in registers; V stays raw f32 in
//               shared memory (rows padded to hd + 4 floats, so the
//               fragment reads hit 32 banks) and each lane splits the two
//               elements it reads.  The tensor cores truncate each sum
//               they accumulate, so a tile's P V goes into a zeroed
//               accumulator and O = O * corr + P V is taken in f32 (one
//               rounding per tile, not one per product); S starts from
//               zero each tile anyway.
// TF32 wgmma takes no transpose, and V [keys, hd] is MN-major as P V's B
// operand, so P V runs on mma.sync; storing V split and transposed would
// not fit two stages at hd 80.  The accumulator layout of S gives a lane
// keys 2t, 2t+1 of each 8-key chunk where TF32's A fragment wants columns
// t, t+4: the keys of each k8 step are permuted (column t <-> key 2t,
// column t+4 <-> key 2t+1) in P and V alike, so no value moves between
// lanes.  P stays f32 and is split like any operand.  O and P V share the
// accumulator layout, so O lives in registers throughout.  The grid is
// one-dimensional (q tile fastest), which takes any B*H; under the causal
// mask a block stops at the tile holding its last row, a warpgroup at the
// tile past its rows, and the longest q tiles are scheduled first.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {
namespace tc {

template <int HD>
struct Tf32Cfg {
  // K/V ring: tile t is read while tiles up to t + AHEAD land
  static constexpr int STAGES = HD <= 64 ? 3 : HD <= 80 ? 2 : 1;
  static constexpr int AHEAD = STAGES - 1;
  static constexpr int VLD = HD + 4;       // V row stride in floats
  static constexpr int KT = kKeys * HD;    // floats of K hi (or K lo)
  static constexpr int STAGE = 2 * KT + kKeys * VLD;   // K hi | K lo | V
  static constexpr size_t SMEM =
      sizeof(float) * (2 * kQRows * HD + STAGES * STAGE);
  static_assert(SMEM <= 232448, "over a block's 227 KB");
};

// f32 rounded to TF32 (10-bit mantissa), to nearest, ties away from zero;
// the low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d (m64n64, f32) = A B (+ d when scale_d): A and B TF32 in shared memory,
// both K-major
__device__ __forceinline__ void wgmma_tf32_m64n64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// c (16 x 8, f32) += a (16 x 8) b (8 x 8), TF32 operands.  Lane 4g + t
// holds a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
// b0 = B[t][g], b1 = B[t+4][g]; c0, c1 = C[g][2t, 2t+1], c2, c3 row g+8
__device__ __forceinline__ void mma_tf32(float& c0, float& c1, float& c2,
                                         float& c3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 rows [ROWS, HD] (row r0 first; rows past n zero-filled) into dst as
// 8-row x 16-byte core matrices: element (r, c) at ((r/8) * HD/4 + c/4) *
// 32 + (r%8) * 4 + c%4; consecutive threads fill consecutive 16-byte rows
template <int HD, int ROWS, typename R>
__device__ __forceinline__ void load_core_f32(float* dst, const R& src,
                                              int r0, int n, int tid) {
  constexpr int CH = HD / 4;
  for (int i = tid; i < ROWS * CH; i += kThreads) {
    const int r8 = i & 7, c = (i >> 3) % CH, rg = (i >> 3) / CH;
    const int r = 8 * rg + r8;
    const bool ok = r0 + r < n;
    cp_async<16>(dst + (rg * CH + c) * 32 + 4 * r8,
                 src.row(ok ? r0 + r : 0) + 4 * c, ok);
  }
}

// the chunks of a load_core_f32 tile that this thread copied (it must have
// waited for them): x -> x * scale, hi = rna(x) in place, lo = rna(x - hi)
// at the same offset in lo
template <int HD, int ROWS>
__device__ __forceinline__ void split_core(float* hi, float* lo, float scale,
                                           int tid) {
  constexpr int CH = HD / 4;
  for (int i = tid; i < ROWS * CH; i += kThreads) {
    const int r8 = i & 7, c = (i >> 3) % CH, rg = (i >> 3) / CH;
    const int off = (rg * CH + c) * 32 + 4 * r8;
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    tf32_split(__fmul_rn(x.x, scale), h.x, l.x);
    tf32_split(__fmul_rn(x.y, scale), h.y, l.y);
    tf32_split(__fmul_rn(x.z, scale), h.z, l.z);
    tf32_split(__fmul_rn(x.w, scale), h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// f32 rows [kKeys, HD] (row r0 first; rows past n zero-filled) into dst
// row-major with rows of LD floats
template <int HD, int LD, typename R>
__device__ __forceinline__ void load_rows_f32(float* dst, const R& src,
                                              int r0, int n, int tid) {
  constexpr int CH = HD / 4;
  for (int i = tid; i < kKeys * CH; i += kThreads) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = r0 + r < n;
    cp_async<16>(dst + r * LD + 4 * c, src.row(ok ? r0 + r : 0) + 4 * c, ok);
  }
}

template <typename Tag, int HD, typename Src>
__global__ void __launch_bounds__(kThreads, 1)
    attention_tf32_kernel(const Src src, int Sq, int Sk, int causal,
                          float scale, int n_qtiles) {
  using Cfg = Tf32Cfg<HD>;
  constexpr int STAGES = Cfg::STAGES, AHEAD = Cfg::AHEAD, KT = Cfg::KT;
  constexpr int VLD = Cfg::VLD, STAGE = Cfg::STAGE;
  constexpr int NT = kKeys / 8;   // n8 chunks of S, k8 steps of P V
  constexpr int ON = HD / 8;      // n8 chunks of O
  constexpr int NG = ON <= 10 ? ON : ON / 2;   // ... per pass over P
  constexpr uint32_t SBO = 32 * HD;   // bytes between 8-row core groups
  constexpr float kLog2e = 1.4426950408889634f;
  // declared as the bf16 tile declares it (one translation unit holds both)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* Qh = reinterpret_cast<float*>(smem_raw);   // [kQRows x HD] cores
  float* Ql = Qh + kQRows * HD;
  float* ring = Ql + kQRows * HD;                    // [STAGES][STAGE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // warp-uniform for ptxas (see attention_wgmma_kernel)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), w4 = warp & 3;
  const int64_t bh = blockIdx.x / n_qtiles;
  int qt = static_cast<int>(blockIdx.x - bh * n_qtiles);
  if (causal) qt = n_qtiles - 1 - qt;   // the longest key ranges first
  const int qb = qt * kQRows;
  const int q0 = qb + 64 * wg;          // first query row of the warpgroup
  const int r0 = q0 + 16 * w4 + g;      // this thread's rows: r0, r0 + 8
  const auto rows = src.view(bh);

  load_core_f32<HD, kQRows>(Qh, rows.q, qb, Sq, tid);
  cp_async_commit();
  // causal: no row of this block sees a key past its last row
  const int k_end = causal ? min(Sk, qb + kQRows) : Sk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  // the tiles this warpgroup computes: none past its rows (causal), none
  // when all its rows lie past Sq
  const int n_live = q0 >= Sq ? 0 : causal ? min(n_tiles, q0 / kKeys + 1)
                                           : n_tiles;
  auto load_kv = [&](int tile) {
    float* Ks = ring + (tile % STAGES) * STAGE;
    load_core_f32<HD, kKeys>(Ks, rows.k, tile * kKeys, Sk, tid);
    load_rows_f32<HD, VLD>(Ks + 2 * KT, rows.v, tile * kKeys, Sk, tid);
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();   // empty groups keep the count uniform
  }
  cp_async_wait<AHEAD>();   // Q has landed (for this thread): split it
  split_core<HD, kQRows>(Qh, Ql, scale, tid);

  const float* Qhw = Qh + 64 * HD * wg;
  const float* Qlw = Ql + 64 * HD * wg;
  float o[HD / 2], sc[NT * 4], m[2], l[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if constexpr (AHEAD == 0) {   // one stage: refill it once all are done
      if (t > 0) __syncthreads();
      load_kv(t);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<AHEAD - 1>();   // tile t has landed (for this thread)
    }
    float* Kh = ring + (t % STAGES) * STAGE;
    split_core<HD, kKeys>(Kh, Kh + KT, 1.f, tid);   // ... split by its copiers
    fence_proxy_async();          // ... and visible to wgmma
    __syncthreads();              // ... for all; tile t-1's stage is free
    if constexpr (AHEAD > 0) {
      if (t + AHEAD < n_tiles) load_kv(t + AHEAD);
      cp_async_commit();
    }
    if (t >= n_live) continue;    // this warpgroup is done
    const float* Kl = Kh + KT;
    const float* Vs = Kh + 2 * KT;

    // S = Q K^T: three passes, small terms first; a k8 step spans two
    // core matrices along hd (lbo 128 bytes)
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc)
      wgmma_tf32_m64n64(sc, gmma_desc(Qlw + 64 * kc, 128, SBO),
                        gmma_desc(Kh + 64 * kc, 128, SBO), kc);
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc)
      wgmma_tf32_m64n64(sc, gmma_desc(Qhw + 64 * kc, 128, SBO),
                        gmma_desc(Kl + 64 * kc, 128, SBO), 1);
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc)
      wgmma_tf32_m64n64(sc, gmma_desc(Qhw + 64 * kc, 128, SBO),
                        gmma_desc(Kh + 64 * kc, 128, SBO), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int k0 = t * kKeys;
    // the kv_len mask on the last tile, the causal mask on the diagonal
    if (k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = r0 + 8 * ((i >> 1) & 1);
        if (key >= Sk || (causal && key > row)) sc[i] = -INFINITY;
      }
    }
    // online softmax: the thread holds rows r0 (h 0) and r0 + 8 (h 1);
    // the four lanes of a quad hold a row's 64 keys between them
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no live key yet keeps m = -inf: no update, no NaN
      const float ms = mx == -INFINITY ? 0.f : mx;
      corr[h] = ex2_approx(__fmul_rn(m[h] - ms, kLog2e));
      m[h] = mx;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[4 * n + 2 * h + e];
          s = ex2_approx(__fmul_rn(s - ms, kLog2e));
          rs += s;
        }
      l[h] = l[h] * corr[h] + rs;
    }

    // O = O * corr + P V: the tile's P V is summed on the tensor cores
    // into a zeroed accumulator (they truncate every sum they accumulate,
    // so O itself must not take one truncation per product) and added to
    // O in f32, NG n8 chunks of O at a time.  Key chunk c: A column t is
    // key 8c + 2t, column t+4 key 8c + 2t + 1 (the S layout), and V's rows
    // are read in that order.
#pragma unroll
    for (int n0 = 0; n0 < ON; n0 += NG) {
      float pv[4 * NG];
#pragma unroll
      for (int i = 0; i < 4 * NG; ++i) pv[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        uint32_t ph[4], pl[4];
        tf32_split(sc[4 * c], ph[0], pl[0]);
        tf32_split(sc[4 * c + 2], ph[1], pl[1]);
        tf32_split(sc[4 * c + 1], ph[2], pl[2]);
        tf32_split(sc[4 * c + 3], ph[3], pl[3]);
        const float* v0 = Vs + (8 * c + 2 * t4) * VLD + g + 8 * n0;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          uint32_t vh0, vl0, vh1, vl1;
          tf32_split(v0[8 * n], vh0, vl0);
          tf32_split(v0[VLD + 8 * n], vh1, vl1);
          float* d = pv + 4 * n;
          mma_tf32(d[0], d[1], d[2], d[3], pl, vh0, vh1);
          mma_tf32(d[0], d[1], d[2], d[3], ph, vl0, vl1);
          mma_tf32(d[0], d[1], d[2], d[3], ph, vh0, vh1);
        }
      }
#pragma unroll
      for (int i = 0; i < 4 * NG; ++i)
        o[4 * n0 + i] = fmaf(o[4 * n0 + i], corr[(i >> 1) & 1], pv[i]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + 8 * h;
    if (row >= Sq) continue;
    float* dst = rows.out + row * rows.out_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[4 * n + 2 * h] / sum, o[4 * n + 2 * h + 1] / sum);
  }
}

// the f32 tile's launch, one 128-row q tile per block
struct Tf32Tile {
  template <typename Tag, int HD, typename Src>
  static int launch(const Src& src, int BH, int Sq, int Sk, int causal,
                    cudaStream_t stream) {
    auto kernel = attention_tf32_kernel<Tag, HD, Src>;
    constexpr size_t smem = Tf32Cfg<HD>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_qtiles = (Sq + kQRows - 1) / kQRows;
    const int64_t blocks = static_cast<int64_t>(n_qtiles) * BH;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    // 1/sqrt(hd) rounded once from double, as JAX rounds its Python float
    const float scale =
        static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        src, Sq, Sk, causal, scale, n_qtiles);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int HD>
using ContiguousF32 = ContiguousOf<HD, float>;
template <int HD>
using FusedQKVF32 = FusedQKVOf<HD, float>;

// f32 q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], all
// contiguous and 16-byte aligned; the arguments pass attention_args_ok
// (the caller checks).  Returns the first CUDA error, or 0.
template <typename Tag>
int launch_attention_tf32(const void* q, const void* k, const void* v,
                          void* out, int BH, int Sq, int Sk, int hd,
                          int causal, cudaStream_t s) {
  return launch_by_hd<Tf32Tile, Tag, ContiguousF32>(
      hd, BH, Sq, Sk, causal, s, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk);
}

// f32 qkv [B, S, 3 * heads * hd] -> out [B, S, heads * hd], both
// contiguous and 16-byte aligned, B, S and heads positive; hd a multiple
// of 16 up to 128; never causal (the caller checks).  Returns the first
// CUDA error, or 0.
template <typename Tag>
int launch_fused_qkv_tf32(const void* qkv, void* out, int B, int S,
                          int heads, int hd, cudaStream_t s) {
  return launch_by_hd<Tf32Tile, Tag, FusedQKVF32>(
      hd, B * heads, S, S, 0, s, static_cast<const float*>(qkv),
      static_cast<float*>(out), S, heads);
}

}  // namespace tc
}  // namespace
