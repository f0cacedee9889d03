// The f32 attention tile on the tensor cores, shared by K1
// short_attention_qkv and K4 joint_qkv_attention (FusedQKV policy: q, k
// and v read in place from fused [B, S, 3D] rows, K4's written by its
// qk-norm pre-pass), K3 short_attention, K5 mid_attention and K6
// flash_attention (Contiguous policy): the non-causal or square-causal
// softmax attention of the Pallas _qkv_kernel_3in, _joint_qkv_kernel,
// _short_kernel, _mid_kernel and _flash_kernel in f32 -- q scaled by the
// f32 scale (1/sqrt(hd) rounded once from double) before the dot, keys
// past Sk masked (the kv_len mask), ragged Sq and Sk -- with every product
// of two f32 operands a, b taken as three TF32 products, a_lo b_hi +
// a_hi b_lo + a_hi b_hi (tf32.cuh, shared with K8), so the result sits at
// plain f32's error (emulated on the CPU by tests/torch_parity.py
// tf32x3_tile), inside the f32 paths' 2e-5 bound, which one TF32 product
// misses by an order of magnitude.
//
// Bound on the H100: the products.  f32-accurate products run at a third
// of the TF32 rate, 495 / 3 = 165 TFLOP/s.  ViT-L's K1 call (B 8, 16 x 64,
// S 261) is 2.23 GFLOP against 34 MB of f32 qkv and out: 0.0135 ms of
// products, 0.0102 ms of bytes.  MetaCLIP ViT-H's K3 vision call (B 12,
// 16 x 80, S 257) is 4.06 GFLOP against 63 MB: 0.0246 ms against 0.0189.
// K5 at SD3-medium's joint attention (B 6, 24 x 64, S 1613) is 95.9 GFLOP
// against 60 MB: 0.581 ms against 0.018; K6 at SD3.5-medium's 1024^2 (S
// 4685) 809 GFLOP, 4.90 ms.  The CUDA-core kernels these replace ran
// scalar f32 FMAs (67 TFLOP/s peak) at 15-17 TFLOP/s.
//
// Design (sm_90a): a block owns one (batch*head) and 128 query rows held
// by two warpgroups of 64 and streams 64-key K/V tiles through a 2-stage
// ring in shared memory.  Q and K are stored as 8-row x 16-byte core
// matrices without swizzle, K-major, the only layout TF32 wgmma takes.
// Per tile a compute warpgroup issues
//   S = Q K^T   wgmma m64n64k8 .tf32, Q and K from shared memory, three
//               passes of hd/8 steps (q_lo k_hi, q_hi k_lo, q_hi k_hi)
//               into f32 accumulators,
// runs the online softmax on the S registers (row max and sum over a quad
// of lanes by shuffles; p = exp2((s - m) * log2 e) in f32), splits P in
// registers and takes O += P V.  The tensor cores truncate each sum they
// accumulate, so a tile's P V goes into a zeroed accumulator and O = O *
// corr + P V is taken in f32 (one rounding per tile, not one per
// product); S starts from zero each tile anyway.  The accumulator layout
// of S gives a lane keys 2t, 2t+1 of each 8-key chunk where TF32's A
// fragment (mma.sync m16n8k8's, and wgmma's per warp) wants columns t,
// t+4: the keys of each k8 step are permuted (column t <-> key 2t, column
// t+4 <-> key 2t+1) in P and V alike, so no value moves between lanes.  O
// and P V share the accumulator layout, so O lives in registers
// throughout.  Two shapes of block:
// - hd <= 64 (K1, K3's text towers, K5, K6), 384 threads, warp-
//   specialized.  Warpgroup 0, the producer, copies Q once (cp.async,
//   then scaled and split in place) and fetches each K/V tile -- even
//   tiles into its registers, odd ones by cp.async into a landing buffer,
//   so that two tiles are in flight -- and splits it into a ring stage, K
//   hi | K lo | V^T hi | V^T lo.  V is stored transposed (TF32 wgmma takes
//   no transpose, and P V's B operand must be K-major), with each 8-key
//   chunk permuted as P's fragment wants: each thread reads one dim of 4
//   keys (4-byte reads that coalesce across a warp), so V is split once
//   per block and nothing moves between lanes.  The producer publishes a
//   stage on its "full" mbarrier after fence.proxy.async and refills it
//   once both compute warpgroups have released it on its "empty" one.
//   Warpgroups 1 and 2 take each stage: S as above, then
//     O += P V  wgmma m64n{hd}k8 .tf32, P from registers, V^T from shared
//               memory, three passes of 8 k8 steps (p_lo v_hi, p_hi v_lo,
//               p_hi v_hi).
//   They are bound to each other only through the ring, so one's softmax
//   may run under the other's wgmma.  Shared memory at hd 64: Q hi | lo
//   64 KB, 2 stages of 64 KB, the landing buffer 32 KB: 224 KB.  A block
//   of 384 threads gets at most 168 registers a thread, which the compute
//   warpgroups' O, P hi | lo and P V (128) and the producer's register
//   tile (64) need nearly all of: values that the compiler would hoist
//   and hold (wgmma descriptors, chunk offsets, the block's geometry) are
//   computed where they are used (opaque), so no instance spills.
// - hd > 64 (K3's MetaCLIP vision tower, hd 80), 256 threads: both
//   warpgroups copy each K/V tile by cp.async (2 stages at hd 80, 1
//   above), split Q and K in place -- the threads that copied each chunk
//   split it, so the barrier that publishes a tile publishes it split and
//   no barrier is added -- and
//   compute: S as above, and P V on mma.sync m16n8k8 .tf32 per warp on its
//   16 rows, V raw f32 in shared memory (rows padded to hd + 4 floats, so
//   the fragment reads hit 32 banks) split by each lane as it reads; V^T
//   hi | lo would not fit two stages at hd 80.
// The grid is one-dimensional (q tile fastest), which takes any B*H; under
// the causal mask a block stops at the tile holding its last row, a
// warpgroup at the tile past its rows, and the longest q tiles are
// scheduled first.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "tf32.cuh"

namespace {
namespace tc {

template <int HD>
struct Tf32Cfg {
  // hd <= 64: warp-specialized -- warpgroup 0 loads and splits every tile
  // (V once per block into V^T hi | lo), warpgroups 1 and 2 compute, P V
  // on wgmma; above: two warpgroups that load, split and compute, P V on
  // mma.sync (V^T hi | lo would not fit 2 stages at hd 80)
  static constexpr bool PV_WGMMA = HD <= 64;
  static constexpr int PRODUCERS = PV_WGMMA ? 128 : 0;
  static constexpr int THREADS = PRODUCERS + kThreads;
  // ring of K hi | lo | V^T hi | lo (hd <= 64) or K hi | lo | V: tile t
  // is read while tiles up to t + AHEAD land
  static constexpr int STAGES = HD <= 80 ? 2 : 1;
  static constexpr int AHEAD = STAGES - 1;
  static constexpr int VLD = HD + 4;       // raw V row stride in floats
  static constexpr int KT = kKeys * HD;    // floats of K hi (or K lo)
  static constexpr int STAGE = 2 * KT + (PV_WGMMA ? 2 * KT : kKeys * VLD);
  // hd <= 64: behind the ring, a landing buffer of raw K | V and the
  // ring's full and empty mbarriers and Q's
  static constexpr size_t SMEM =
      sizeof(float) * (2 * kQRows * HD + STAGES * STAGE) +
      (PV_WGMMA ? sizeof(float) * 2 * KT + 8 * (2 * STAGES + 1) : 0);
  static_assert(SMEM <= 232448, "over a block's 227 KB");
};

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

// d (m64nN, f32) = A B (+ d when scale_d): A TF32 in registers (per warp
// the mma.sync m16n8k8 A fragment of its 16 rows), B TF32 in shared
// memory, K-major
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<16>(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<48>(float (&d)[24],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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
// 32 + (r%8) * 4 + c%4; consecutive threads of NTHR fill consecutive
// 16-byte rows
template <int HD, int ROWS, int NTHR, typename R>
__device__ __forceinline__ void load_core_f32(float* dst, const R& src,
                                              int r0, int n, int tid) {
  constexpr int CH = HD / 4;
  static_assert(ROWS * CH % NTHR == 0, "every thread takes every pass");
#pragma unroll
  for (int pass = 0; pass < ROWS * CH / NTHR; ++pass) {
    const int i = tid + pass * NTHR;
    const int r8 = i & 7, c = (i >> 3) % CH, rg = (i >> 3) / CH;
    const int r = 8 * rg + r8;
    const bool ok = r0 + r < n;
    cp_async<16>(dst + (rg * CH + c) * 32 + 4 * r8,
                 src.row(ok ? r0 + r : 0) + 4 * c, ok);
  }
}

// hi = rna(x) and lo = rna(x - hi) stored at offset off of hi and lo
__device__ __forceinline__ void split_store(float4 x, float* hi, float* lo,
                                            int off) {
  uint4 h, l;
  tf32_split(x.x, h.x, l.x);
  tf32_split(x.y, h.y, l.y);
  tf32_split(x.z, h.z, l.z);
  tf32_split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// the chunks of a load_core_f32 tile that this thread copied (it must have
// waited for them), split in place: hi = rna(x * scale) in place, lo at
// the same offset in lo
template <int HD, int ROWS, int NTHR>
__device__ __forceinline__ void split_core(float* hi, float* lo, float scale,
                                           int tid) {
  constexpr int CH = HD / 4;
  static_assert(ROWS * CH % NTHR == 0, "every thread takes every pass");
#pragma unroll
  for (int pass = 0; pass < ROWS * CH / NTHR; ++pass) {
    const int i = tid + pass * NTHR;
    const int r8 = i & 7, c = (i >> 3) % CH, rg = (i >> 3) / CH;
    const int off = (rg * CH + c) * 32 + 4 * r8;
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    split_store(make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                            __fmul_rn(x.z, scale), __fmul_rn(x.w, scale)),
                hi, lo, off);
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

// hd <= 64: the producer's part of K/V tile t (keys past Sk zero): kc =
// HD/8 chunks of 4 floats of K, then kc of V.  K chunk p is the 16-byte
// chunk i = tid + 128 p of the core layout of load_core_f32: key
// 8 (i/8/(HD/4)) + i%8, dims 4 ((i/8) % (HD/4)) + 0..3.  V is stored
// transposed, as P V's K-major B operand in 8-row x 16-byte core
// matrices: element (d, j) at ((d/8) * 16 + j/4) * 32 + (d%8) * 4 + j%4,
// where column j holds key 8 (j/8) + 2 (j%4) + (j%8)/4 -- in each 8-key
// chunk column t is key 2t and column t+4 key 2t+1, the order of P's
// fragment.  So V chunk p, i = tid + 128 p, is dim d = i % HD of the keys
// of columns 4g..4g+3, g = i / HD: four 4-byte reads, each of them 128
// contiguous bytes across a warp's lanes.
template <int HD>
struct KvChunks {
  static constexpr int CH = HD / 4, KC = HD / 8, P = 128;
  static_assert(kKeys * CH == KC * P, "every thread takes every pass");
  // K chunk p: where its first element would lie in device memory (read
  // it only when ok: its key lies before Sk), and its offset in the stage.
  // The address is the tile's first row plus a 32-bit offset, not
  // clamped: 64 rows of the widest stride stay far below 2^31 elements,
  // and the compiler needs one 64-bit base rather than one per chunk.
  template <typename V>
  static __device__ __forceinline__ const float* k_src(const V& rows, int t,
                                                       int p, int Sk,
                                                       int tid, bool& ok) {
    const int i = tid + p * P;
    const int r = 8 * ((i >> 3) / CH) + (i & 7);   // the key in the tile
    ok = t * kKeys + r < Sk;
    return rows.k.row(t * kKeys) +
           (r * static_cast<int>(rows.k.stride) + 4 * ((i >> 3) % CH));
  }
  static __device__ __forceinline__ int k_off(int p, int tid) {
    const int i = tid + p * P;
    return ((i >> 3) / CH * CH + (i >> 3) % CH) * 32 + 4 * (i & 7);
  }
  // V chunk p: element m (column 4g + m) in device memory, addressed as
  // above, and the offset of its 4 columns in the V^T half of the stage
  template <typename V>
  static __device__ __forceinline__ const float* v_src(const V& rows, int t,
                                                       int p, int m, int Sk,
                                                       int tid, bool& ok) {
    const int i = tid + p * P, g = i / HD;
    const int r = 8 * (g >> 1) + 2 * m + (g & 1);   // the key in the tile
    ok = t * kKeys + r < Sk;
    return rows.v.row(t * kKeys) +
           (r * static_cast<int>(rows.v.stride) + i % HD);
  }
  static __device__ __forceinline__ int v_off(int p, int tid) {
    const int i = tid + p * P, d = i % HD;
    return ((d >> 3) * (kKeys / 4) + i / HD) * 32 + 4 * (d & 7);
  }
};

// the producer's part of K/V tile t into registers r (chunk p in r[p], K
// first)
template <int HD, typename V>
__device__ __forceinline__ void fetch_kv(float4 (&r)[HD / 4], const V& rows,
                                         int t, int Sk, int tid) {
  using C = KvChunks<HD>;
  bool ok;
#pragma unroll
  for (int p = 0; p < C::KC; ++p) {
    const float* src = C::k_src(rows, t, p, Sk, tid, ok);
    r[p] = ok ? __ldg(reinterpret_cast<const float4*>(src))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int p = 0; p < C::KC; ++p) {
    float x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float* src = C::v_src(rows, t, p, m, Sk, tid, ok);
      x[m] = ok ? __ldg(src) : 0.f;
    }
    r[C::KC + p] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// ... or by cp.async into this thread's 16-byte slots of dst (chunk p at
// dst + 4 (tid + 128 p): consecutive threads, consecutive slots)
template <int HD, typename V>
__device__ __forceinline__ void land_kv(float* dst, const V& rows, int t,
                                        int Sk, int tid) {
  using C = KvChunks<HD>;
  bool ok;
#pragma unroll
  for (int p = 0; p < C::KC; ++p) {
    const float* src = C::k_src(rows, t, p, Sk, tid, ok);
    cp_async<16>(dst + 4 * (tid + C::P * p), ok ? src : rows.k.row(0), ok);
  }
#pragma unroll
  for (int p = 0; p < C::KC; ++p)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float* src = C::v_src(rows, t, p, m, Sk, tid, ok);
      cp_async<4>(dst + 4 * (tid + C::P * (C::KC + p)) + m,
                  ok ? src : rows.v.row(0), ok);
    }
}

// the producer's chunks of a tile (get(p) gives chunk p) split into stage
// st: K hi | K lo | V^T hi | V^T lo.  Within 8 lanes the stores of a
// chunk fill 128 contiguous bytes.
template <int HD, typename Get>
__device__ __forceinline__ void put_kv(Get get, float* st, int tid) {
  using C = KvChunks<HD>;
  constexpr int KT = kKeys * HD;
#pragma unroll
  for (int p = 0; p < C::KC; ++p)
    split_store(get(p), st, st + KT, C::k_off(p, tid));
#pragma unroll
  for (int p = 0; p < C::KC; ++p)
    split_store(get(C::KC + p), st + 2 * KT, st + 3 * KT, C::v_off(p, tid));
}

// x, opaque to the compiler: what is computed from it is computed where it
// is used, not hoisted out of a loop (or held from before a branch) in
// registers that the tile needs
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ int64_t opaque(int64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// S = Q K^T of one warpgroup's 64 rows and a K tile (hi | lo) into sc:
// three passes, small terms first; a k8 step spans two core matrices
// along hd (lbo 128 bytes).  Issues and commits; the caller fences before
// and waits after.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&sc)[32], const float* Qh,
                                             const float* Ql,
                                             const float* Kh) {
  constexpr uint32_t SBO = 32 * HD;   // bytes between 8-row core groups
  // a k8 step is 256 bytes on in each tile: 16 in the descriptor's
  // address field (one add per step, not one descriptor register each)
  uint64_t qh = gmma_desc(Qh, 128, SBO), ql = gmma_desc(Ql, 128, SBO);
  const uint64_t kh = gmma_desc(Kh, 128, SBO);
  const uint64_t kl = gmma_desc(Kh + kKeys * HD, 128, SBO);
  // Q's descriptors do not change from tile to tile: made opaque here, so
  // that the compiler does not hoist all 2 hd/8 of them out of the key
  // loop and hold them in registers through P V
  asm volatile("" : "+l"(qh), "+l"(ql));
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc)
    wgmma_tf32_m64n64(sc, ql + 16 * kc, kh + 16 * kc, kc);
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc)
    wgmma_tf32_m64n64(sc, qh + 16 * kc, kl + 16 * kc, 1);
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc)
    wgmma_tf32_m64n64(sc, qh + 16 * kc, kh + 16 * kc, 1);
  wgmma_commit();
}

// the masks and online softmax of key tile k0..k0+63 on the S registers
// (sc -> p) of a thread holding rows r0 (h 0) and r0 + 8 (h 1) of the
// warpgroup whose rows start at q0; the four lanes of a quad (t4) hold a
// row's 64 keys between them.  corr rescales the rows' earlier sums.
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               int k0, int Sk, int causal,
                                               int q0, int r0, int t4) {
  constexpr int NT = kKeys / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  // the kv_len mask on the last tile, the causal mask on the diagonal
  if (k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > q0)) {
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int row = r0 + 8 * ((i >> 1) & 1);
      if (key >= Sk || (causal && key > row)) sc[i] = -INFINITY;
    }
  }
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
}

// O / l into the output rows r0 and r0 + 8 that lie before Sq
template <int HD, typename V>
__device__ __forceinline__ void store_rows(const V& rows,
                                           const float (&o)[HD / 2],
                                           const float (&l)[2], int r0,
                                           int Sq, int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + 8 * h;
    if (row >= Sq) continue;
    float* dst = rows.out + row * rows.out_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[4 * n + 2 * h] / sum, o[4 * n + 2 * h + 1] / sum);
  }
}

// hd <= 64, 384 threads (the header's first shape).  Warpgroup 0, the
// producer, copies Q once (split in place) and each K/V tile (even tiles
// into registers, odd ones into the landing buffer), splits it into its
// stage and publishes the stage on its "full" mbarrier (after
// fence.proxy.async, so that wgmma sees the split values).  Warpgroups 1
// and 2, the consumers (64 query rows each), wait for a stage, compute S,
// the softmax and P V, and release it on its "empty" mbarrier; the
// producer refills a stage once both have released it.
template <int HD, typename Src>
__device__ __forceinline__ void tf32_ws_tile(const Src& src, int Sq, int Sk,
                                             int causal, float scale,
                                             int n_qtiles, float* smem) {
  using Cfg = Tf32Cfg<HD>;
  constexpr int KT = Cfg::KT, STAGE = Cfg::STAGE;
  constexpr int NT = kKeys / 8;       // k8 steps of P V
  constexpr int P = Cfg::PRODUCERS;
  constexpr uint32_t VT_SBO = 32 * kKeys;   // bytes between V^T row groups
  float* Qh = smem;                          // [kQRows x HD] cores
  float* Ql = Qh + kQRows * HD;
  float* ring = Ql + kQRows * HD;            // [2][STAGE]
  float* land = ring + 2 * STAGE;            // an odd tile's K | V, raw
  uint64_t* full = reinterpret_cast<uint64_t*>(land + 2 * KT);
  uint64_t* empty = full + 2;
  uint64_t* q_full = full + 4;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, P);
      mbar_init(empty + s, kThreads);
    }
    mbar_init(q_full, P);
  }
  __syncthreads();

  // the block's (batch*head) and first query row, and the key tiles it
  // reads, computed by each role in its own branch (from an opaque
  // n_qtiles), so that nothing is held in registers across the branch
  auto geometry = [&](int64_t& bh, int& qb, int& n_tiles) {
    const int nq = opaque(n_qtiles);
    bh = blockIdx.x / nq;
    int qt = static_cast<int>(blockIdx.x - bh * nq);
    if (causal) qt = nq - 1 - qt;   // the longest key ranges first
    qb = qt * kQRows;
    // causal: no row of this block sees a key past its last row
    const int k_end = causal ? min(Sk, qb + kQRows) : Sk;
    n_tiles = (k_end + kKeys - 1) / kKeys;
  };
  int64_t bh;
  int qb, n_tiles;

  if (tid < P) {   // the producer
    geometry(bh, qb, n_tiles);
    const auto rows = src.view(bh);
    // a tile goes from device memory, split, into its stage once the
    // consumers have released the tile before in that stage; two tiles
    // are in flight, even ones in registers (r), odd ones raw in the
    // landing buffer, so that a tile's fetch has two consumer tiles' time
    float4 r[HD / 4];
    // this thread's index, made opaque in every tile: its chunks' offsets
    // are computed as they are used rather than held
    int ptid = tid;
    auto put = [&](auto get, int t) {
      put_kv<HD>(get, ring + (t & 1) * STAGE, ptid);
      fence_proxy_async();
      mbar_arrive(full + (t & 1));
    };
    auto from_regs = [&](int p) { return r[p]; };
    auto from_land = [&](int p) {
      return *reinterpret_cast<const float4*>(land + 4 * (ptid + P * p));
    };
    load_core_f32<HD, kQRows, P>(Qh, rows.q, qb, Sq, tid);
    cp_async_commit();
    fetch_kv<HD>(r, rows, 0, Sk, tid);
    if (n_tiles > 1) land_kv<HD>(land, rows, 1, Sk, tid);
    cp_async_commit();
    cp_async_wait<1>();   // Q has landed
    split_core<HD, kQRows, P>(Qh, Ql, scale, tid);
    fence_proxy_async();
    mbar_arrive(q_full);
    for (int t = 0; t < n_tiles; t += 2) {
      ptid = opaque(tid);
      // tile t into stage 0 once tile t-2 is released
      if (t >= 2) mbar_wait(empty, ((t >> 1) - 1) & 1);
      put(from_regs, t);
      if (t + 2 < n_tiles) fetch_kv<HD>(r, rows, t + 2, Sk, ptid);
      if (t + 1 >= n_tiles) break;
      // tile t+1 into stage 1 once tile t-1 is released
      if (t >= 2) mbar_wait(empty + 1, ((t >> 1) - 1) & 1);
      cp_async_wait<0>();
      put(from_land, t + 1);
      if (t + 3 < n_tiles) land_kv<HD>(land, rows, t + 3, Sk, ptid);
      cp_async_commit();
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers
  geometry(bh, qb, n_tiles);
  const int ctid = tid - P, warp = ctid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // warp-uniform for ptxas (see attention_wgmma_kernel)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), w4 = warp & 3;
  const int q0 = qb + 64 * wg;          // first query row of the warpgroup
  const int r0 = q0 + 16 * w4 + g;      // this thread's rows: r0, r0 + 8
  // the tiles this warpgroup computes: none past its rows (causal), none
  // when all its rows lie past Sq
  const int n_live = q0 >= Sq ? 0 : causal ? min(n_tiles, q0 / kKeys + 1)
                                           : n_tiles;
  float o[HD / 2], sc[NT * 4], m[2], l[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  const float* Qhw = Qh + 64 * HD * wg;
  const float* Qlw = Ql + 64 * HD * wg;
  mbar_wait(q_full, 0);
  for (int t = 0; t < n_live; ++t) {
    mbar_wait(full + (t & 1), (t >> 1) & 1);
    const float* st = ring + (t & 1) * STAGE;
    wgmma_fence();
    issue_scores<HD>(sc, Qhw, Qlw, st);
    wgmma_wait<0>();
    fence_regs(sc);
    float corr[2];
    online_softmax(sc, m, l, corr, t * kKeys, Sk, causal, q0, r0, t4);
    // O = O * corr + P V: P split in registers in the order of the A
    // fragment, three passes of 8 k8 steps into pv (the first from zero)
    uint32_t ph[NT][4], pl[NT][4];
    float pv[HD / 2];
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      tf32_split(sc[4 * c], ph[c][0], pl[c][0]);
      tf32_split(sc[4 * c + 2], ph[c][1], pl[c][1]);
      tf32_split(sc[4 * c + 1], ph[c][2], pl[c][2]);
      tf32_split(sc[4 * c + 3], ph[c][3], pl[c][3]);
    }
    // V^T hi and lo; a k8 step is 16 on in the descriptor (as in S)
    const uint64_t vh = gmma_desc(st + 2 * KT, 128, VT_SBO);
    const uint64_t vl = gmma_desc(st + 3 * KT, 128, VT_SBO);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NT; ++c)
      wgmma_tf32_rs<HD>(pv, pl[c], vh + 16 * c, c);
#pragma unroll
    for (int c = 0; c < NT; ++c)
      wgmma_tf32_rs<HD>(pv, ph[c], vl + 16 * c, 1);
#pragma unroll
    for (int c = 0; c < NT; ++c)
      wgmma_tf32_rs<HD>(pv, ph[c], vh + 16 * c, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      fence_regs(ph[c]);
      fence_regs(pl[c]);
    }
    mbar_arrive(empty + (t & 1));   // this warpgroup is done with tile t
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      o[i] = fmaf(o[i], corr[(i >> 1) & 1], pv[i]);
  }
  // this warpgroup is done (causal, or rows past Sq): it releases the
  // tiles its partner still needs, each once it is full, so that no
  // arrival counts toward a later phase
  for (int t = n_live; t < n_tiles; ++t) {
    mbar_wait(full + (t & 1), (t >> 1) & 1);
    mbar_arrive(empty + (t & 1));
  }
  // the output rows, computed anew (see opaque)
  store_rows<HD>(src.view(opaque(bh)), o, l, r0, Sq, t4);
}

// hd > 64, 256 threads: both warpgroups copy and split each K tile, then
// compute; S, softmax and P V in turn, P V on mma.sync with V raw in
// shared memory, split by each lane as it reads
template <int HD, typename Src>
__device__ __forceinline__ void tf32_sync_tile(const Src& src, int Sq, int Sk,
                                               int causal, float scale,
                                               int n_qtiles, float* smem) {
  using Cfg = Tf32Cfg<HD>;
  constexpr int STAGES = Cfg::STAGES, AHEAD = Cfg::AHEAD, KT = Cfg::KT;
  constexpr int VLD = Cfg::VLD, STAGE = Cfg::STAGE;
  constexpr int NT = kKeys / 8;   // n8 chunks of S, k8 steps of P V
  constexpr int ON = HD / 8;      // n8 chunks of O
  constexpr int NG = ON <= 10 ? ON : ON / 2;   // ... per pass over P
  float* Qh = smem;                            // [kQRows x HD] cores
  float* Ql = Qh + kQRows * HD;
  float* ring = Ql + kQRows * HD;              // [STAGES][STAGE]

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

  load_core_f32<HD, kQRows, kThreads>(Qh, rows.q, qb, Sq, tid);
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
    load_core_f32<HD, kKeys, kThreads>(Ks, rows.k, tile * kKeys, Sk, tid);
    load_rows_f32<HD, VLD>(Ks + 2 * KT, rows.v, tile * kKeys, Sk, tid);
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();   // empty groups keep the count uniform
  }
  cp_async_wait<AHEAD>();   // Q has landed (for this thread): split it
  split_core<HD, kQRows, kThreads>(Qh, Ql, scale, tid);

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
    split_core<HD, kKeys, kThreads>(Kh, Kh + KT, 1.f, tid);   // ... split
                                                              // by its
                                                              // copiers
    fence_proxy_async();          // ... and visible to wgmma
    __syncthreads();              // ... for all; tile t-1's stage is free
    if constexpr (AHEAD > 0) {
      if (t + AHEAD < n_tiles) load_kv(t + AHEAD);
      cp_async_commit();
    }
    if (t >= n_live) continue;    // this warpgroup is done
    wgmma_fence();
    issue_scores<HD>(sc, Qhw, Qlw, Kh);
    wgmma_wait<0>();
    fence_regs(sc);
    float corr[2];
    online_softmax(sc, m, l, corr, t * kKeys, Sk, causal, q0, r0, t4);
    // O = O * corr + P V, NG n8 chunks of O at a time: P split in
    // registers, each lane splits the two V elements it reads
    const float* Vs = Kh + 2 * KT;
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
  // the output rows, computed anew (see opaque)
  store_rows<HD>(src.view(opaque(bh)), o, l, r0, Sq, t4);
}

template <typename Tag, int HD, typename Src>
__global__ void __launch_bounds__(Tf32Cfg<HD>::THREADS, 1)
    attention_tf32_kernel(const Src src, int Sq, int Sk, int causal,
                          float scale, int n_qtiles) {
  // declared as the bf16 tile declares it (one translation unit holds both)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  if constexpr (Tf32Cfg<HD>::PV_WGMMA)
    tf32_ws_tile<HD>(src, Sq, Sk, causal, scale, n_qtiles, smem);
  else
    tf32_sync_tile<HD>(src, Sq, Sk, causal, scale, n_qtiles, smem);
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
    kernel<<<static_cast<unsigned>(blocks), Tf32Cfg<HD>::THREADS, smem,
             stream>>>(src, Sq, Sk, causal, scale, n_qtiles);
    return counted_launch(kTileAttnTf32);
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
