// The bf16 attention tile on the tensor cores, shared by K1
// short_attention_qkv, K3 short_attention, and K5 mid_attention and K6
// flash_attention at head_dims other than 64: non-causal or square-causal
// softmax attention, with one addressing policy per way the callers lay
// out their rows (a template parameter of the kernel):
//   Contiguous  separate q, k, v [BH, S, hd] -> out [BH, Sq, hd] (K3, K5,
//               K6)
//   FusedQKV    q, k and v read straight from the fused projection
//               [B, S, 3D] (row stride 3D, columns h*hd, D + h*hd,
//               2D + h*hd) -> out [B, S, D] (K1)
// Each source names its kernels with a tag type
// (attention_wgmma_kernel<mid_attention, 64, ...> in a profile); the names
// here have internal linkage, so every source holds its own copy.  The
// policies take their element type, so the f32 tile of K1, K3, K4, K5 and
// K6 (attention_tf32.cuh: every f32 product as three TF32 products, within
// the f32 paths' 2e-5 bound) addresses its rows with them too.  K4, and K5
// and K6 at head_dim 64, run attention_tma.cuh in bf16.
//
// Bound on the H100: the tensor cores, and beside them the exponentials.
// A bf16 joint call at SD3.5-medium's 1024^2 is 809 GFLOP against 86 MB
// (~9,400 flops per byte): 0.82 ms at the 989 TFLOP/s bf16 rate.  Its
// 3.2e9 softmax exponentials take 0.85 ms on the SMs' 16 MUFU lanes each,
// so at hd 64 the exp2 work is as large as the products, and the ~5 f32
// operations per score (scale, max, sum, rescale, round) add ~0.5 ms on
// the CUDA cores; only their overlap with the products gets below the sum.
// The CUDA-core kernels it replaced ran the products as scalar f32 FMAs
// (67 TFLOP/s peak) and reached 22.6 TFLOP/s.
//
// Design (wgmma, sm_90a): a block owns one (batch*head) and 128 query rows
// held by two warpgroups of 64 rows, which share a ring of 64-key K/V tiles
// (4 stages at hd <= 64, else 3) that all 256 threads fill by cp.async,
// up to two tiles ahead of the one in use; key rows past Sk and query rows past
// Sq are zero-filled in shared memory, never padded in device memory, and
// keys past Sk score -inf.  The policy only maps a row index to a row
// pointer.  Per tile t a warpgroup issues
//   S_t = Q K_t^T         wgmma m64n64k16, Q and K K-major from shared
//                         memory, f32 accumulators in registers
//   O += P_{t-1} V_{t-1}  wgmma m64n{hd}k16, P from registers (the f32
//                         fragments of S rounded to bf16: the C layout of
//                         two n8 chunks is the A layout of one k16 step),
//                         V MN-major (transposed) from shared memory
// together, then runs tile t's online softmax on the S registers -- row max
// and sum over a quad of lanes by shuffles, exp2 (MUFU ex2.approx) of the
// scores scaled by 1/sqrt(hd) * log2(e) in f32 (q is never scaled in bf16:
// that is exact only when sqrt(hd) is a power of two) -- while P_{t-1}
// V_{t-1} is still on the tensor cores.  P never touches shared memory.
// The row sum keeps the unrounded p, so the output differs from the plain
// version by at most 2^-8 of the plain version over |v|
// (flash_attention_bf16_tolerance).  hd 64 keeps its tiles row-major with
// the 128-byte swizzle (wgmma's B128 mode); other head_dims, whose rows are
// no multiple of 128 bytes, use 8x8 core matrices without swizzle, which
// the tensor cores read more slowly.  The grid is one-dimensional (q tile
// fastest), which takes any B*H; under the causal mask a block stops at the
// tile holding its last row, a warpgroup stops at the tile past its rows,
// only the tiles that cross its diagonal (or Sk) are masked, and the
// longest q tiles are scheduled first.
#pragma once

#include <math.h>

#include "mma_bf16.cuh"

namespace {
namespace tc {

constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kQRows = 128;  // query rows per block: two warpgroups
constexpr int kThreads = 256;

template <int HD>
struct WgCfg {
  // K/V ring: tiles t and t-1 are read while tiles up to t + AHEAD land
  static constexpr int STAGES = HD <= 64 ? 4 : 3;
  static constexpr int AHEAD = STAGES - 2;
  static constexpr int TILE = kKeys * HD;             // elements of K or V
  static constexpr size_t SMEM =
      sizeof(bf16) * (kQRows * HD + STAGES * 2 * TILE);
};

// ---------------------------------------------------------------------------
// addressing policies: which row of device memory holds row r of a
// (batch*head)'s q, k, v or output
// ---------------------------------------------------------------------------

// rows of one stream: row r at p + r * stride
template <typename T>
struct RowsOf {
  const T* p;
  int64_t stride;
  __device__ __forceinline__ const T* row(int r) const {
    return p + r * stride;
  }
};

// one (batch*head)'s rows; output row r at out + r * out_stride
template <typename R, typename T = bf16>
struct View {
  R q, k, v;
  T* out;
  int64_t out_stride;
};

// K3, K5, K6: separate q [BH, Sq, HD], k and v [BH, Sk, HD] -> out
// [BH, Sq, HD], of element type T
template <int HD, typename T>
struct ContiguousOf {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int Sq, Sk;
  __device__ __forceinline__ View<RowsOf<T>, T> view(int64_t bh) const {
    return {{q + bh * Sq * HD, HD}, {k + bh * Sk * HD, HD},
            {v + bh * Sk * HD, HD}, out + bh * Sq * HD, HD};
  }
};

// K1 (and K4's f32 tile, on its pre-pass's joint rows): the fused rows
// [B, S, 3D] (q | k | v column groups, heads contiguous in each) -> out
// [B, S, D], of element type T; bh = b * heads + h
template <int HD, typename T>
struct FusedQKVOf {
  const T* qkv;
  T* out;
  int S, heads;
  __device__ __forceinline__ View<RowsOf<T>, T> view(int64_t bh) const {
    const int64_t b = bh / heads, h = bh - b * heads;
    const int64_t D = static_cast<int64_t>(heads) * HD;
    const T* base = qkv + b * S * 3 * D + h * HD;
    return {{base, 3 * D}, {base + D, 3 * D}, {base + 2 * D, 3 * D},
            out + b * S * D + h * HD, D};
  }
};

template <int HD>
using Contiguous = ContiguousOf<HD, bf16>;
template <int HD>
using FusedQKV = FusedQKVOf<HD, bf16>;

// rows [rows, HD] (row r0 first; rows past n zero-filled) into dst as 8x8
// core matrices: element (r, c) at ((r/8) * HD/8 + c/8) * 64 + (r%8) * 8 +
// c%8; consecutive threads fill consecutive 16-byte rows
template <int HD, int ROWS, typename R>
__device__ __forceinline__ void load_core(bf16* dst, const R& src, int r0,
                                          int n, int tid) {
  constexpr int CH = HD / 8;
  for (int i = tid; i < ROWS * CH; i += kThreads) {
    const int r8 = i & 7, c = (i >> 3) % CH, rg = (i >> 3) / CH;
    const int r = 8 * rg + r8;
    const bool ok = r0 + r < n;
    cp_async<16>(dst + (rg * CH + c) * 64 + 8 * r8,
                 src.row(ok ? r0 + r : 0) + 8 * c, ok);
  }
}

// hd 64: rows [rows, 64] row-major with the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)), the layout of wgmma's B128 mode;
// thread tid copies chunk tid % 8 of rows tid / 8, tid / 8 + 32, ...
template <int ROWS, typename R>
__device__ __forceinline__ void load_sw128(bf16* dst, const R& src, int r0,
                                           int n, int tid) {
  for (int i = tid; i < ROWS * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < n;
    cp_async<16>(dst + 64 * r + 8 * (c ^ (r & 7)),
                 src.row(ok ? r0 + r : 0) + 8 * c, ok);
  }
}

// B128 descriptor: 8-row atoms of 1024 bytes (sbo), 1024-aligned tiles;
// a tile of one 64-wide panel never steps along the leading dimension, so
// its offset (lbo) is unused
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return gmma_desc(p, 0, 1024) | (1ull << 62);
}

// two consumer warpgroups of 64 query rows each share the K/V ring; each
// issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} together, so the softmax
// of tile t runs on the CUDA cores while P_{t-1} V_{t-1} runs on the
// tensor cores
template <typename Tag, int HD, typename Src>
__global__ void __launch_bounds__(kThreads)
    attention_wgmma_kernel(const Src src, int Sq, int Sk, int causal,
                           float scale_log2, int n_qtiles) {
  using Cfg = WgCfg<HD>;
  constexpr int STAGES = Cfg::STAGES, AHEAD = Cfg::AHEAD, TILE = Cfg::TILE;
  constexpr int CH = HD / 8;
  constexpr int NT = kKeys / 8;   // n8 chunks of the scores
  constexpr int ON = HD / 8;      // n8 chunks of the output

  constexpr bool SW = HD == 64;   // 128-byte swizzle
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kQRows x HD] cores
  bf16* KVs = Qs + kQRows * HD;                    // [STAGES][K|V][TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // the warpgroup index, read through a shuffle so that ptxas knows it is
  // warp-uniform: the branches around the wgmma below then do not look
  // divergent, and it does not serialize them (its warning C7520)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), w4 = warp & 3;
  const int64_t bh = blockIdx.x / n_qtiles;
  int qt = static_cast<int>(blockIdx.x - bh * n_qtiles);
  if (causal) qt = n_qtiles - 1 - qt;   // the longest key ranges first
  const int qb = qt * kQRows;
  const int q0 = qb + 64 * wg;          // first query row of the warpgroup
  const int r0 = q0 + 16 * w4 + g;      // this thread's rows: r0, r0 + 8
  const auto rows = src.view(bh);

  if constexpr (SW)
    load_sw128<kQRows>(Qs, rows.q, qb, Sq, tid);
  else
    load_core<HD, kQRows>(Qs, rows.q, qb, Sq, tid);
  cp_async_commit();
  // causal: no row of this block sees a key past its last row
  const int k_end = causal ? min(Sk, qb + kQRows) : Sk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  // the tiles this warpgroup computes: none past its rows (causal), none
  // when all its rows lie past Sq
  const int n_live = q0 >= Sq ? 0 : causal ? min(n_tiles, q0 / kKeys + 1)
                                           : n_tiles;
  auto load_kv = [&](int tile) {
    bf16* Ks = KVs + (tile % STAGES) * 2 * TILE;
    if constexpr (SW) {
      load_sw128<kKeys>(Ks, rows.k, tile * kKeys, Sk, tid);
      load_sw128<kKeys>(Ks + TILE, rows.v, tile * kKeys, Sk, tid);
    } else {
      load_core<HD, kKeys>(Ks, rows.k, tile * kKeys, Sk, tid);
      load_core<HD, kKeys>(Ks + TILE, rows.v, tile * kKeys, Sk, tid);
    }
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();   // empty groups keep the count uniform
  }

  const bf16* Qw = Qs + 64 * HD * wg;
  float o[HD / 2], sc[NT * 4], m[2], l[2];
  uint32_t pa[NT / 2][4];   // P_{t-1}, the A operand of P V
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  // iteration t computes S_t (t < n_live) and P_{t-1} V_{t-1} (t > 0)
  for (int t = 0; t <= n_tiles; ++t) {
    cp_async_wait<AHEAD - 1>();   // tile t has landed (for this thread)
    fence_proxy_async();          // ... and is visible to wgmma
    __syncthreads();              // ... for all; tile t-2 is free
    if (t + AHEAD < n_tiles) load_kv(t + AHEAD);
    cp_async_commit();
    if (t > n_live) continue;     // this warpgroup is done
    const bool has_s = t < n_live, has_pv = t > 0;
    const bf16* Ks = KVs + (t % STAGES) * 2 * TILE;
    const bf16* Vp = KVs + ((t + STAGES - 1) % STAGES) * 2 * TILE + TILE;

    wgmma_fence();
    if (has_s) {   // S = Q K^T: K-major A and B, two cores of hd per step
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        if constexpr (SW)
          wgmma_ss_m64n64(sc, sw128_desc(Qw + 16 * kc),
                          sw128_desc(Ks + 16 * kc), kc);
        else
          wgmma_ss_m64n64(sc, gmma_desc(Qw + 128 * kc, 128, 128 * CH),
                          gmma_desc(Ks + 128 * kc, 128, 128 * CH), kc);
      }
      wgmma_commit();
    }
    if (has_pv) {  // O += P V: V MN-major, two cores of keys per step
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        if constexpr (SW)
          wgmma_rs_t<HD>(o, pa[kc], sw128_desc(Vp + 1024 * kc));
        else
          wgmma_rs_t<HD>(o, pa[kc],
                         gmma_desc(Vp + 128 * CH * kc, 128 * CH, 128));
      }
      wgmma_commit();
    }
    if (!has_s) {
      wgmma_wait<0>();
      fence_regs(o);
      continue;
    }
    if (has_pv)
      wgmma_wait<1>();   // S_t is done; P_{t-1} V_{t-1} may still run
    else
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
      const float ms = mx == -INFINITY ? 0.f : mx * scale_log2;
      corr[h] = ex2_approx(m[h] * scale_log2 - ms);
      m[h] = mx;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              ex2_approx(fmaf(sc[4 * n + 2 * h + e], scale_log2, -ms));
          sc[4 * n + 2 * h + e] = p;
          rs += p;
        }
      l[h] = l[h] * corr[h] + rs;   // the unrounded p
    }
    if (has_pv) {
      wgmma_wait<0>();   // P_{t-1} V_{t-1} is done: o and pa are free
      fence_regs(o);
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) fence_regs(pa[kc]);
    }
#pragma unroll
    for (int n = 0; n < ON; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
    // P rounded to bf16: the C layout of two n8 chunks is the A layout of
    // one k16 step
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      pa[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
      pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
      pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
      pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
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
    bf16* dst = rows.out + row * rows.out_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] / sum,
                                o[4 * n + 2 * h + 1] / sum);
  }
}

// the bf16 tile's launch, one 128-row q tile per block
struct WgmmaTile {
  template <typename Tag, int HD, typename Src>
  static int launch(const Src& src, int BH, int Sq, int Sk, int causal,
                    cudaStream_t stream) {
    auto kernel = attention_wgmma_kernel<Tag, HD, Src>;
    constexpr size_t smem = WgCfg<HD>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_qtiles = (Sq + kQRows - 1) / kQRows;
    const int64_t blocks = static_cast<int64_t>(n_qtiles) * BH;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    // 1/sqrt(hd) rounded once from double, as JAX rounds its Python
    // float, then folded with log2(e) for exp2
    const float scale =
        static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        src, Sq, Sk, causal, scale * 1.4426950408889634f, n_qtiles);
    return counted_launch(kTileAttnWgmma);
  }
};

// Tile's launch of policy Src<hd>{args...} for hd a multiple of 16 up to
// 128 (Tile: WgmmaTile, or attention_tf32.cuh's Tf32Tile)
template <typename Tile, typename Tag, template <int> class Src,
          typename... Args>
int launch_by_hd(int hd, int BH, int Sq, int Sk, int causal, cudaStream_t s,
                 Args... args) {
  switch (hd) {
    case 16:
      return Tile::template launch<Tag, 16>(Src<16>{args...}, BH, Sq, Sk,
                                            causal, s);
    case 32:
      return Tile::template launch<Tag, 32>(Src<32>{args...}, BH, Sq, Sk,
                                            causal, s);
    case 48:
      return Tile::template launch<Tag, 48>(Src<48>{args...}, BH, Sq, Sk,
                                            causal, s);
    case 64:
      return Tile::template launch<Tag, 64>(Src<64>{args...}, BH, Sq, Sk,
                                            causal, s);
    case 80:
      return Tile::template launch<Tag, 80>(Src<80>{args...}, BH, Sq, Sk,
                                            causal, s);
    case 96:
      return Tile::template launch<Tag, 96>(Src<96>{args...}, BH, Sq, Sk,
                                            causal, s);
    case 112:
      return Tile::template launch<Tag, 112>(Src<112>{args...}, BH, Sq,
                                             Sk, causal, s);
    case 128:
      return Tile::template launch<Tag, 128>(Src<128>{args...}, BH, Sq,
                                             Sk, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], all
// contiguous and 16-byte aligned, BH, Sq and Sk positive; hd a multiple of
// 16 up to 128; causal needs Sq == Sk (the caller checks).  Returns the
// first CUDA error, or 0.
template <typename Tag>
int launch_attention_mma(const void* q, const void* k, const void* v,
                         void* out, int BH, int Sq, int Sk, int hd,
                         int causal, cudaStream_t s) {
  return launch_by_hd<WgmmaTile, Tag, Contiguous>(
      hd, BH, Sq, Sk, causal, s, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Sk);
}

// bf16 qkv [B, S, 3 * heads * hd] -> out [B, S, heads * hd], both
// contiguous and 16-byte aligned, B, S and heads positive; hd a multiple
// of 16 up to 128; never causal (the caller checks).  Returns the first
// CUDA error, or 0.
template <typename Tag>
int launch_fused_qkv_mma(const void* qkv, void* out, int B, int S, int heads,
                         int hd, cudaStream_t s) {
  return launch_by_hd<WgmmaTile, Tag, FusedQKV>(
      hd, B * heads, S, S, 0, s, static_cast<const bf16*>(qkv),
      static_cast<bf16*>(out), S, heads);
}

}  // namespace tc

// the launchers' argument check, shared by K3, K5 and K6 in both dtypes:
// positive sizes, hd a multiple of 16 up to 128, causal only when square
inline bool attention_args_ok(int BH, int Sq, int Sk, int hd, int causal) {
  return BH > 0 && Sq > 0 && Sk > 0 && hd > 0 && hd % 16 == 0 && hd <= 128 &&
         (!causal || Sq == Sk);
}

}  // namespace
