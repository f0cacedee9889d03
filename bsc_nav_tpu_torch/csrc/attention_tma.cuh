// The bf16 attention tile of K4 joint_qkv_attention, and of K5
// mid_attention and K6 flash_attention at head_dim 64, the only head_dim
// their main paths give them (the MMDiT's joint attention and DINOv2: 24
// or 16 heads x 64), in two layouts of rows:
//   contiguous  separate q, k, v [BH, S, 64] -> out [BH, Sq, 64],
//               non-causal or square-causal, ragged Sq and Sk (K5, K6)
//   fused       q, k and v read from fused rows [B, S, 3D] (q | k | v
//               column groups, heads contiguous in each) -> out [B, S, D]
//               at column h*64, non-causal (K4, on the joint rows its
//               qk-norm pre-pass writes)
// Every other head_dim of K5 and K6, and K1 and K3 in bf16, run
// attention_mma.cuh's attention_wgmma_kernel.
//
// Bound on the H100: the tensor cores, and beside them the exponentials
// (attention_mma.cuh's header reckons both at SD3.5-medium's 1024^2: 0.82
// ms of products, 0.85 ms of exp2 on the MUFU lanes; only their overlap
// gets below the sum).
//
// Design (sm_90a): a warp-specialized block of 1 + NC warpgroups (NC 3:
// 512 threads, 192 query rows); a work item is one (batch*head) and its
// 64 * NC query rows.  Without the causal mask the grid holds one block
// per SM, each walking the items in turn (persistent), so an item's loads
// run under the one before; under it, whose items differ in length, one
// block per item, the longest first.
// - Warpgroup 0, the producer, gives back its registers (setmaxnreg) and
//   one thread loads by TMA: each item's Q into one of two buffers, then
//   its 128-key K and V tiles into a ring of STAGES stages that runs on
//   across items, each published on its own "full" mbarrier (expect-tx)
//   and refilled once every consumer thread has released it on its
//   "empty" one.  The tensor maps are 3-D, [BH, S, 64], or over fused
//   rows 4-D, {64, heads, S, B} with strides of 128 bytes, 3D and S*3D
//   elements and q, k, v at column offsets 0, D and 2D, read in boxes of
//   {64, 1, rows, 1}; both with the 128-byte swizzle (one 64-wide bf16
//   row per swizzle atom, the layout of wgmma's B128 mode), so shared
//   memory gets the same [rows x 64] tile and TMA's zero fill ends each
//   (batch, head) at its own S: ragged Sq and Sk read no other head's
//   rows, and keys past Sk also score -inf.  K and V have separate
//   rings, so K_t is freed once S_t is done, V_t once P_t V_t is.
// - Warpgroups 1..NC, the consumers (64 query rows each), take the
//   registers and per key tile t issue
//     S_t = Q K_t^T         wgmma m64n128k16 x 4, Q and K from shared
//                           memory, into its own f32 accumulator
//     O += P_{t-1} V_{t-1}  wgmma m64n64k16 x 8, P from registers (bf16,
//                           the A layout), V MN-major from shared memory
//   as two groups, O rescaled by tile t-1's correction between them, then
//   run tile t's online softmax on S while P_{t-1} V_{t-1} is on the
//   tensor cores (wgmma.wait_group 1), and round P_t into its registers
//   once that product is done.  No non-wgmma instruction reads or defines
//   an accumulator while a group that writes it is in flight: each group
//   is fenced (wgmma.fence, and fence_regs on its registers, as CUTLASS's
//   warpgroup_fence_operand) and nothing branches around a wgmma, so
//   ptxas serializes none of them.  The consumers take the tensor cores in
//   turn (ping-pong): a warpgroup waits on its named barrier before
//   issuing a tile's two groups and arrives on the next one's after, so
//   one's exponentials run under another's products.  No block-wide
//   barrier remains in the key loop.
// The numerics are attention_mma.cuh's: f32 scores scaled by 1/sqrt(hd)
// after the dot and folded with log2(e) for ex2.approx, each p rounded to
// bf16 against the running max before P V, the row sum of the unrounded
// p, acc / l rounded to bf16 (flash_attention_bf16_tolerance); only the
// running max now advances every 128 keys.  Items run q tile fastest
// (non-causal: a head's K/V stay in L2), or under the causal mask the
// longest q tiles of every head first; an item stops at the key tile
// holding its last row, and only that tile and the one holding Sk are
// masked.
#pragma once

#include <cuda.h>   // CUtensorMap and its encoder's types (no libcuda link)
#include <math.h>

#include "attention_mma.cuh"

namespace {
namespace tc {

// three consumer warpgroups (192 query rows a block; two were slower at
// every main shape), 128-key tiles in a 2-stage ring (3 gained nothing)
struct TmaCfg {
  static constexpr int NC = 3;                // consumer warpgroups
  static constexpr int KEYS = 128;            // keys per K/V tile
  static constexpr int QROWS = 64 * NC;       // query rows per block
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int STAGES = 2;            // K and V ring depth
  static constexpr uint32_t KV_BYTES = KEYS * 64 * sizeof(bf16);
  static constexpr uint32_t Q_BYTES = QROWS * 64 * sizeof(bf16);
  // registers a thread: 128 x 32 + 384 x 160 = 65,536, a block's all
  static constexpr int PRODUCER_REGS = 32;
  static constexpr int CONSUMER_REGS = 160;
  // Q x 2 | K ring | V ring | mbarriers (full and empty of each)
  static constexpr size_t SMEM =
      2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (4 + 4 * STAGES);
  static_assert(SMEM <= 232448, "over a block's 227 KB");
};

// S = Q K_t^T of a warpgroup's 64 rows and a 128-key tile, both
// swizzled; a k16 step is 32 bytes on within the 128-byte rows
__device__ __forceinline__ void issue_scores_128(float (&s)[64],
                                                 const bf16* Qw,
                                                 const bf16* Kt) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma_ss_m64n128(s, sw128_desc(Qw + 16 * kc), sw128_desc(Kt + 16 * kc),
                     kc);
  wgmma_commit();
  fence_regs(s);
}

// O += P V_t: eight k16 steps of 16 keys (2 KB of the swizzled V tile)
__device__ __forceinline__ void issue_pv_128(float (&o)[32],
                                             uint32_t (&pa)[8][4],
                                             const bf16* Vt) {
  fence_regs(o);
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) fence_regs(pa[kc]);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
    wgmma_rs_t<64>(o, pa[kc], sw128_desc(Vt + 1024 * kc));
  wgmma_commit();
  fence_regs(o);
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) fence_regs(pa[kc]);
}

// tile t's online softmax on the S registers of rows r0 (h 0) and r0 + 8
// (h 1), the four lanes of a quad holding a row's 128 keys: masks keys
// past Sk and, under the causal mask, past the row; p = exp2(s * scale_log2
// - m * scale_log2) written over s; corr the factor for what came before
__device__ __forceinline__ void softmax_128(float (&s)[64], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            int k0, int Sk, int causal,
                                            int q0, int r0, int t4,
                                            float scale_log2) {
  if (k0 + 128 > Sk || (causal && k0 + 127 > q0)) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int row = r0 + 8 * ((i >> 1) & 1);
      if (key >= Sk || (causal && key > row)) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n = 0; n < 16; ++n)
      mx = fmaxf(mx, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no live key yet keeps m = -inf: no update, no NaN
    const float ms = mx == -INFINITY ? 0.f : mx * scale_log2;
    corr[h] = ex2_approx(m[h] * scale_log2 - ms);
    m[h] = mx;
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            ex2_approx(fmaf(s[4 * n + 2 * h + e], scale_log2, -ms));
        s[4 * n + 2 * h + e] = p;
        rs += p;
      }
    l[h] = l[h] * corr[h] + rs;   // the unrounded p
  }
}

// P rounded to bf16: the C layout of two n8 chunks is the A layout of one
// k16 step
__device__ __forceinline__ void pack_p_128(uint32_t (&pa)[8][4],
                                           const float (&s)[64]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// FUSED: the tensor maps are 4-D over fused rows and out is [B, Sq,
// heads * 64]; else 3-D and out [BH, Sq, 64]
template <typename Tag, bool FUSED>
__global__ void __launch_bounds__(TmaCfg::THREADS, 1)
    attention_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         bf16* __restrict__ out, int Sq, int Sk, int causal,
                         float scale_log2, int n_qtiles, int BH, int heads) {
  using Cfg = TmaCfg;
  constexpr int NC = Cfg::NC, KEYS = Cfg::KEYS, QROWS = Cfg::QROWS;
  constexpr int ST = Cfg::STAGES;
  constexpr int TILE = KEYS * 64;   // elements of a K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [2][QROWS x 64]
  bf16* Ks = Qs + 2 * QROWS * 64;                  // [ST][TILE]
  bf16* Vs = Ks + ST * TILE;                       // [ST][TILE]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * TILE);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;

  const int tid = threadIdx.x;
  const int n_work = n_qtiles * BH;   // (q tile, batch*head) pairs
  // work item w: its (batch*head), first query row and key tiles
  auto decode = [&](int w, int& bh, int& qb, int& n_tiles) {
    int qt;
    if (causal) {   // the longest key ranges of every head first
      qt = n_qtiles - 1 - w / BH;
      bh = w % BH;
    } else {        // q tile fastest: a head's K and V stay in L2
      bh = w / n_qtiles;
      qt = w - bh * n_qtiles;
    }
    qb = qt * QROWS;
    // causal: no row of this block sees a key past its last row
    const int k_end = causal ? min(Sk, qb + QROWS) : Sk;
    n_tiles = (k_end + KEYS - 1) / KEYS;
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, 128 * NC);
    }
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 128 * NC);
      mbar_init(v_empty + s, 128 * NC);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // warp-uniform for ptxas (see attention_wgmma_kernel)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == 0) {   // the producer: one thread issues every load
    setmaxnreg_dec<Cfg::PRODUCER_REGS>();
    if (tid == 0) {
      // row r of (batch*head) bh: {0, r, bh}, or {0, h, r, b} fused
      auto load = [&](bf16* dst, const CUtensorMap* map, uint64_t* bar,
                      int r, int bh) {
        if constexpr (FUSED)
          tma_load_4d(dst, map, bar, 0, bh % heads, r, bh / heads);
        else
          tma_load_3d(dst, map, bar, 0, r, bh);
      };
      int it = 0;   // K/V tiles loaded so far: the ring position
      int j = 0;    // work items so far: the Q buffer
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++j) {
        int bh, qb, n_tiles;
        decode(w, bh, qb, n_tiles);
        const int qs = j & 1;
        // the work item before in this Q buffer has released it
        if (j >= 2) mbar_wait(q_empty + qs, (j / 2 - 1) & 1);
        mbar_expect_tx(q_full + qs, Cfg::Q_BYTES);
        load(Qs + qs * QROWS * 64, &tm_q, q_full + qs, qb, bh);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % ST;
          // the tile before in this stage has been released
          if (it >= ST) mbar_wait(k_empty + s, (it / ST - 1) & 1);
          mbar_expect_tx(k_full + s, Cfg::KV_BYTES);
          load(Ks + s * TILE, &tm_k, k_full + s, t * KEYS, bh);
          if (it >= ST) mbar_wait(v_empty + s, (it / ST - 1) & 1);
          mbar_expect_tx(v_full + s, Cfg::KV_BYTES);
          load(Vs + s * TILE, &tm_v, v_full + s, t * KEYS, bh);
        }
      }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<Cfg::CONSUMER_REGS>();
  const int c = wg - 1;                  // consumer index
  const int w4 = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // ping-pong: consumer c waits on barrier 1 + c and hands over to the
  // next; the last one opens the first turn and skips its own last
  // hand-over, so every barrier's arrivals match its waits
  const int my_bar = 1 + c, next_bar = 1 + (c + 1) % NC;
  auto take_turn = [&] { named_sync(my_bar, 256); };
  auto hand_over = [&](bool last) {
    if (!(last && c == NC - 1)) named_arrive(next_bar, 256);
  };
  if (c == NC - 1) named_arrive(1, 256);

  int it = 0;   // K/V tiles consumed so far: the ring position
  int j = 0;    // work items so far: the Q buffer
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++j) {
    int bh, qb, n_tiles;
    decode(w, bh, qb, n_tiles);
    const int q0 = qb + 64 * c;          // first query row of the warpgroup
    const int r0 = q0 + 16 * w4 + g;     // this thread's rows: r0, r0 + 8
    const int qs = j & 1;
    const bf16* Qw = Qs + qs * QROWS * 64 + 64 * 64 * c;

    float s[64], o[32], m[2], l[2], corr[2];
    uint32_t pa[8][4];   // P_{t-1}, the A operand of P V
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    mbar_wait(q_full + qs, (j / 2) & 1);
    // tile 0: S_0 alone
    {
      const int ks = it % ST;
      mbar_wait(k_full + ks, (it / ST) & 1);
      take_turn();
      issue_scores_128(s, Qw, Ks + ks * TILE);
      hand_over(false);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty + ks);
    }
    softmax_128(s, m, l, corr, 0, Sk, causal, q0, r0, t4, scale_log2);
    pack_p_128(pa, s);
    for (int t = 1; t < n_tiles; ++t) {
      const int ik = it + t, iv = ik - 1;
      const int ks = ik % ST, vs = iv % ST;
      mbar_wait(k_full + ks, (ik / ST) & 1);
      take_turn();
      issue_scores_128(s, Qw, Ks + ks * TILE);
      // O (not in flight) to tile t-1's running max, then P_{t-1} V_{t-1}
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
      mbar_wait(v_full + vs, (iv / ST) & 1);
      issue_pv_128(o, pa, Vs + vs * TILE);
      hand_over(false);
      wgmma_wait<1>();   // S_t is done; P_{t-1} V_{t-1} may still run
      fence_regs(s);
      mbar_arrive(k_empty + ks);
      softmax_128(s, m, l, corr, t * KEYS, Sk, causal, q0, r0, t4,
                  scale_log2);
      wgmma_wait<0>();   // P_{t-1} V_{t-1} is done: o and pa are free
      fence_regs(o);
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) fence_regs(pa[kc]);
      mbar_arrive(v_empty + vs);
      pack_p_128(pa, s);
    }
    mbar_arrive(q_empty + qs);   // every S of this item is done
    // the last tile's P V
    {
      const int iv = it + n_tiles - 1, vs = iv % ST;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
      mbar_wait(v_full + vs, (iv / ST) & 1);
      take_turn();
      issue_pv_128(o, pa, Vs + vs * TILE);
      hand_over(w + static_cast<int>(gridDim.x) >= n_work);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_empty + vs);
    }
    it += n_tiles;

    // this item's output rows: [BH, Sq, 64], or [B, Sq, D] at column h*64
    bf16* obase = out + static_cast<int64_t>(bh) * Sq * 64;
    int64_t ostride = 64;
    if constexpr (FUSED) {
      const int b = bh / heads;
      ostride = static_cast<int64_t>(heads) * 64;
      obase = out + static_cast<int64_t>(b) * Sq * ostride +
              (bh - b * heads) * 64;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = r0 + 8 * h;
      if (row >= Sq) continue;
      bf16* dst = obase + row * ostride + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] / sum,
                                  o[4 * n + 2 * h + 1] / sum);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no libcuda
// link); null where the driver does not have it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 tensor map of `rank` dims (innermost first, strides in bytes of
// dims 1..rank-1) read in boxes `box` with the 128-byte swizzle; what lies
// outside the dims reads as zeros
inline int encode_bf16(CUtensorMap* map, const void* base, cuuint32_t rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the tensor map of bf16 rows [BH, S, 64] read in boxes of `rows` x 64;
// rows past S (and heads past BH) read as zeros
inline int encode_rows(CUtensorMap* map, const void* base, int BH, int S,
                       int rows) {
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {64 * sizeof(bf16),
                                 static_cast<cuuint64_t>(S) * 64 *
                                     sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return encode_bf16(map, base, 3, dims, strides, box);
}

// the tensor map of one column group of fused bf16 rows [B, S, 3D] (base
// at its first column), as {64, heads, S, B}, read in boxes of one head's
// `rows` x 64; rows past S read as zeros
inline int encode_fused_rows(CUtensorMap* map, const void* base, int B,
                             int S, int heads, int rows) {
  const cuuint64_t row = 3ull * heads * 64 * sizeof(bf16);   // bytes
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {64 * sizeof(bf16), row,
                                 static_cast<cuuint64_t>(S) * row};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_bf16(map, base, 4, dims, strides, box);
}

// the kernel's launch on encoded maps: out as FUSED says, BH * Sq items
template <typename Tag, bool FUSED>
int launch_tma(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
               const CUtensorMap& tm_v, void* out, int BH, int Sq, int Sk,
               int causal, int heads, cudaStream_t stream) {
  using Cfg = TmaCfg;
  auto kernel = attention_tma_kernel<Tag, FUSED>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qtiles = (Sq + Cfg::QROWS - 1) / Cfg::QROWS;
  const int64_t n_work = static_cast<int64_t>(n_qtiles) * BH;
  if (n_work > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // one block per SM walking the items, so that an item's loads run under
  // the one before; under the causal mask, whose items differ in length
  // (dealt in turn they left SMs idle), one block per item
  int blocks = static_cast<int>(n_work);
  if (!causal) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = min(blocks, sms);
  }
  // 1/sqrt(64) = 1/8 exactly, folded with log2(e) for exp2
  const float scale = static_cast<float>(1.0 / sqrt(64.0));
  kernel<<<blocks, Cfg::THREADS, Cfg::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), Sq, Sk, causal,
      scale * 1.4426950408889634f, n_qtiles, BH, heads);
  return counted_launch(kTileAttnTma);
}

// bf16 q [BH, Sq, 64], k and v [BH, Sk, 64] -> out [BH, Sq, 64], all
// contiguous and 16-byte aligned, BH, Sq and Sk positive, causal only when
// Sq == Sk (the caller checks).  Returns the first CUDA error, or 0.
template <typename Tag>
int launch_attention_tma(const void* q, const void* k, const void* v,
                         void* out, int BH, int Sq, int Sk, int causal,
                         cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_rows(&tm_q, q, BH, Sq, TmaCfg::QROWS);
  if (!err) err = encode_rows(&tm_k, k, BH, Sk, TmaCfg::KEYS);
  if (!err) err = encode_rows(&tm_v, v, BH, Sk, TmaCfg::KEYS);
  if (err) return err;
  return launch_tma<Tag, false>(tm_q, tm_k, tm_v, out, BH, Sq, Sk, causal,
                                1, stream);
}

// bf16 qkv [B, S, 3 * heads * 64] -> out [B, S, heads * 64], non-causal,
// both contiguous and 16-byte aligned, B, S and heads positive (the
// caller checks).  Returns the first CUDA error, or 0.
template <typename Tag>
int launch_fused_qkv_tma(const void* qkv, void* out, int B, int S,
                         int heads, cudaStream_t stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const int64_t D = static_cast<int64_t>(heads) * 64;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_fused_rows(&tm_q, q, B, S, heads, TmaCfg::QROWS);
  if (!err) err = encode_fused_rows(&tm_k, q + D, B, S, heads, TmaCfg::KEYS);
  if (!err)
    err = encode_fused_rows(&tm_v, q + 2 * D, B, S, heads, TmaCfg::KEYS);
  if (err) return err;
  const int64_t BH = static_cast<int64_t>(B) * heads;
  if (BH > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tma<Tag, true>(tm_q, tm_k, tm_v, out, static_cast<int>(BH),
                               S, S, 0, heads, stream);
}

}  // namespace tc
}  // namespace
