// The f32 attention kernel on the CUDA cores shared by K5 mid_attention
// and K6 flash_attention: softmax attention over separate f32 q, k, v
// buffers [BH, S, hd] with an optional square causal mask, written to
// [BH, Sq, hd].  Their bf16 paths run the tensor-core tile of
// attention_mma.cuh instead.  K3's f32 path moved to the tensor cores
// (attention_tf32.cuh): three TF32 products per f32 product keep the f32
// paths' 2e-5 bound, which one TF32 product (a 10-bit mantissa) misses;
// K5 and K6 in f32 are launched by no main path and stay here.  Each of
// those sources includes this header, names its kernel with a tag type
// (so a profiler tells them apart) and exports its own launch symbol;
// the header's names have internal linkage, so every source holds its own
// copy of the kernels it instantiates.
//
// Design: the TPU kernels hold K/V in VMEM -- the whole sequence (K5) or
// blocks of 128 keys (K6) -- and run a one-shot or a blockwise online
// softmax.  Here each block owns one (batch*head) and 8 * ROWS query rows
// (8 warps x ROWS rows) and streams K/V through shared memory in tiles of
// 64 keys with an online softmax, so any Sk fits; larger ROWS reuses each
// K/V tile for more query rows.  The grid is one-dimensional (q tile
// fastest, so consecutive blocks share their K/V in L2), which takes any
// B*H.  Under the causal mask a block stops at the tile holding its last
// query row, a warp skips the arithmetic of a tile wholly past its rows (it
// still helps load it), and the heaviest q tiles are scheduled first.
// Ragged edges on both sides are masked (the kv_len mask), never padded in
// device memory.  q is scaled by 1/sqrt(hd) in f32 before the dot, as the
// TPU kernels do.  Lane j owns keys j and j+32 of a tile for the scores and
// dims j, j+32, j+64, j+96 of a row for the output, so hd 80 runs 3 output
// slots with lanes 16-31 idle in the last one.  Rows are read as 16-byte
// vectors: hd % 16 == 0 keeps every row start aligned.  K/V tile rows are
// padded to hd + 4 floats, which keeps the lanes' 16-byte reads free of
// bank conflicts at hd 64 and 80.  All arithmetic is f32 on the CUDA cores.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kKeys = 64;   // keys per shared-memory tile

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  float acc = a.x * b.x;
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float get(const float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int ROWS>
size_t attention_smem_bytes(int hd) {
  const int ld = hd + 4;
  return sizeof(float) *
         (2 * kKeys * ld + kWarps * ROWS * hd + kWarps * ROWS * kKeys);
}

// Tag names the kernel; NI = ceil(hd / 32): output dims each lane owns;
// ROWS: query rows per warp.
template <typename Tag, int NI, int ROWS>
__global__ void __launch_bounds__(kWarps * 32)
    attention_tile_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out,
                          int Sq, int Sk, int hd, int causal, float scale,
                          int n_qtiles) {
  constexpr int kQTile = kWarps * ROWS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  float* Ks = smem;                    // [kKeys][ld]
  float* Vs = Ks + kKeys * ld;         // [kKeys][ld]
  float* Qs = Vs + kKeys * ld;         // [kWarps][ROWS][hd]
  float* Ps = Qs + kQTile * hd;        // [kWarps][ROWS][kKeys]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t bh = blockIdx.x / n_qtiles;
  int qt = static_cast<int>(blockIdx.x - bh * n_qtiles);
  if (causal) qt = n_qtiles - 1 - qt;  // the longest key ranges first
  const int qb = qt * kQTile;          // first query row of the block
  const int q0 = qb + warp * ROWS;     // first query row of the warp
  const float* qbase = q + bh * Sq * hd;
  const float* kbase = k + bh * Sk * hd;
  const float* vbase = v + bh * Sk * hd;
  const int hd4 = hd / 4;

  float* Qw = Qs + warp * ROWS * hd;
  for (int i = lane; i < ROWS * hd4; i += 32) {
    const int r = i / hd4, c = i - (i / hd4) * hd4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = load4(qbase + static_cast<int64_t>(q0 + r) * hd + 4 * c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    reinterpret_cast<float4*>(Qw + r * hd)[c] = x;
  }
  float* Pw = Ps + warp * ROWS * kKeys;

  float m[ROWS], l[ROWS], acc[ROWS][NI];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  // causal: no row of this block sees a key past its last row
  const int k_end = causal ? min(Sk, qb + kQTile) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; Qs is written
    for (int i = threadIdx.x; i < kKeys * hd4; i += blockDim.x) {
      const int j = i / hd4, c = i - (i / hd4) * hd4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < Sk) {
        const int64_t off = static_cast<int64_t>(k0 + j) * hd + 4 * c;
        kx = load4(kbase + off);
        vx = load4(vbase + off);
      }
      reinterpret_cast<float4*>(Ks + j * ld)[c] = kx;
      reinterpret_cast<float4*>(Vs + j * ld)[c] = vx;
    }
    __syncthreads();
    if (causal && k0 > q0 + ROWS - 1) continue;  // wholly masked for us
    const int nk = min(kKeys, Sk - k0);

    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(Ks + lane * ld);
    const float4* kb = reinterpret_cast<const float4*>(Ks + (lane + 32) * ld);
#pragma unroll 4
    for (int c = 0; c < hd4; ++c) {
      const float4 a = ka[c], bb = kb[c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(Qw + r * hd)[c];
        s[r][0] += dot4(qv, a);
        s[r][1] += dot4(qv, bb);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int ja = k0 + lane, jb = k0 + lane + 32;
      const int qi = q0 + r;
      const bool va = lane < nk && (!causal || ja <= qi);
      const bool vb = lane + 32 < nk && (!causal || jb <= qi);
      const float sa = va ? s[r][0] : -INFINITY;
      const float sb = vb ? s[r][1] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      // a row with no live key yet keeps m = -inf: no update, no NaN
      const bool live = m_new != -INFINITY;
      const float corr = live ? expf(m[r] - m_new) : 1.f;
      const float pa = va ? expf(sa - m_new) : 0.f;
      const float pb = vb ? expf(sb - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= corr;
      Pw[r * kKeys + lane] = pa;
      Pw[r * kKeys + lane + 32] = pb;
    }
    __syncwarp();

    // keys past nk have p == 0 and zero-filled V rows, so whole groups of 4
    for (int j = 0; j < nk; j += 4) {
      float4 p4[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        p4[r] = reinterpret_cast<const float4*>(Pw + r * kKeys)[j >> 2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * ld;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          const float x = d < hd ? vrow[d] : 0.f;
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r][i] = fmaf(get(p4[r], jj), x, acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    float* dst = out + (bh * Sq + qi) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) dst[d] = acc[r][i] / l[r];
    }
  }
}

template <typename Tag, int NI, int ROWS>
int launch_tile(const void* q, const void* k, const void* v, void* out,
                int BH, int Sq, int Sk, int hd, int causal,
                cudaStream_t stream) {
  constexpr int kQTile = kWarps * ROWS;
  const size_t smem = attention_smem_bytes<ROWS>(hd);
  auto kernel = attention_tile_kernel<Tag, NI, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (Sq + kQTile - 1) / kQTile;
  const int64_t blocks = static_cast<int64_t>(n_qtiles) * BH;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // the scale rounded once from double, as JAX rounds its Python float
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, hd,
      causal, scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

// f32 q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], all
// contiguous and 16-byte aligned, ROWS query rows per warp; the arguments
// pass attention_args_ok (the caller checks).  Returns the first CUDA
// error, or 0.
template <typename Tag, int ROWS>
int launch_attention(const void* q, const void* k, const void* v, void* out,
                     int BH, int Sq, int Sk, int hd, int causal,
                     cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch_tile<Tag, 1, ROWS>(q, k, v, out, BH, Sq, Sk, hd,
                                             causal, s);
    case 2: return launch_tile<Tag, 2, ROWS>(q, k, v, out, BH, Sq, Sk, hd,
                                             causal, s);
    case 3: return launch_tile<Tag, 3, ROWS>(q, k, v, out, BH, Sq, Sk, hd,
                                             causal, s);
    case 4: return launch_tile<Tag, 4, ROWS>(q, k, v, out, BH, Sq, Sk, hd,
                                             causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
