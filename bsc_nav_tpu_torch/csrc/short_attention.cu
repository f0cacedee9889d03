// K3: softmax attention over separate q, k, v buffers [BH, S, hd], with an
// optional square causal mask, written to [BH, Sq, hd].
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `short_attention`
// (`_short_kernel`), reached from `attention()` for every sequence of at
// most 640 keys that the fused-QKV kernel does not take: both CLIP towers
// (MetaCLIP ViT-H vision, 16 heads x 80, S = 257; text, 16 heads x 64,
// S = 77, causal) and the SD3 CLIP text encoders.
//
// Bound on the H100: arithmetic.  The vision tower at B = 12 is
// 4*B*H*S^2*hd = 4.1 GFLOP per layer against 9.5 MB of q, k, v and out
// in f32 -- ~430 flops per byte -- and this kernel runs them on the CUDA
// cores in f32 (67 TFLOP/s peak), not on the tensor cores.
//
// Design: the TPU kernel holds a whole (batch, head) in VMEM and runs one
// softmax over it.  Here each block owns one (batch*head) and 32 query
// rows (8 warps x 4 rows) and streams K/V through shared memory in tiles
// of 64 keys with an online softmax (any Sk), as K1 does, but reads three
// contiguous buffers instead of column groups of the fused projection.
// Under the causal mask a block stops at the tile holding its last query
// row, and a warp skips the arithmetic of a tile that lies wholly past its
// own 4 rows (it still helps load it).  Ragged edges on both sides -- the
// last q tile and the last key tile at S = 77 or 257 -- are masked, never
// padded in device memory.  q is scaled by 1/sqrt(hd) in f32 before the
// dot, as the TPU kernel does.  Lane j owns keys j and j+32 of a tile for
// the scores and dims j, j+32, j+64, j+96 of a row for the output, so
// hd 80 runs 3 output slots with lanes 16-31 idle in the last one.  Rows
// are read as 16-byte f32 (8-byte bf16) vectors: hd % 16 == 0 keeps every
// row start aligned.  K/V tile rows are padded to hd + 4 floats, which
// keeps the lanes' 16-byte reads free of bank conflicts at hd 64 and 80.
// All accumulation is f32; inputs and outputs are f32 or bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per block
constexpr int kRows = 4;                // query rows per warp
constexpr int kQTile = kWarps * kRows;  // query rows per block
constexpr int kKeys = 64;               // keys per shared-memory tile

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

size_t smem_bytes(int hd) {
  const int ld = hd + 4;
  return sizeof(float) *
         (2 * kKeys * ld + kQTile * hd + kQTile * kKeys);
}

// NI = ceil(hd / 32): output dims each lane owns.
template <typename T, int NI>
__global__ void __launch_bounds__(kWarps * 32)
    short_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int hd, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  float* Ks = smem;                    // [kKeys][ld]
  float* Vs = Ks + kKeys * ld;         // [kKeys][ld]
  float* Qs = Vs + kKeys * ld;         // [kWarps][kRows][hd]
  float* Ps = Qs + kQTile * hd;        // [kWarps][kRows][kKeys]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t bh = blockIdx.y;
  const int qb = blockIdx.x * kQTile;  // first query row of the block
  const int q0 = qb + warp * kRows;    // first query row of the warp
  const T* qbase = q + bh * Sq * hd;
  const T* kbase = k + bh * Sk * hd;
  const T* vbase = v + bh * Sk * hd;
  const int hd4 = hd / 4;

  float* Qw = Qs + warp * kRows * hd;
  for (int i = lane; i < kRows * hd4; i += 32) {
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
  float* Pw = Ps + warp * kRows * kKeys;

  float m[kRows], l[kRows], acc[kRows][NI];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
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
    if (causal && k0 > q0 + kRows - 1) continue;  // wholly masked for us
    const int nk = min(kKeys, Sk - k0);

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(Ks + lane * ld);
    const float4* kb = reinterpret_cast<const float4*>(Ks + (lane + 32) * ld);
#pragma unroll 4
    for (int c = 0; c < hd4; ++c) {
      const float4 a = ka[c], bb = kb[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(Qw + r * hd)[c];
        s[r][0] += dot4(qv, a);
        s[r][1] += dot4(qv, bb);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
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
      float4 p4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p4[r] = reinterpret_cast<const float4*>(Pw + r * kKeys)[j >> 2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * ld;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          const float x = d < hd ? vrow[d] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][i] = fmaf(get(p4[r], jj), x, acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    T* dst = out + (bh * Sq + qi) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store1(dst + d, acc[r][i] / l[r]);
    }
  }
}

template <typename T, int NI>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int hd, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = short_attention_kernel<T, NI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kQTile - 1) / kQTile, BH);
  // the scale rounded once from double, as JAX rounds its Python float
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, hd, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int BH,
              int Sq, int Sk, int hd, int causal, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, BH, Sq, Sk, hd, causal, stream);
    case 2: return launch<T, 2>(q, k, v, out, BH, Sq, Sk, hd, causal, stream);
    case 3: return launch<T, 3>(q, k, v, out, BH, Sq, Sk, hd, causal, stream);
    case 4: return launch<T, 4>(q, k, v, out, BH, Sq, Sk, hd, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], all contiguous
// and 16-byte aligned, f32 (or bf16 when is_bf16).  hd % 16 == 0 and
// hd <= 128; causal needs Sq == Sk.  Launches on `stream`; returns the
// first CUDA error, or 0.
extern "C" int short_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int hd, int causal,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || hd % 16 || hd > 128 ||
      (causal && Sq != Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, hd, causal, s);
  return launch_hd<float>(q, k, v, out, BH, Sq, Sk, hd, causal, s);
}
