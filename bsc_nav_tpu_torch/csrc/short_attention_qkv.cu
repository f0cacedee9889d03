// K1: non-causal softmax attention read straight from the fused qkv
// projection [B, S, 3*D] (q | k | v column groups, heads contiguous in
// each group), written to [B, S, D].
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `short_attention_qkv`
// (`_qkv_kernel_3in`), dispatched by `attention_from_qkv` in every ViT
// layer.
//
// Bound on the H100: arithmetic.  At the ViT-L shapes (S = 261, 16 heads
// x 64) one layer at B = 8 is 4*B*H*S^2*hd = 2.2 GFLOP against 8.7 MB of
// qkv read once -- ~250 flops per byte, and this kernel runs them on the
// CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores.
//
// Design: the TPU kernel keeps all of K and V resident; a block here
// cannot (f32 K+V at S = 640, hd 64 is 327 KB, over the 227 KB a block
// may use).  Instead each block owns one (batch, head) and 32 query rows
// (8 warps x 4 rows) and streams K/V through shared memory in tiles of 64
// keys with an online softmax, so S is unbounded.  Heads are read by
// column offset h*hd, D + h*hd, 2D + h*hd with row stride 3D: no
// transposes and no separate q/k/v buffers, which is what the TPU kernel
// saves too.  Each warp keeps its 4 query rows (pre-scaled by 1/sqrt(hd))
// in shared memory and reuses every K/V element it loads across the 4
// rows.  Scores: lane j owns keys j and j+32 of the tile.  Output: lane j
// owns dims j, j+32, ... of each row.  All accumulation is f32; inputs
// and outputs are f32 or bf16.  K/V tile rows are padded to hd+4 floats,
// which keeps the lanes' 16-byte row reads free of bank conflicts.
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
    short_attention_qkv_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                               int S, int D, int hd, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  float* Ks = smem;                    // [kKeys][ld]
  float* Vs = Ks + kKeys * ld;         // [kKeys][ld]
  float* Qs = Vs + kKeys * ld;         // [kWarps][kRows][hd]
  float* Ps = Qs + kQTile * hd;        // [kWarps][kRows][kKeys]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kQTile + warp * kRows;
  const int64_t row_stride = 3LL * D;
  const T* base = qkv + static_cast<int64_t>(b) * S * row_stride +
                  static_cast<int64_t>(h) * hd;
  const int hd4 = hd / 4;

  float* Qw = Qs + warp * kRows * hd;
  for (int i = lane; i < kRows * hd4; i += 32) {
    const int r = i / hd4, c = i - (i / hd4) * hd4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      v = load4(base + (q0 + r) * row_stride + 4 * c);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    reinterpret_cast<float4*>(Qw + r * hd)[c] = v;
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

  for (int k0 = 0; k0 < S; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; Qs is written
    for (int i = threadIdx.x; i < kKeys * hd4; i += blockDim.x) {
      const int j = i / hd4, c = i - (i / hd4) * hd4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + j < S) {
        const T* src = base + (k0 + j) * row_stride + 4 * c;
        kv = load4(src + D);
        vv = load4(src + 2 * D);
      }
      reinterpret_cast<float4*>(Ks + j * ld)[c] = kv;
      reinterpret_cast<float4*>(Vs + j * ld)[c] = vv;
    }
    __syncthreads();
    const int nk = min(kKeys, S - k0);

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
      const float sa = lane < nk ? s[r][0] : -INFINITY;
      const float sb = lane + 32 < nk ? s[r][1] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float corr = expf(m[r] - m_new);
      const float pa = expf(sa - m_new), pb = expf(sb - m_new);
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
          const float v = d < hd ? vrow[d] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][i] = fmaf(get(p4[r], jj), v, acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r;
    if (qi >= S) continue;
    T* dst = out + (static_cast<int64_t>(b) * S + qi) * D +
             static_cast<int64_t>(h) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store1(dst + d, acc[r][i] / l[r]);
    }
  }
}

template <typename T, int NI>
int launch(const void* qkv, void* out, int B, int S, int heads, int hd,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = short_attention_qkv_kernel<T, NI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kQTile - 1) / kQTile, heads, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), S, heads * hd, hd,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* qkv, void* out, int B, int S, int heads, int hd,
              cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(qkv, out, B, S, heads, hd, stream);
    case 2: return launch<T, 2>(qkv, out, B, S, heads, hd, stream);
    case 3: return launch<T, 3>(qkv, out, B, S, heads, hd, stream);
    case 4: return launch<T, 4>(qkv, out, B, S, heads, hd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qkv [B, S, 3*heads*hd] -> out [B, S, heads*hd], both contiguous, f32
// (or bf16 when is_bf16).  hd % 16 == 0 and hd <= 128.  Launches on
// `stream`; returns the first CUDA error, or 0.
extern "C" int short_attention_qkv_launch(const void* qkv, void* out, int B,
                                          int S, int heads, int hd,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_hd<__nv_bfloat16>(qkv, out, B, S, heads, hd, s);
  return launch_hd<float>(qkv, out, B, S, heads, hd, s);
}
