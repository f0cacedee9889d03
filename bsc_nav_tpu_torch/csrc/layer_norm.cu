// K7: row LayerNorm with affine parameters over the last axis, f32
// statistics, x [rows, D] -> y [rows, D] in x's dtype.
//
// Replaces: bsc_nav_tpu/ops/layernorm.py `layer_norm_tpu` (`_ln_kernel`).
// The JAX package dispatches it nowhere (a measured negative on the TPU);
// the port keeps it as an op, dispatched nowhere either, and measures it
// against F.layer_norm at ViT-L's token grids ([8 | 32, 261, 1024]).
//
// Bound on the H100: bytes.  Each element is read once and written once
// (8 bytes per element in f32, 4 in bf16, ~8 flops), far below the ~20
// flops per byte where the CUDA cores' f32 rate would take over.  At
// [8, 261, 1024] the bytes take 5.1 us (f32) and 2.6 us (bf16) at 3.35
// TB/s, so the launch, one round trip to device memory and the warp
// reductions are most of a call: the design keeps each row to one read
// and one write in as few instructions as it can.
//
// Design: the TPU kernel normalises a [256, D] block of rows held in VMEM
// and needs D % 128 == 0.  Here one warp owns one row, kWarps rows per
// block (4: [8, 261, 1024]'s 2,088 rows make 522 blocks, ~4 per SM on
// 132 SMs, all resident at once).  The vector path (`NV` > 0, chosen at
// compile time for the common widths) reads the row once with 16-byte
// loads -- lane l holds elements [(c * 32 + l) * E, +E) of chunk c, E = 4
// f32 or 8 bf16 -- and keeps it in registers (32 f32 per lane at D 1024):
// the mean, then the variance as the mean of (x - mean)^2 from those
// registers (the TPU kernel's two-pass statistics, no one-pass
// E[x^2] - mean^2, which cancels for rows of large mean), then
// (x - mean) * rsqrt(var + eps) * gamma + beta with gamma and beta read
// as float4 and y written with 16-byte stores.  NV chunks of 32 * E
// elements cover D; a chunk past D is masked, so one instantiation serves
// every D up to NV * 32 * E that is a multiple of E.  Any other D, a row
// or pointer not 16-byte aligned, or a D past 4,096 (128 f32 registers a
// lane) takes the generic path (`NV` = 0): the same statistics over
// scalar loads, three passes over the row, the second and third from L1.
// All arithmetic is f32; gamma and beta are f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // rows per block, one warp per row

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T <-> E = 16 / sizeof(T) floats
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y,
                      int64_t rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  if constexpr (NV == 0) {
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s += to_f(xr[i]);
    const float mu = warp_sum(s) / D;
    float ss = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float d = to_f(xr[i]) - mu;
      ss = fmaf(d, d, ss);
    }
    const float rstd = rsqrtf(warp_sum(ss) / D + eps);
    for (int i = lane; i < D; i += 32)
      put(yr + i, (to_f(xr[i]) - mu) * rstd * g[i] + b[i]);
  } else {
    constexpr int E = 16 / sizeof(T);
    float v[NV][E];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * 32 + lane) * E;
      if (col < D) {
        load16(xr + col, v[c]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[c][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[c][e];
    }
    const float mu = warp_sum(s) / D;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if ((c * 32 + lane) * E < D) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = v[c][e] - mu;
          ss = fmaf(d, d, ss);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * 32 + lane) * E;
      if (col < D) {
        float gv[E], bv[E];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          load16(g + col + e, *reinterpret_cast<float(*)[4]>(gv + e));
          load16(b + col + e, *reinterpret_cast<float(*)[4]>(bv + e));
        }
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[c][e] = (v[c][e] - mu) * rstd * gv[e] + bv[e];
        store16(yr + col, v[c]);
      }
    }
  }
}

template <typename T, int NV>
int launch_nv(const void* x, const void* g, const void* b, void* y,
              int64_t rows, int D, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_kernel<T, NV><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(y), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// The vector path at the least instantiated chunk count that covers D, or
// the generic path.
template <typename T>
int launch(const void* x, const void* g, const void* b, void* y,
           int64_t rows, int D, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kMaxNV = 128 / E;   // 128 f32 registers a lane
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(b);
  const int chunks = (D + 32 * E - 1) / (32 * E);
  const bool vec = D % E == 0 && addr % 16 == 0 && chunks <= kMaxNV;
  if (!vec) return launch_nv<T, 0>(x, g, b, y, rows, D, eps, stream);
  if (chunks <= 1) return launch_nv<T, 1>(x, g, b, y, rows, D, eps, stream);
  if (chunks <= 2) return launch_nv<T, 2>(x, g, b, y, rows, D, eps, stream);
  if (chunks <= 4) return launch_nv<T, 4>(x, g, b, y, rows, D, eps, stream);
  if (chunks <= 8) return launch_nv<T, 8>(x, g, b, y, rows, D, eps, stream);
  if (chunks <= 16)
    return launch_nv<T, 16>(x, g, b, y, rows, D, eps, stream);
  if constexpr (kMaxNV >= 32)
    return launch_nv<T, 32>(x, g, b, y, rows, D, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [rows, D] contiguous, f32 (or bf16 when is_bf16); gamma, beta [D] f32;
// y like x.  Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int layer_norm_launch(const void* x, const void* gamma,
                                 const void* beta, void* y, long long rows,
                                 int D, float eps, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, rows, D, eps, s);
  return launch<float>(x, gamma, beta, y, rows, D, eps, s);
}
