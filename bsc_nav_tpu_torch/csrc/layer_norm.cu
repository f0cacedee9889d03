// K7: row LayerNorm with affine parameters over the last axis, f32
// statistics, x [rows, D] -> y [rows, D] in x's dtype.
//
// Replaces: bsc_nav_tpu/ops/layernorm.py `layer_norm_tpu` (`_ln_kernel`).
// The JAX package dispatches it nowhere (a measured negative on the TPU);
// the port keeps it as an op, dispatched nowhere either, and measures it
// against F.layer_norm at ViT-L's token grids ([8 | 32, 261, 1024]).
//
// Bound on the H100: bytes.  Each element is read once and written once
// (8 bytes per element in f32, ~8 flops), far below the ~20 flops per byte
// where the CUDA cores' f32 rate would take over.
//
// Design: the TPU kernel normalises a [256, D] block of rows held in VMEM
// and needs D % 128 == 0.  Here one warp owns one row of any D, 8 rows per
// block.  The statistics follow the TPU kernel: the mean, then the
// variance as the mean of (x - mean)^2 in a second pass (no one-pass
// E[x^2] - mean^2, which cancels for rows of large mean), then
// (x - mean) * rsqrt(var + eps) * gamma + beta.  The three passes read the
// row from device memory once; the second and third find it in L1 (a
// warp's row is 4 KB at D 1024 in f32).  Loads are coalesced across the
// warp's lanes; all arithmetic is f32; gamma and beta are f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;   // one warp per row

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

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y,
                      int64_t rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = to_f(xr[i]) - mu;
    ss = fmaf(d, d, ss);
  }
  const float rstd = rsqrtf(warp_sum(ss) / D + eps);
  T* yr = y + row * D;
  for (int i = lane; i < D; i += 32)
    put(yr + i, (to_f(xr[i]) - mu) * rstd * g[i] + b[i]);
}

template <typename T>
int launch(const void* x, const void* g, const void* b, void* y,
           int64_t rows, int D, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_kernel<T><<<static_cast<unsigned>(blocks), kRowsPerBlock * 32,
                         0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(y), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
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
