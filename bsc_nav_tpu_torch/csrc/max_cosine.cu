// K2: fused store scan -- per voxel, the max cosine between the query and
// the voxel's live cached tokens.
//
// Replaces: bsc_nav_tpu/ops/similarity.py `_row_cosines_pallas`
// (`_sim_kernel`), reached by `max_cosine_per_voxel`, plus the per-voxel
// max that the JAX package runs as a separate reduce over the [V1*K]
// row cosines.
//
// Bound on the H100: device memory.  A scan reads each live row once,
// V1*K*D*itemsize bytes for a full store (5.37 GB f32 / 2.68 GB bf16 at
// the agent's default V1 = 131,080, K = 10, D = 1024, reckoned from the
// shapes), and does 2 flops per byte of f32 -- far below the card's
// compute roofline.
//
// Design: one warp per voxel.  The query (f32) sits in shared memory; the
// warp streams its voxel's rows with 16-byte loads, neighbouring lanes on
// neighbouring addresses, reduces each dot in f32 with shuffles, divides
// by the stored norm, and keeps the running max in a register, so the
// [V1*K] row cosines never reach device memory.  Rows at k >= count[v]
// are never read: masked_norms marks them -inf, and skipping their bytes
// is the only saving a memory-bound scan has.  Any V1 is accepted; the
// grid's ragged edge is masked here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes of a row dotted with the matching query slice.
__device__ __forceinline__ float chunk_dot(const float* row, const float* q) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = *reinterpret_cast<const float4*>(q);
  float acc = a.x * b.x;
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float chunk_dot(const __nv_bfloat16* row,
                                           const float* q) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]);
  const float2 f3 = __bfloat1622float2(h[3]);
  float acc = f0.x * q0.x;
  acc = fmaf(f0.y, q0.y, acc);
  acc = fmaf(f1.x, q0.z, acc);
  acc = fmaf(f1.y, q0.w, acc);
  acc = fmaf(f2.x, q1.x, acc);
  acc = fmaf(f2.y, q1.y, acc);
  acc = fmaf(f3.x, q1.z, acc);
  return fmaf(f3.y, q1.w, acc);
}

template <typename T>
struct ElemsPer16B;
template <>
struct ElemsPer16B<float> {
  static constexpr int value = 4;
};
template <>
struct ElemsPer16B<__nv_bfloat16> {
  static constexpr int value = 8;
};

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    max_cosine_kernel(const T* __restrict__ feats,
                      const float* __restrict__ norms,
                      const int* __restrict__ counts,
                      const float* __restrict__ q, float* __restrict__ out,
                      int V1, int K, int D) {
  extern __shared__ float4 q_smem4[];
  float* qs = reinterpret_cast<float*>(q_smem4);
  for (int i = threadIdx.x; i < D; i += blockDim.x) qs[i] = q[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (v >= V1) return;

  constexpr int N = ElemsPer16B<T>::value;
  const int chunks = D / N;
  const int n = min(counts[v], K);
  float best = -INFINITY;
  for (int k = 0; k < n; ++k) {
    const int64_t row = v * K + k;
    const T* r = feats + row * D;
    float acc = 0.f;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) acc += chunk_dot(r + c * N, qs + c * N);
    acc = warp_sum(acc);
    best = fmaxf(best, acc / fmaxf(norms[row], 1e-12f));
  }
  if (lane == 0) out[v] = best;
}

}  // namespace

// feats [V1*K, D] (f32, or bf16 when is_bf16), norms [V1*K] f32,
// counts [V1] int32, q [D] f32 -> out [V1] f32.  D % 8 == 0, pointers
// 16-byte aligned.  Launches on `stream`; returns cudaGetLastError().
extern "C" int max_cosine_per_voxel_launch(const void* feats,
                                           const void* norms,
                                           const void* counts, const void* q,
                                           void* out, int V1, int K, int D,
                                           int is_bf16, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((V1 + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    max_cosine_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<const float*>(norms), static_cast<const int*>(counts),
        static_cast<const float*>(q), static_cast<float*>(out), V1, K, D);
  } else {
    max_cosine_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(norms),
        static_cast<const int*>(counts), static_cast<const float*>(q),
        static_cast<float*>(out), V1, K, D);
  }
  return static_cast<int>(cudaGetLastError());
}
