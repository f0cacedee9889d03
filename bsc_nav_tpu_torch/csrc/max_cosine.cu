// K2: fused store scan -- per voxel, the max cosine between the query and
// the voxel's live cached tokens -- and its Q-query form.
//
// Replaces: bsc_nav_tpu/ops/similarity.py `_row_cosines_pallas`
// (`_sim_kernel`), reached by `max_cosine_per_voxel`, plus the per-voxel
// max that the JAX package runs as a separate reduce over the [V1*K]
// row cosines; and, in `max_cosine_batch_*`, the XLA einsums of
// `max_cosine_per_voxel_batch` (Q queries, one pass) and of
// `reference_row_cosines` for int8 rows, which the JAX package takes
// instead of its kernel.
//
// Bound on the H100: device memory for one query.  A scan reads each live
// row once, V1*K*D*itemsize bytes for a full store (5.37 GB f32 / 2.68 GB
// bf16 / 1.34 GB int8 at the agent's default V1 = 131,080, K = 10,
// D = 1024, reckoned from the shapes), and does 2 flops per element.  With
// Q queries it does 2*Q flops per element: at Q = 16 on int8 rows, 32
// flops per byte, which the bf16 tensor cores would take within the
// bytes' time but the CUDA cores' f32 FMAs, which this kernel uses, do
// not.
//
// Design: one warp per voxel.  The f32 query sits in shared memory; the
// warp streams its voxel's rows with 16-byte loads (4 f32 or 8 bf16
// values), neighbouring lanes on neighbouring addresses, widens them to
// f32, reduces each dot in f32 with shuffles, divides by the stored norm,
// and keeps the running max in a register, so the [V1*K] row cosines never
// reach device memory.  Rows at k >= count[v] are never read: masked_norms
// marks them -inf, and skipping their bytes is the only saving a
// memory-bound scan has.  Any V1 is accepted; the ragged edge is masked
// here.
//
// int8 rows hold per-row absmax codes whose scale cancels in the cosine
// (feat_norm is the int8 row's norm), so neither kernel reads feat_scale.
// A single query on int8 rows is the Q-query kernel at Q = 1: it rounds
// the query to bf16 as the JAX einsum does (`q.astype(jnp.bfloat16)`), and
// every product of an int8 value and a bf16 value is exact in f32.
//
// The Q-query kernel keeps up to 16 queries in shared memory (64 KB at
// D = 1024 in f32, past the 48 KB default: opted in per instance), reads
// each live row once and dots it with every query.  Its queries are rounded
// to the store dtype first (bf16 for int8), the JAX batch semantics
// (`qs.astype(feats.dtype)`), where the single-query kernel keeps f32
// queries as the TPU kernel does.  A warp takes its voxel's rows 4 at a
// time, so that one shared-memory read of a query slice feeds 4 rows
// (shared-memory traffic Q * D * 4 bytes per 4 rows, laid out so that a
// warp's reads are conflict-free).  A reduce-scatter of the 4 x Q dots
// over the warp, every index a compile-time constant so that nothing
// leaves the registers, leaves each lane 4 Q / 32 of them to divide and
// max: a full shuffle reduction of every dot cost more than the FMAs at
// Q = 16.  Blocks are persistent (a grid the size of the card's resident
// blocks walks the voxels), so the queries are copied into shared memory
// once per block, not once per 8 voxels.  At Q = 16 the design is bound
// by the CUDA cores' FMAs, which a tensor-core form would lift.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBatchRows = 4;          // rows a warp dots at once (R)
constexpr int kMaxBatchQueries = 16;

enum StoreDtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// Four int8 codes packed in a 32-bit word, widened to f32 (exact).
__device__ __forceinline__ float4 widen_s8x4(uint32_t w) {
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
struct Elems;
template <>
struct Elems<float> {
  static constexpr int per16B = 4;
};
template <>
struct Elems<__nv_bfloat16> {
  static constexpr int per16B = 8;
};
template <>
struct Elems<int8_t> {
  static constexpr int per16B = 16;
};

// The query as the Q-query kernel holds it: rounded to the store dtype,
// bf16 for int8 rows (the JAX batch einsum's operands).
template <typename T>
__device__ __forceinline__ float batch_q(float x) {
  return bf16_round(x);
}
template <>
__device__ __forceinline__ float batch_q<float>(float x) {
  return x;
}

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

  constexpr int N = Elems<T>::per16B;
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

// ---------------------------------------------------------------------------
// Q-query scan
// ---------------------------------------------------------------------------

// The 16 bytes at `p` (row chunk c of a live row), or zeros.
__device__ __forceinline__ uint4 load16(const void* p, bool live) {
  return live ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0u, 0u, 0u, 0u);
}

// Sub-chunk s (4 values) of a 16-byte row chunk, widened to f32.
template <typename T>
__device__ __forceinline__ float4 widen4(const uint4& raw, int s);
template <>
__device__ __forceinline__ float4 widen4<float>(const uint4& raw, int) {
  return make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                     __uint_as_float(raw.z), __uint_as_float(raw.w));
}
template <>
__device__ __forceinline__ float4 widen4<__nv_bfloat16>(const uint4& raw,
                                                        int s) {
  const uint32_t a = s == 0 ? raw.x : raw.z;
  const uint32_t b = s == 0 ? raw.y : raw.w;
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}
template <>
__device__ __forceinline__ float4 widen4<int8_t>(const uint4& raw, int s) {
  return widen_s8x4(s == 0 ? raw.x : s == 1 ? raw.y : s == 2 ? raw.z : raw.w);
}

// Reduce-scatter of the per-lane partial sums a[0..M) over the warp (xor
// offsets K = 16, 8, 4, 2, 1): while more than one value is left, each
// lane keeps half of them, adds its partner's copies and passes the other
// half on, so that afterwards each lane holds max(M0 / 32, 1) complete
// sums (``scatter_slots`` says which) in a[0..]: M0 - 1 shuffles where a
// full reduction of each sum takes 5 M0, and max(M0 / 32, 1) divisions a
// lane where it takes M0.  Every index is a compile-time constant, so the
// array stays in registers.
template <int M0, int M, int K>
__device__ __forceinline__ void reduce_scatter(float (&a)[M0], int lane) {
  if constexpr (M > 1) {
    constexpr int H = M / 2;
    const bool up = lane & K;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? a[i] : a[i + H];
      const float keep = up ? a[i + H] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, K);
    }
    if constexpr (K > 1) reduce_scatter<M0, H, K / 2>(a, lane);
  } else {
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], K);
    if constexpr (K > 1) reduce_scatter<M0, 1, K / 2>(a, lane);
  }
}

// The first of the consecutive sums `lane` holds after reduce_scatter,
// and the lane bits whose partners hold copies of the same sums.
template <int M>
__device__ __forceinline__ void scatter_slots(int lane, int& first,
                                              int& dup) {
  first = dup = 0;
  int m = M;
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1) {
    if (m > 1) {
      m >>= 1;
      if (lane & k) first += m;
    } else {
      dup |= k;
    }
  }
}

// out [nq, V1]: out[j * V1 + v] = max over v's live rows of
// dot(row, q_j) / max(norm, 1e-12), -inf for an empty voxel.  NQ >= nq
// queries sit in shared memory, sub-chunk major (those past nq are zeros
// and are not written), then a [warps, R * NQ] scratch for the per-row
// maxima.  A warp takes its voxel's rows R at a time: lane c dots chunks
// c, c + 32, ... of all R rows with all NQ queries, so each float4 of a
// query read from shared memory feeds 4 R FMAs; a reduce-scatter then
// leaves each lane R NQ / 32 of the R x NQ dots to divide and max.
template <typename T, int NQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    max_cosine_batch_kernel(const T* __restrict__ feats,
                            const float* __restrict__ norms,
                            const int* __restrict__ counts,
                            const float* __restrict__ q_in,
                            float* __restrict__ out, int V1, int K, int D,
                            int nq) {
  constexpr int N = Elems<T>::per16B;
  constexpr int SUB = N / 4;                 // 4-value sub-chunks a chunk
  constexpr int R = kBatchRows;
  constexpr int M = R * NQ;                  // dots a group of rows gives
  constexpr int ML = M >= 32 ? M / 32 : 1;   // of which a lane keeps
  const int chunks = D / N;
  // query j's value e at j * D + (e % N / 4) * chunks * 4 + (e / N) * 4 +
  // e % 4: the warp, reading sub-chunk s of chunks c .. c + 31, reads 512
  // consecutive bytes (no bank conflicts at any row dtype)
  extern __shared__ float4 q_smem4[];
  float* qs = reinterpret_cast<float*>(q_smem4);   // [NQ, D]
  for (int i = threadIdx.x; i < NQ * D; i += blockDim.x) {
    const int e = i % D;
    qs[i - e + ((e % N) >> 2) * chunks * 4 + (e / N) * 4 + (e & 3)] =
        i < nq * D ? batch_q<T>(q_in[i]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row_max = qs + NQ * D + warp * M;   // [R, NQ] per warp
  int first, dup;
  scatter_slots<M>(lane, first, dup);
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
       v < V1; v += static_cast<int64_t>(gridDim.x) * kWarpsPerBlock) {
    const int n = min(counts[v], K);
    float best[ML];
#pragma unroll
    for (int i = 0; i < ML; ++i) best[i] = -INFINITY;
    for (int k0 = 0; k0 < n; k0 += R) {
      const int nr = min(R, n - k0);       // warp-uniform
      const T* base = feats + (v * K + k0) * static_cast<int64_t>(D);
      float acc[M];                        // [R, NQ]
#pragma unroll
      for (int i = 0; i < M; ++i) acc[i] = 0.f;
      for (int c = lane; c < chunks; c += 32) {
        uint4 raw[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          raw[r] = load16(base + static_cast<int64_t>(r) * D + c * N, r < nr);
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          float4 x[R];
#pragma unroll
          for (int r = 0; r < R; ++r) x[r] = widen4<T>(raw[r], s);
          const float* qp = qs + s * chunks * 4 + c * 4;
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float4 qv = *reinterpret_cast<const float4*>(qp + j * D);
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r * NQ + j] = dot4(x[r], qv, acc[r * NQ + j]);
          }
        }
      }
      reduce_scatter<M, M, 16>(acc, lane);
#pragma unroll
      for (int i = 0; i < ML; ++i) {
        const int r = (first + i) / NQ;
        if (r < nr)
          best[i] = fmaxf(best[i],
                          acc[i] / fmaxf(norms[v * K + k0 + r], 1e-12f));
      }
    }
    // each (row slot, query) maximum to the scratch, then the max over
    // the R row slots by the lane of each query
    if ((lane & dup) == 0) {
#pragma unroll
      for (int i = 0; i < ML; ++i) row_max[first + i] = best[i];
    }
    __syncwarp();
    if (lane < nq) {
      float b = row_max[lane];
#pragma unroll
      for (int r = 1; r < R; ++r) b = fmaxf(b, row_max[r * NQ + lane]);
      out[static_cast<int64_t>(lane) * V1 + v] = b;
    }
    __syncwarp();
  }
}

template <typename T, int NQ>
int launch_batch(const void* feats, const void* norms, const void* counts,
                 const void* q, void* out, int V1, int K, int D, int nq,
                 cudaStream_t s) {
  const auto kernel = max_cosine_batch_kernel<T, NQ>;
  const int block = kWarpsPerBlock * 32;
  const size_t smem =
      (static_cast<size_t>(NQ) * D + kWarpsPerBlock * kBatchRows * NQ) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (V1 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int grid = std::max(1, std::min(needed, sms * std::max(per_sm, 1)));
  kernel<<<grid, block, smem, s>>>(
      static_cast<const T*>(feats), static_cast<const float*>(norms),
      static_cast<const int*>(counts), static_cast<const float*>(q),
      static_cast<float*>(out), V1, K, D, nq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_batch_by_nq(const void* feats, const void* norms,
                       const void* counts, const void* q, void* out, int V1,
                       int K, int D, int nq, cudaStream_t s) {
  if (nq <= 1) return launch_batch<T, 1>(feats, norms, counts, q, out, V1, K, D, nq, s);
  if (nq <= 2) return launch_batch<T, 2>(feats, norms, counts, q, out, V1, K, D, nq, s);
  if (nq <= 4) return launch_batch<T, 4>(feats, norms, counts, q, out, V1, K, D, nq, s);
  if (nq <= 8) return launch_batch<T, 8>(feats, norms, counts, q, out, V1, K, D, nq, s);
  return launch_batch<T, 16>(feats, norms, counts, q, out, V1, K, D, nq, s);
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

// The Q-query scan: feats [V1*K, D] (dtype 0 f32, 1 bf16, 2 int8; D a
// multiple of the values in 16 bytes), norms and counts as above, q
// [nq, D] f32 with 1 <= nq <= 16 -> out [nq, V1] f32.  nq * D * 4 bytes of shared memory a
// block (at most 227 KB).  Launches on `stream`; returns the first CUDA
// error of the attribute, occupancy and launch calls.
extern "C" int max_cosine_batch_launch(const void* feats, const void* norms,
                                       const void* counts, const void* q,
                                       void* out, int V1, int K, int D,
                                       int nq, int dtype, void* stream) {
  if (nq < 1 || nq > kMaxBatchQueries) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_batch_by_nq<__nv_bfloat16>(feats, norms, counts, q, out, V1,
                                             K, D, nq, s);
  if (dtype == kI8)
    return launch_batch_by_nq<int8_t>(feats, norms, counts, q, out, V1, K, D,
                                      nq, s);
  return launch_batch_by_nq<float>(feats, norms, counts, q, out, V1, K, D, nq,
                                   s);
}
