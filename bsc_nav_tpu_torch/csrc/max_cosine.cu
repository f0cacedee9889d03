// K2: fused store scan -- per voxel, the max cosine between the query and
// the voxel's live cached tokens -- and K2b, its Q-query form.
//
// Replaces: bsc_nav_tpu/ops/similarity.py `_row_cosines_pallas`
// (`_sim_kernel`), reached by `max_cosine_per_voxel`, plus the per-voxel
// max that the JAX package runs as a separate reduce over the [V1*K]
// row cosines; and, in K2b (`max_cosine_batch_launch`), the XLA einsums of
// `max_cosine_per_voxel_batch` (Q queries, one pass) and of
// `reference_row_cosines` for int8 rows, which the JAX package takes
// instead of its kernel.
//
// Bound on the H100: device memory.  A scan reads each live row once,
// V1*K*D*itemsize bytes for a full store (5.37 GB f32 / 2.68 GB bf16 /
// 1.34 GB int8 at the agent's default V1 = 131,080, K = 10, D = 1024,
// reckoned from the shapes), and does 2 Q flops per element: at Q = 16 on
// int8 rows 32 flops per byte, far below the ~295 a byte at which the bf16
// tensor cores would set the bound, but 1.6x the bytes' time on the CUDA
// cores' f32 FMAs.
//
// K2, one query: one warp per voxel.  The f32 query sits in shared
// memory; the warp streams its voxel's rows with 16-byte loads (4 f32 or
// 8 bf16 values), neighbouring lanes on neighbouring addresses, widens
// them to f32, reduces each dot in f32 with shuffles, divides by the
// stored norm, and keeps the running max in a register, so the [V1*K] row
// cosines never reach device memory.  Rows at k >= count[v] are never
// read: masked_norms marks them -inf, and skipping their bytes is the only
// saving a memory-bound scan has.  Any V1 is accepted; the ragged edge is
// masked here.
//
// int8 rows hold per-row absmax codes whose scale cancels in the cosine
// (feat_norm is the int8 row's norm), so neither scan reads feat_scale.
// A single query on int8 rows is K2b at Q = 1.  K2b rounds its queries to
// bf16 for bf16 and int8 rows (the JAX batch semantics,
// `qs.astype(feats.dtype)`, bf16 for int8) and keeps them f32 for f32
// rows; the single-query K2 keeps f32 queries as the TPU kernel does.
//
// K2b on bf16 and int8 rows (max_cosine_mma_kernel): the tensor cores.
// Every product is exact in bf16 (an int8 code is a bf16, and so is each
// rounded query), so mma.sync.m16n8k16 bf16 with f32 accumulators computes
// the JAX semantics up to the order of the sum; the CUDA cores are left
// the loads, the int8 widening and the epilogue, and the scan is a bytes
// problem again.  Rows are M, queries N (one n8 tile at Q <= 8, two at
// Q <= 16), D is K.  A dot does not depend on the order of k, so each lane
// loads whole 16-byte chunks of its two rows (g and g + 8 of the m16
// tile) straight into A fragments: in a k-block of 4 P values (P values
// in 16 bytes, 8 bf16 or 16 int8), lane t of a quad owns values
// [t P, t P + P), and k16 step s takes values t P + 4 s .. + 3 of every
// lane, so that a fragment's logical k 2t, 2t+1, 2t+8, 2t+9 are its
// values 4 s, 4 s + 1, 4 s + 2, 4 s + 3.  The B fragments must use the
// same order: the block lays the queries out once in shared memory as
// [k-block][n8 tile][16-byte plane][lane] bf16, so that lane (g, t) reads
// query g's values at the very offsets of its row chunk, a warp reading
// 512 consecutive bytes (no bank conflict).  int8 codes are widened
// exactly in registers: under the bf16 exponent byte 0x43 a code's low 7
// bits m make 128 + m and its sign bit s makes 128 + 128 s (one byte
// permute each, for two codes), and one bf16x2 subtraction leaves the two
// codes m - 128 s.
//
// A warp takes 8 voxels at once (one count a lane), and packs their live
// rows (k < count), voxel after voxel, into m16 tiles, so that dead rows
// cost neither bytes nor products nor widening: only the group's last
// tile has empty slots, which are never loaded, and a group with no live
// row writes -inf having read only its counts (the next group's counts
// are loaded while a group is scanned).  Each lane keeps the loads of U
// k-blocks in flight while it multiplies the U before (a register double
// buffer; U = 8 on bf16 rows, 4 on int8 rows, whose widening needs the
// registers; each load also pulls the row's next 256 bytes into L2), and
// the next tile's first loads go out before a tile's epilogue.  Blocks of
// 4 warps are persistent, so the queries are laid out once per block.
// The epilogue divides each (row, query) accumulator by max(norm, 1e-12)
// (empty slots -inf), writes the tile's cosines to a per-warp scratch, and
// keeps each voxel's running max per query there; the group writes
// out[j * V1 + v] along v.  Variants timed on the H100 are in PERF.md:
// groups of 2 to 32 voxels (8 was best on the random store, 32 on a
// sparse one), U of 4 and 8, 8 warps a block, slot tiles without the
// packing, and a bulk L2 prefetch of whole rows (slower everywhere).
//
// Why mma.sync and not wgmma: at Q <= 16 the products take <= 0.04 ms
// against 0.20-0.40 ms of bytes, so the tensor-core rate is not the
// limit; mma.sync takes A from registers straight from the loads, with no
// shared-memory staging of the rows, no 64-row warpgroup tile to pad (a
// group's last tile pads at most 15 rows) and no async fences.
//
// K2b on f32 rows (max_cosine_batch_kernel) stays on the CUDA cores: an
// f32 product on the tensor cores takes three TF32 products, and the
// kernel reaches ~0.58 of its bytes bound.  It keeps up to 16 f32 queries
// in shared memory (64 KB at D = 1024, past the 48 KB default: opted in
// per instance), reads each live row once and dots it with every query.
// A warp takes its voxel's rows 4 at a time, so that one shared-memory
// read of a query slice feeds 4 rows (laid out so that a warp's reads are
// conflict-free).  A reduce-scatter of the 4 x Q dots over the warp,
// every index a compile-time constant so that nothing leaves the
// registers, leaves each lane 4 Q / 32 of them to divide and max.  Blocks
// are persistent, so the queries are copied into shared memory once per
// block.
//
// Each launch of K2b is counted by the kernel it took
// (bsc_tile_launches, mma_bf16.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_bf16.cuh"

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

__device__ __forceinline__ float4 as_float4(const uint4& raw) {
  return make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                     __uint_as_float(raw.z), __uint_as_float(raw.w));
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

// f32 rows, out [nq, V1]: out[j * V1 + v] = max over v's live rows of
// dot(row, q_j) / max(norm, 1e-12), -inf for an empty voxel.  NQ >= nq
// queries sit in shared memory (those past nq are zeros and are not
// written), then a [warps, R * NQ] scratch for the per-row maxima.  A warp
// takes its voxel's rows R at a time: lane c dots chunks c, c + 32, ... of
// all R rows with all NQ queries, so each float4 of a query read from
// shared memory feeds 4 R FMAs (the warp reads 512 consecutive bytes, no
// bank conflict); a reduce-scatter then leaves each lane R NQ / 32 of the
// R x NQ dots to divide and max.
template <int NQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    max_cosine_batch_kernel(const float* __restrict__ feats,
                            const float* __restrict__ norms,
                            const int* __restrict__ counts,
                            const float* __restrict__ q_in,
                            float* __restrict__ out, int V1, int K, int D,
                            int nq) {
  constexpr int R = kBatchRows;
  constexpr int M = R * NQ;                  // dots a group of rows gives
  constexpr int ML = M >= 32 ? M / 32 : 1;   // of which a lane keeps
  const int chunks = D / 4;
  extern __shared__ float4 q_smem4[];
  float* qs = reinterpret_cast<float*>(q_smem4);   // [NQ, D]
  for (int i = threadIdx.x; i < NQ * D; i += blockDim.x)
    qs[i] = i < nq * D ? q_in[i] : 0.f;
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
      const float* base = feats + (v * K + k0) * static_cast<int64_t>(D);
      float acc[M];                        // [R, NQ]
#pragma unroll
      for (int i = 0; i < M; ++i) acc[i] = 0.f;
      for (int c = lane; c < chunks; c += 32) {
        float4 x[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          x[r] = as_float4(
              load16(base + static_cast<int64_t>(r) * D + c * 4, r < nr));
        const float* qp = qs + c * 4;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float4 qv = *reinterpret_cast<const float4*>(qp + j * D);
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r * NQ + j] = dot4(x[r], qv, acc[r * NQ + j]);
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

template <int NQ>
int launch_batch_f32(const void* feats, const void* norms, const void* counts,
                     const void* q, void* out, int V1, int K, int D, int nq,
                     cudaStream_t s) {
  const auto kernel = max_cosine_batch_kernel<NQ>;
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
      static_cast<const float*>(feats), static_cast<const float*>(norms),
      static_cast<const int*>(counts), static_cast<const float*>(q),
      static_cast<float*>(out), V1, K, D, nq);
  return counted_launch(kTileScanCuda);
}

// ---------------------------------------------------------------------------
// Q-query scan on the tensor cores: bf16 and int8 rows
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;    // warps a block
constexpr int kGroup = 8;       // voxels a warp takes at once (<= 32, one a lane)

// P: row values in one 16-byte load; U: k-blocks a lane loads at once, twice
// over (int8 rows leave registers to the widening)
template <typename T>
struct RowChunk;
template <>
struct RowChunk<__nv_bfloat16> {
  static constexpr int P = 8, U = 8;
};
template <>
struct RowChunk<int8_t> {
  static constexpr int P = 16, U = 4;
};

// 16 bytes of a live row, streamed past L1 (each byte is read once) with
// the 256 bytes around them fetched into L2 (the row's next k-blocks), or
// zeros without a load.  Volatile: the loads of a batch stay ahead of the
// products of the one before.
__device__ __forceinline__ uint4 load_row16(const void* p, bool live) {
  uint4 r;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
      "@p ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
      "[%4];\n}\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "r"(static_cast<int>(live)));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Codes b and b + 1 (b even) of a word of four int8 codes as a bf16 pair,
// b in the low half, exactly: under the exponent byte 0x43 a code's low 7
// bits m make the bf16 128 + m and its sign bit s the bf16 128 + 128 s;
// their difference m - 128 s is the code, which bf16 holds.
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t w, int b) {
  const uint32_t sel = b == 0 ? 0x4140u : 0x4342u;
  const uint32_t m = __byte_perm(w & 0x7F7F7F7Fu, 0x43434343u, sel);
  const uint32_t s = __byte_perm(w & 0x80808080u, 0x43434343u, sel);
  const __nv_bfloat162 c =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
              *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&c);
}

// The A fragment of k16 step s of a k-block from the lane's chunks of
// rows g (lo) and g + 8 (hi): a0 / a1 rows g / g + 8 at logical k 2t,
// 2t + 1, a2 / a3 at 2t + 8, 2t + 9 -- the chunk's values 4 s .. 4 s + 3.
template <typename T>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint4& lo,
                                       const uint4& hi, int s) {
  if constexpr (std::is_same_v<T, int8_t>) {
    a[0] = s8x2_bf16x2(word(lo, s), 0);
    a[1] = s8x2_bf16x2(word(hi, s), 0);
    a[2] = s8x2_bf16x2(word(lo, s), 2);
    a[3] = s8x2_bf16x2(word(hi, s), 2);
  } else {
    a[0] = word(lo, 2 * s);
    a[1] = word(hi, 2 * s);
    a[2] = word(lo, 2 * s + 1);
    a[3] = word(hi, 2 * s + 1);
  }
}

// How many of the 32 ascending `ends` are <= i: the voxel of a group
// whose rows hold live slot i < ends[31].
__device__ __forceinline__ int voxel_of(const int* ends, int i) {
  int n = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (ends[n + step - 1] <= i) n += step;
  return n;
}

// out [nq, V1] as max_cosine_batch_kernel, on bf16 or int8 rows, queries
// rounded to bf16, on mma.sync m16n8k16 (NT n8 tiles of queries).  A warp
// takes kGroup voxels at once and packs their live rows, in voxel order,
// into m16 tiles.  Shared memory: the queries [k-block][NT][H][32 lanes] x
// 16 bytes, then per warp the group's row ends [32], a running max
// [kGroup voxels][8 NT] and a tile's cosines [16 rows][TS].
template <typename T, int NT>
__global__ void __launch_bounds__(kMmaWarps * 32)
    max_cosine_mma_kernel(const T* __restrict__ feats,
                          const float* __restrict__ norms,
                          const int* __restrict__ counts,
                          const float* __restrict__ q_in,
                          float* __restrict__ out, int V1, int K, int D,
                          int nq) {
  constexpr int P = RowChunk<T>::P;
  constexpr int U = RowChunk<T>::U;
  constexpr int H = P / 8;            // 16-byte query planes a k-block
  constexpr int S = P / 4;            // k16 steps a k-block
  constexpr int KB = 4 * P;           // row values a k-block
  constexpr int NQP = 8 * NT;
  constexpr int TS = 8 * (2 * NT - 1);   // conflict-free float2 stores
  const int nkb = (D + KB - 1) / KB;
  extern __shared__ uint4 mma_smem[];
  uint4* bq = mma_smem;
#pragma unroll 4
  for (int i = threadIdx.x; i < nkb * NT * H * 32; i += blockDim.x) {
    const int ln = i & 31, h = (i >> 5) % H, nt = (i >> 5) / H % NT;
    const int kb = (i >> 5) / (H * NT);
    const int j = nt * 8 + (ln >> 2);
    const int d0 = kb * KB + (ln & 3) * P + h * 8;
    const float* qp = q_in + static_cast<int64_t>(j) * D + d0;
    const bool in = j < nq && d0 < D;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = tc::pack_bf16(in ? qp[2 * e] : 0.f, in ? qp[2 * e + 1] : 0.f);
    bq[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int* ends = reinterpret_cast<int*>(bq + nkb * NT * H * 32) +
              warp * (32 + kGroup * NQP + 16 * TS);       // [32]
  float* vmax = reinterpret_cast<float*>(ends + 32);      // [kGroup][NQP]
  float* tcos = vmax + kGroup * NQP;                      // [16][TS]
  for (int i = lane; i < kGroup * NQP; i += 32) vmax[i] = -INFINITY;
  const int64_t groups = (V1 + kGroup - 1) / kGroup;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kMmaWarps;
  // lane v's count in the group at v0 (0 past the store); the next group's
  // is loaded while this one is scanned
  auto count_at = [&](int64_t v0) {
    return lane < kGroup && v0 + lane < V1 ? __ldg(counts + v0 + lane) : 0;
  };
  int64_t grp = static_cast<int64_t>(blockIdx.x) * kMmaWarps + warp;
  int cnt_next = count_at(grp * kGroup);
  for (; grp < groups; grp += stride) {
    const int64_t v0 = grp * kGroup;
    const int cnt = min(cnt_next, K);
    cnt_next = count_at((grp + stride) * kGroup);
    // the group's live rows, voxel after voxel: lane v's at [end - cnt, end)
    int end = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, end, o);
      if (lane >= o) end += n;
    }
    const int live = __shfl_sync(0xffffffffu, end, 31);
    __syncwarp();
    ends[lane] = end;
    __syncwarp();
    // this lane's rows of the tile at live slot r0: r0 + g and r0 + g + 8
    int64_t row[2];
    bool on[2];
    const T* src[2];
    auto rows_at = [&](int r0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + g + 8 * h;
        on[h] = i < live;
        const int lv = voxel_of(ends, on[h] ? i : 0);
        row[h] = (v0 + lv) * K + i - (lv > 0 ? ends[lv - 1] : 0);
        src[h] = feats + row[h] * D + t * P;
      }
    };
    auto load = [&](uint4 (&lo)[U], uint4 (&hi)[U],
                    int kb0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = (kb0 + u) * KB;
        const bool in = d + t * P < D;
        lo[u] = load_row16(src[0] + d, on[0] && in);
        hi[u] = load_row16(src[1] + d, on[1] && in);
      }
    };
    float acc[NT][4];
    auto products = [&](const uint4 (&lo)[U],
                        const uint4 (&hi)[U], int kb0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kb = kb0 + u;
        if (kb < nkb) {       // warp-uniform
          uint4 b[NT][H];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < H; ++h)
              b[nt][h] = bq[((kb * NT + nt) * H + h) * 32 + lane];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            uint32_t a[4];
            a_frag<T>(a, lo[u], hi[u], s);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              tc::mma_bf16(acc[nt], a, word(b[nt][s / 2], 2 * (s % 2)),
                           word(b[nt][s / 2], 2 * (s % 2) + 1));
          }
        }
      }
    };
    // the loads of one batch of k-blocks are issued before the products of
    // the one before (a register double buffer), the next tile's first
    // batch before this tile's epilogue
    uint4 lo0[U], hi0[U], lo1[U], hi1[U];
    if (live > 0) {
      rows_at(0);
      load(lo0, hi0, 0);
    }
    for (int r0 = 0; r0 < live; r0 += 16) {
      const bool on_lo = on[0], on_hi = on[1];
      const float n_lo = on_lo ? __ldg(norms + row[0]) : 1.f;
      const float n_hi = on_hi ? __ldg(norms + row[1]) : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      for (int kb0 = 0; kb0 < nkb; kb0 += 2 * U) {
        load(lo1, hi1, kb0 + U);
        products(lo0, hi0, kb0);
        if (kb0 + 2 * U < nkb) {
          load(lo0, hi0, kb0 + 2 * U);
        } else if (r0 + 16 < live) {
          rows_at(r0 + 16);
          load(lo0, hi0, 0);
        }
        products(lo1, hi1, kb0 + U);
      }
      // the tile's cosines (slots past the live rows -inf) to the scratch
      const float d_lo = fmaxf(n_lo, 1e-12f), d_hi = fmaxf(n_hi, 1e-12f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(tcos + g * TS + col) =
            on_lo ? make_float2(acc[nt][0] / d_lo, acc[nt][1] / d_lo)
                  : make_float2(-INFINITY, -INFINITY);
        *reinterpret_cast<float2*>(tcos + (g + 8) * TS + col) =
            on_hi ? make_float2(acc[nt][2] / d_hi, acc[nt][3] / d_hi)
                  : make_float2(-INFINITY, -INFINITY);
      }
      __syncwarp();
      // each (voxel, query) with rows in the tile: its running max
      const int r1 = min(r0 + 16, live);
      const int lv0 = voxel_of(ends, r0), lv1 = voxel_of(ends, r1 - 1);
      for (int i = lane; i < (lv1 - lv0 + 1) * NQP; i += 32) {
        const int lv = lv0 + i / NQP, j = i % NQP;
        const int a = max(lv > 0 ? ends[lv - 1] : 0, r0);
        const int b = min(ends[lv], r1);
        float m = vmax[lv * NQP + j];
        for (int r = a; r < b; ++r) m = fmaxf(m, tcos[(r - r0) * TS + j]);
        vmax[lv * NQP + j] = m;
      }
      __syncwarp();
    }
    if (lane < kGroup && v0 + lane < V1) {
      for (int j = 0; j < nq; ++j)
        out[static_cast<int64_t>(j) * V1 + v0 + lane] = vmax[lane * NQP + j];
    }
    __syncwarp();
    for (int i = lane; i < kGroup * NQP; i += 32) vmax[i] = -INFINITY;
    __syncwarp();
  }
}

template <typename T, int NT>
int launch_mma(const void* feats, const void* norms, const void* counts,
               const void* q, void* out, int V1, int K, int D, int nq,
               cudaStream_t s) {
  const auto kernel = max_cosine_mma_kernel<T, NT>;
  constexpr int P = RowChunk<T>::P;
  const int block = kMmaWarps * 32;
  const int nkb = (D + 4 * P - 1) / (4 * P);
  const size_t smem =
      static_cast<size_t>(nkb) * NT * (P / 8) * 32 * sizeof(uint4) +
      kMmaWarps * (32 + kGroup * 8 * NT + 16 * 8 * (2 * NT - 1)) * 4;
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
  const int64_t groups = (static_cast<int64_t>(V1) + kGroup - 1) / kGroup;
  const int64_t needed = (groups + kMmaWarps - 1) / kMmaWarps;
  const int grid = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(needed, sms * std::max(per_sm, 1))));
  kernel<<<grid, block, smem, s>>>(
      static_cast<const T*>(feats), static_cast<const float*>(norms),
      static_cast<const int*>(counts), static_cast<const float*>(q),
      static_cast<float*>(out), V1, K, D, nq);
  return counted_launch(kTileScanMma);
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
// [nq, D] f32 with 1 <= nq <= 16 -> out [nq, V1] f32.  f32 rows take
// max_cosine_batch_kernel (nq * D * 4 bytes of shared memory a block, at
// most 227 KB), bf16 and int8 rows max_cosine_mma_kernel (8 or 16 queries
// of D bf16).  Launches on `stream`; returns the first CUDA error of the
// attribute, occupancy and launch calls.
extern "C" int max_cosine_batch_launch(const void* feats, const void* norms,
                                       const void* counts, const void* q,
                                       void* out, int V1, int K, int D,
                                       int nq, int dtype, void* stream) {
  if (nq < 1 || nq > kMaxBatchQueries) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return nq <= 8 ? launch_mma<__nv_bfloat16, 1>(feats, norms, counts, q,
                                                  out, V1, K, D, nq, s)
                   : launch_mma<__nv_bfloat16, 2>(feats, norms, counts, q,
                                                  out, V1, K, D, nq, s);
  if (dtype == kI8)
    return nq <= 8 ? launch_mma<int8_t, 1>(feats, norms, counts, q, out, V1,
                                           K, D, nq, s)
                   : launch_mma<int8_t, 2>(feats, norms, counts, q, out, V1,
                                           K, D, nq, s);
  if (nq <= 1) return launch_batch_f32<1>(feats, norms, counts, q, out, V1, K, D, nq, s);
  if (nq <= 2) return launch_batch_f32<2>(feats, norms, counts, q, out, V1, K, D, nq, s);
  if (nq <= 4) return launch_batch_f32<4>(feats, norms, counts, q, out, V1, K, D, nq, s);
  if (nq <= 8) return launch_batch_f32<8>(feats, norms, counts, q, out, V1, K, D, nq, s);
  return launch_batch_f32<16>(feats, norms, counts, q, out, V1, K, D, nq, s);
}
