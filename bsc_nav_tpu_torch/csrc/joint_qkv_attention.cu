// K4: MMDiT joint attention straight from the two streams' fused qkv
// projections, with the per-stream RMS qk-norm applied in the kernel.
// qkv_x [B, Sx, 3D] and qkv_c [B, Sc, 3D] (q | k | v column groups, heads
// contiguous in each group, head_dim 64) -> out [B, Sx + Sc, D], x rows
// first.  Sc may be 0 (the dual-attention self-attention); the ctx pointer
// is then never read.
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `joint_qkv_attention`
// (`_joint_qkv_kernel`), reached through `joint_qkv_dispatch` in every
// joint block of the MMDiT and `self_qkv_dispatch` in its MMDiT-X
// dual-attention blocks.
//
// Bound on the H100: arithmetic.  SD3.5-medium at 512^2 with CFG over 3
// images (B 6, 24 heads x 64, S = 1024 + 77 + 512 = 1613) is
// 4*B*H*S^2*64 = 95.9 GFLOP per launch against ~119 MB of bf16 qkv and
// output (the fused rows carry q, k and v) -- ~800 flops per byte, far
// above the card's ~295 -- so 0.097 ms at the tensor cores' 989 TFLOP/s
// in bf16, 1.43 ms at the CUDA cores' 67 TFLOP/s in f32; the
// self-attention at 1024^2 (S 4096) is 618 GFLOP, 0.63 ms in bf16.
//
// Design: the TPU kernel concatenates both streams (one HBM copy), pads S
// to its q tile and keeps all of K and V resident in VMEM for a head pair.
// Here nothing is concatenated: a row index r < Sx reads qkv_x, a larger
// one qkv_c, so the two streams are read through two pointers, and a tile
// may straddle them (at 512^2 the q tile of rows 1024-1151 does).  The
// launcher chooses by dtype alone:
// - bf16 runs the tensor-core tile of attention_mma.cuh with its JointQKV
//   policy: two warpgroups x 64 query rows per block, 64-key K/V tiles in
//   a cp.async ring with the 128-byte swizzle, S = QK^T and P.V on wgmma.
//   Q and each K tile land raw in shared memory and are normalised there
//   in f32 by the threads that copied them, then rounded to bf16 before
//   the tensor cores read them; the scale 1/8 is applied to the f32
//   scores, as the tile does for every caller.  Rounding q-hat, k-hat and
//   P to bf16 is what the JAX package's composed joint_qkv_reference does
//   (the Pallas kernel keeps them f32), so it is held to the plain version
//   of that order, joint_qkv_attention_bf16_reference, by
//   joint_qkv_attention_bf16_tolerance.  S 1613 gives 13 q tiles, 1,872
//   blocks at B 6 x 24 heads; the 1-D grid takes any B*heads.
// - f32 keeps the CUDA-core kernel below (TF32 would break the exact-f32
//   parity): each block owns one (batch, head) and 32 query rows (8 warps
//   x 4 rows) and streams K/V through shared memory in tiles of 64 keys
//   with an online softmax (K/V for S = 1613 in f32 is 826 KB, over a
//   block's 227 KB).  The qk-norm costs no extra pass over device memory:
//   16 lanes load one row's 64 dims (a 16-byte vector each), reduce its
//   sum of squares with four shuffles, and scale it by rsqrt(mean + eps)
//   and the gamma of the row's stream before it lands in shared memory; q
//   is also scaled by 1/8.  Keys >= Sx + Sc in the last tile are masked
//   (zero rows, p = 0).  Scores: lane j owns keys j and j+32 of a tile;
//   output: lane j owns dims j and j+32 of each of its warp's 4 rows.  K/V
//   tile rows are padded to 68 floats, which keeps the lanes' 16-byte
//   reads free of bank conflicts.  Its 2-D grid takes B*heads <= 65535.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

struct joint_qkv_attention {};   // names the bf16 kernel in a profile

constexpr int kHd = 64;                 // head_dim
constexpr int kVec = kHd / 4;           // 16-byte vectors per f32 row
constexpr int kWarps = 8;               // warps per block
constexpr int kRows = 4;                // query rows per warp
constexpr int kQTile = kWarps * kRows;  // query rows per block
constexpr int kKeys = 64;               // keys per shared-memory tile
constexpr int kLd = kHd + 4;            // padded K/V tile row, in floats

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

// sum over the 16 lanes of a half warp: the lanes that hold one row
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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

// x * rsqrt(sum_sq / 64 + eps) * gamma * post, elementwise on a 4-vector
__device__ __forceinline__ float4 rms_scale(float4 x, float sum_sq, float eps,
                                            const float* g, float post) {
  const float inv = rsqrtf(sum_sq / kHd + eps);
  x.x = x.x * inv * g[0] * post;
  x.y = x.y * inv * g[1] * post;
  x.z = x.z * inv * g[2] * post;
  x.w = x.w * inv * g[3] * post;
  return x;
}

// row r of batch b of the joint sequence: x stream first, then ctx
__device__ __forceinline__ const float* joint_row(const float* x,
                                                  const float* c, int64_t b,
                                                  int r, int Sx, int Sc,
                                                  int64_t row_len) {
  return r < Sx ? x + (b * Sx + r) * row_len
                : c + (b * Sc + (r - Sx)) * row_len;
}

constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kKeys * kLd + kQTile * kHd + kQTile * kKeys +
                     4 * kHd);

__global__ void __launch_bounds__(kWarps * 32)
    joint_qkv_kernel(const float* __restrict__ qkv_x,
                     const float* __restrict__ qkv_c,
                     const float* __restrict__ gammas,
                     float* __restrict__ out,
                     int Sx, int Sc, int heads, float eps, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;                  // [kKeys][kLd]
  float* Vs = Ks + kKeys * kLd;      // [kKeys][kLd]
  float* Qs = Vs + kKeys * kLd;      // [kWarps][kRows][kHd]
  float* Ps = Qs + kQTile * kHd;     // [kWarps][kRows][kKeys]
  float* Gs = Ps + kQTile * kKeys;   // [4][kHd]: q_x, k_x, q_c, k_c

  const int S = Sx + Sc;
  const int D = heads * kHd;
  const int64_t row_len = 3 * static_cast<int64_t>(D);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kQTile + warp * kRows;  // warp's first row
  const int qcol = h * kHd, kcol = D + h * kHd, vcol = 2 * D + h * kHd;
  const int half = lane >> 4, vec = lane & 15;  // a half warp holds a row

  for (int i = threadIdx.x; i < 4 * kHd; i += blockDim.x) Gs[i] = gammas[i];
  __syncthreads();

  // the warp's 4 q rows, normalised and scaled, two rows per pass
  float* Qw = Qs + warp * kRows * kHd;
#pragma unroll
  for (int pass = 0; pass < kRows / 2; ++pass) {
    const int r = 2 * pass + half;
    const int qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < S)
      x = load4(joint_row(qkv_x, qkv_c, b, qi, Sx, Sc, row_len) + qcol +
                4 * vec);
    const float ss = row_sum(dot4(x, x));
    const float* g = Gs + (qi < Sx ? 0 : 2) * kHd + 4 * vec;
    reinterpret_cast<float4*>(Qw + r * kHd)[vec] =
        rms_scale(x, ss, eps, g, scale);
  }
  float* Pw = Ps + warp * kRows * kKeys;

  float m[kRows], l[kRows], acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; Qs is written
    // kKeys * kVec vectors, a multiple of the block: every lane of a warp
    // takes part in every pass, as the shuffles in row_sum need
    for (int i = threadIdx.x; i < kKeys * kVec; i += blockDim.x) {
      const int j = i / kVec, c = i % kVec;
      const int kj = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kj < S) {
        const float* row = joint_row(qkv_x, qkv_c, b, kj, Sx, Sc, row_len);
        kx = load4(row + kcol + 4 * c);
        vx = load4(row + vcol + 4 * c);
      }
      const float ss = row_sum(dot4(kx, kx));
      const float* g = Gs + (kj < Sx ? 1 : 3) * kHd + 4 * c;
      reinterpret_cast<float4*>(Ks + j * kLd)[c] =
          rms_scale(kx, ss, eps, g, 1.f);
      reinterpret_cast<float4*>(Vs + j * kLd)[c] = vx;
    }
    __syncthreads();
    const int nk = min(kKeys, S - k0);

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(Ks + lane * kLd);
    const float4* kb = reinterpret_cast<const float4*>(Ks + (lane + 32) * kLd);
#pragma unroll 4
    for (int c = 0; c < kVec; ++c) {
      const float4 a = ka[c], bb = kb[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(Qw + r * kHd)[c];
        s[r][0] += dot4(qv, a);
        s[r][1] += dot4(qv, bb);
      }
    }

    const bool va = lane < nk, vb = lane + 32 < nk;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sa = va ? s[r][0] : -INFINITY;
      const float sb = vb ? s[r][1] : -INFINITY;
      // every tile holds a live key, so m_new is finite
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float corr = expf(m[r] - m_new);
      const float pa = va ? expf(sa - m_new) : 0.f;
      const float pb = vb ? expf(sb - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(pa + pb);
      m[r] = m_new;
      acc[r][0] *= corr;
      acc[r][1] *= corr;
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
        const float* vrow = Vs + (j + jj) * kLd;
        const float x0 = vrow[lane], x1 = vrow[lane + 32];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] = fmaf(get(p4[r], jj), x0, acc[r][0]);
          acc[r][1] = fmaf(get(p4[r], jj), x1, acc[r][1]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r;
    if (qi >= S) continue;
    float* dst = out + (b * S + qi) * D + h * kHd;
    dst[lane] = acc[r][0] / l[r];
    dst[lane + 32] = acc[r][1] / l[r];
  }
}

int launch(const void* qkv_x, const void* qkv_c, const void* gammas,
           void* out, int B, int Sx, int Sc, int heads, float eps,
           cudaStream_t stream) {
  auto kernel = joint_qkv_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sx + Sc + kQTile - 1) / kQTile, B * heads);
  const float scale = 0.125f;  // 1 / sqrt(64), exact
  kernel<<<grid, kWarps * 32, kSmemBytes, stream>>>(
      static_cast<const float*>(qkv_x), static_cast<const float*>(qkv_c),
      static_cast<const float*>(gammas), static_cast<float*>(out), Sx, Sc,
      heads, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv_x [B, Sx, 3*heads*64], qkv_c [B, Sc, 3*heads*64] (NULL when Sc == 0),
// gammas f32 [4, 64] (q_x, k_x, q_c, k_c) -> out [B, Sx + Sc, heads*64];
// all contiguous and 16-byte aligned, f32 (or bf16 when is_bf16).  f32
// takes B*heads <= 65535.  Launches on `stream`; returns the first CUDA
// error, or 0.
extern "C" int joint_qkv_attention_launch(const void* qkv_x,
                                          const void* qkv_c,
                                          const void* gammas, void* out,
                                          int B, int Sx, int Sc, int heads,
                                          float eps, int is_bf16,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sx < 0 || Sc < 0 || Sx + Sc <= 0 || heads <= 0 ||
      (Sc > 0 && !qkv_c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return tc::launch_joint_qkv_mma<joint_qkv_attention>(
        qkv_x, qkv_c, gammas, out, B, Sx, Sc, heads, eps, s);
  if (static_cast<int64_t>(B) * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(qkv_x, qkv_c, gammas, out, B, Sx, Sc, heads, eps, s);
}
