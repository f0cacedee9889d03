// K4: MMDiT joint attention straight from the two streams' fused qkv
// projections, with the per-stream RMS qk-norm.  qkv_x [B, Sx, 3D] and
// qkv_c [B, Sc, 3D] (q | k | v column groups, heads contiguous in each
// group, head_dim 64) -> out [B, Sx + Sc, D], x rows first.  Sc may be 0
// (the dual-attention self-attention); the ctx pointer is then never read.
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
// in bf16, 0.58 ms at 165 TFLOP/s in f32 (three TF32 products per f32
// product); the self-attention at 1024^2 (S 4096) is 618 GFLOP, 0.63 ms
// in bf16.
//
// Design: the TPU kernel concatenates both streams (one HBM copy), pads S
// to its q tile, keeps all of K and V resident in VMEM for a head pair and
// normalises q and k in every program.  Here the call is two device
// kernels on one stream:
// 1. joint_qkv_norm_kernel, a pre-pass bound by bytes: it reads each row
//    of both streams once and writes the joint fused rows [B, S, 3D], x
//    rows first -- q-hat and k-hat (each head's 64 dims x rsqrt(mean of
//    squares + eps) x its stream's gamma, unscaled) and v copied -- in the
//    input dtype.  A block owns one joint row; each thread loads 16-byte
//    chunks (8 bf16 or 4 f32 values), four at a time to keep loads in
//    flight, and the 8 or 16 lanes that hold a head's 64 dims sum its
//    squares by shuffles.  In bf16 q-hat and k-hat are computed in f32 and
//    rounded once to bf16, the order of joint_qkv_attention_bf16_reference
//    (an f32 sum of 64 squares in any order, rsqrtf, then the products,
//    within 2^-17 of the plain version's f32 value:
//    joint_qkv_attention_bf16_tolerance); in f32 nothing is rounded.  At
//    B 6, S 1613 it moves 178 MB in bf16 (53 us at 3.35 TB/s), 357 MB in
//    f32.  The qk-norm is done once per row, not once per q tile that reads
//    it, as the tile before this design did (13 times at S 1613).
// 2. the attention tile on those rows, read in place as K1 reads its
//    fused projection: bf16 on attention_tma.cuh (4-D tensor maps over the
//    fused rows, a producer warpgroup, 128-key tiles, three consumer
//    warpgroups on wgmma, one block per SM walking the (q tile, head)
//    items), f32 on attention_tf32.cuh's FusedQKV policy (every f32
//    product as three TF32 products, within the f32 paths' 2e-5).  Both
//    scale the scores by 1/8 (exact), as the JAX kernel scales q.
// The caller allocates the joint rows as scratch (torch.empty on its
// stream).  Both kernels carry joint_qkv in their names, so a profile's K4
// sum counts both.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tf32.cuh"
#include "attention_tma.cuh"

namespace {

struct joint_qkv_attention {};   // names the tile kernels in a profile

constexpr int kNormThreads = 128;   // threads of a pre-pass block
constexpr int kNormUnroll = 4;      // chunks a thread loads at once

__device__ __forceinline__ void to_float(const uint4& u, float (&v)[4]) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = f[e];
}

__device__ __forceinline__ void to_float(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 from_float(const float (&v)[4]) {
  uint4 u;
  float* f = reinterpret_cast<float*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = v[e];
  return u;
}

__device__ __forceinline__ uint4 from_float(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    p[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  return u;
}

// one joint row b * S + r per block: q-hat | k-hat | v of row r of the x
// stream (r < Sx) or row r - Sx of the ctx stream, each 16-byte chunk
// loaded and stored once; gammas f32 [4, 64] (q_x, k_x, q_c, k_c)
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    joint_qkv_norm_kernel(const T* __restrict__ qkv_x,
                          const T* __restrict__ qkv_c,
                          const float* __restrict__ gammas,
                          T* __restrict__ fused, int Sx, int Sc, int heads,
                          float eps) {
  constexpr int E = 16 / sizeof(T);   // values of a 16-byte chunk
  constexpr int L = 64 / E;           // lanes that hold a head's 64 dims
  constexpr int STEP = kNormThreads * kNormUnroll;
  const int S = Sx + Sc;
  const int row = blockIdx.x;   // of the joint rows
  const int b = row / S, r = row - b * S;
  const int n_chunks = 3 * heads * L;   // of a row
  const int64_t row_len = 3 * static_cast<int64_t>(heads) * 64;
  const bool from_x = r < Sx;
  const T* src = from_x ? qkv_x + (static_cast<int64_t>(b) * Sx + r) * row_len
                        : qkv_c + (static_cast<int64_t>(b) * Sc + r - Sx) *
                                      row_len;
  T* dst = fused + static_cast<int64_t>(row) * row_len;
  const float* g_q = gammas + (from_x ? 0 : 2) * 64;

  // every lane runs every pass (the shuffles take the whole warp); a head's
  // L chunks lie in one aligned group of L lanes, live or not together
  for (int j0 = 0; j0 < n_chunks; j0 += STEP) {
    uint4 u[kNormUnroll];
#pragma unroll
    for (int k = 0; k < kNormUnroll; ++k) {
      const int j = j0 + k * kNormThreads + threadIdx.x;
      u[k] = j < n_chunks ? __ldg(reinterpret_cast<const uint4*>(src) + j)
                          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kNormUnroll; ++k) {
      const int j = j0 + k * kNormThreads + threadIdx.x;
      float v[E];
      to_float(u[k], v);
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(v[e], v[e], ss);
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (j >= n_chunks) continue;
      const int part = j / L;           // q heads, then k heads, then v
      uint4 w = u[k];                   // v: copied
      if (part < 2 * heads) {
        const float inv = rsqrtf(ss * (1.f / 64) + eps);
        const float* g = g_q + (part < heads ? 0 : 64) + (j % L) * E;
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = v[e] * inv * __ldg(g + e);
        w = from_float(v);
      }
      reinterpret_cast<uint4*>(dst)[j] = w;
    }
  }
}

template <typename T>
int launch_norm(const void* qkv_x, const void* qkv_c, const void* gammas,
                void* fused, int B, int Sx, int Sc, int heads, float eps,
                cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * (Sx + Sc);
  if (rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  joint_qkv_norm_kernel<T><<<static_cast<unsigned>(rows), kNormThreads, 0,
                             stream>>>(
      static_cast<const T*>(qkv_x),
      static_cast<const T*>(Sc > 0 ? qkv_c : qkv_x),
      static_cast<const float*>(gammas), static_cast<T*>(fused), Sx, Sc,
      heads, eps);
  return static_cast<int>(cudaGetLastError());
}

bool joint_args_ok(const void* qkv_c, int B, int Sx, int Sc, int heads) {
  return B > 0 && Sx >= 0 && Sc >= 0 && Sx + Sc > 0 && heads > 0 &&
         (Sc == 0 || qkv_c != nullptr);
}

int launch_qk_norm(const void* qkv_x, const void* qkv_c, const void* gammas,
                   void* fused, int B, int Sx, int Sc, int heads, float eps,
                   int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_norm<__nv_bfloat16>(qkv_x, qkv_c, gammas, fused,
                                              B, Sx, Sc, heads, eps, s)
                 : launch_norm<float>(qkv_x, qkv_c, gammas, fused, B, Sx, Sc,
                                      heads, eps, s);
}

}  // namespace

// The pre-pass alone: qkv_x [B, Sx, 3*heads*64], qkv_c [B, Sc, 3*heads*64]
// (NULL when Sc == 0), gammas f32 [4, 64] (q_x, k_x, q_c, k_c) -> fused
// [B, Sx + Sc, 3*heads*64], x rows first; all contiguous and 16-byte
// aligned, f32 (or bf16 when is_bf16).  Launches on `stream`; returns the
// first CUDA error, or 0.
extern "C" int joint_qk_norm_launch(const void* qkv_x, const void* qkv_c,
                                    const void* gammas, void* fused, int B,
                                    int Sx, int Sc, int heads, float eps,
                                    int is_bf16, void* stream) {
  if (!joint_args_ok(qkv_c, B, Sx, Sc, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_qk_norm(qkv_x, qkv_c, gammas, fused, B, Sx, Sc, heads, eps,
                        is_bf16, static_cast<cudaStream_t>(stream));
}

// K4: the pre-pass into `fused` (scratch [B, Sx + Sc, 3*heads*64]), then
// the attention tile on it -> out [B, Sx + Sc, heads*64]; arguments as
// joint_qk_norm_launch's.  Launches both on `stream`; returns the first
// CUDA error, or 0.
extern "C" int joint_qkv_attention_launch(const void* qkv_x,
                                          const void* qkv_c,
                                          const void* gammas, void* fused,
                                          void* out, int B, int Sx, int Sc,
                                          int heads, float eps, int is_bf16,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!joint_args_ok(qkv_c, B, Sx, Sc, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_qk_norm(qkv_x, qkv_c, gammas, fused, B, Sx, Sc,
                                 heads, eps, is_bf16, s);
  if (err) return err;
  const int S = Sx + Sc;
  if (is_bf16)
    return tc::launch_fused_qkv_tma<joint_qkv_attention>(fused, out, B, S,
                                                         heads, s);
  const int64_t BH = static_cast<int64_t>(B) * heads;
  if (BH > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  return tc::Tf32Tile::launch<joint_qkv_attention, 64>(
      tc::FusedQKVF32<64>{static_cast<const float*>(fused),
                          static_cast<float*>(out), S, heads},
      static_cast<int>(BH), S, S, 0, s);
}
