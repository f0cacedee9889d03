// K8: 3x3 stride-1 'SAME' convolution in NHWC as an implicit GEMM, with an
// f32 (BN-folded) bias and an optional fused SiLU:
// x [B, H, W, C], w [9, C, CO] (tap-major HWIO) -> y [B, H, W, CO].
//
// Replaces: bsc_nav_tpu/ops/conv2d.py `conv3x3_s1` (`_kernel`).  The JAX
// package dispatches it nowhere (YOLO-World uses lax.conv; the kernel is a
// measured tie on the TPU and cannot compile YOLOv8x's widths 160 and 320);
// the port sends YOLO-World's f32 3x3 stride-1 convs here
// (models/yolo_world.py conv_bn_act, BN folded at load), where it beats
// cuDNN f32, and measures both dtypes against cuDNN at the model's shapes.
//
// Bound on the H100: arithmetic.  40x40x640->640 at B 8 is
// 2*B*H*W*C*CO*9 = 94 GFLOP against 40 MB of bf16 x, w and y -- ~2,300
// flops per byte: 0.095 ms at the tensor cores' 989 TFLOP/s in bf16; in
// f32, three TF32 products per product at 495 TFLOP/s, 0.572 ms.
//
// Design: the TPU kernel DMAs a (TH+2)-row halo strip into VMEM and runs
// nine [TH*W, C] x [C, CO] matmuls on the MXU; it needs C and CO in
// multiples of 128 lanes and H % TH == 0.  Here the product is the GEMM
// [B*H*W, 9*C] x [9*C, CO] whose A operand is never built, and the
// launcher chooses the kernel by dtype alone:
// - bf16 (conv3x3_s1_mma_kernel) runs on the tensor cores.  A block owns a
//   128-pixel x 160-channel output tile (160 divides YOLOv8x's 160, 320 and
//   640, so they have no N tail); its 8 warps (2 x 4) each own 64 x 40 and
//   run mma.sync m16n8k16 with f32 accumulators on fragments loaded by
//   ldmatrix.  K is walked tap by tap and, within a tap, in 32-channel
//   slices, so an A slice is a run of contiguous channels of one shifted
//   pixel: a thread's pixels are decoded once, and each slice is copied by
//   cp.async (16, 8 or 4 bytes, as C and CO allow; element loads for an
//   odd width) into a ring of 4 shared-memory stages that the copies fill
//   while the tensor cores work on an earlier stage.  A shifted pixel
//   outside the image or past B*H*W, channels past C and columns past CO
//   are zero-filled in shared memory, never padded in device memory.  Rows
//   are padded by 16 bytes, so ldmatrix reads are free of bank conflicts.
//   The epilogue adds the f32 bias, applies SiLU and stores bf16 pairs.
//   What holds it back from the bound is the warp-level product itself:
//   mma.sync moves every operand through registers by ldmatrix and issues
//   less work per instruction than wgmma; two warpgroups on wgmma
//   m64n160k16 are the next step.
// - f32 (conv3x3_s1_tf32_kernel) runs on the tensor cores too, every
//   product as three TF32 products (a_lo b_hi + a_hi b_lo + a_hi b_hi,
//   tf32.cuh, as K1, K3, K5 and K6 take their f32 products), which keeps
//   f32's error where one TF32 product would not.  The walk is bf16's: a
//   block owns a 128-pixel x 128-channel tile and walks K tap by tap in
//   32-channel slices, halo and tails zero-filled.  Its two warpgroups
//   each take 64 pixels x 128 channels on wgmma m64n128k8 .tf32, both
//   operands in shared memory as K-major core matrices (TF32 wgmma takes
//   no transpose).  A slice is copied by cp.async, as it is in device
//   memory (16-byte runs: a pixel's channels, a row of w[tap]), into a
//   landing stage, and each thread splits the floats it copied, once per
//   stage, into the stage the products read: hi = rna(x), lo = rna(x -
//   hi), A at its place and B into its transpose (8-row groups padded by
//   16 bytes, so a warp's 32 scattered floats hit 32 banks).  No
//   fragment read repeats the split, and no barrier is added: a thread
//   reads only what it copied, and the one barrier per slice publishes
//   the split stage.  A stage is 3 passes of 4 k8 steps into a zeroed
//   accumulator (the tensor cores truncate the sums they accumulate; one
//   accumulator over K = 9 x 640 would lose half the f32 bound), added
//   to the result in f32 when the products are done; while they run,
//   the threads copy the slice after next and split the next one.  Two
//   split and two landing stages, 193 KB: one block of 256 threads per
//   SM, 212 registers a thread; 128 x 128 tiles give 500 blocks at 40^2
//   x 640 (3.8 waves), 125 at 20^2 x 640.  What holds it at ~0.4 of its
//   bound there (variants timed on the H100 with one part left out; no
//   device profiler runs there): the products with their per-slice
//   barrier and accumulator take the largest share, the split the next,
//   the copies little; eight warps per SM overlap them only in part.
//   Splitting w once per call in device memory, A from registers, or
//   deeper copy rings were measured no faster (PERF.md, section 6).
// Every edge is masked in both, so any C, CO, H and W are taken.
// Accumulation is f32 (bf16 products are exact in it), then bias, SiLU
// (x * sigmoid(x)) and one store in x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tf32.cuh"

extern "C" {
long long bsc_tile_launches[kTileKinds] = {};
extern const int bsc_tile_kinds = kTileKinds;   // the array's length
}

namespace {

// ---------------------------------------------------------------------------
// f32: tensor cores, three TF32 products per product
// ---------------------------------------------------------------------------

namespace tf {

constexpr int BM = 128, BN = 128, BK = 32;   // block tile and K slice
constexpr int THREADS = 256;                 // two warpgroups of 64 pixels
constexpr int CH = BK / 4;                   // 16-byte core columns along K
// A (pixels) and B (output channels) as K-major 8-row x 16-byte core
// matrices: row r, float c at ((r/8) * SBO + c/4 * 32 + (r%8) * 4 + c%4);
// B's 8-row groups are padded by 16 bytes, so that the 32 floats a warp
// writes at once into its transpose fall in 32 banks
constexpr int SBO_A = CH * 32, SBO_B = CH * 32 + 4;   // floats
constexpr int A_SZ = BM / 8 * SBO_A, B_SZ = BN / 8 * SBO_B;
constexpr int SPLIT = 2 * (A_SZ + B_SZ);     // A hi | A lo | B hi | B lo
constexpr int LAND = A_SZ + BK * BN;         // A as copied | B as copied
// two split stages (the one the products read, the next) and two landing
// stages (the next, the one after it in flight)
constexpr size_t SMEM = sizeof(float) * 2 * (SPLIT + LAND);
static_assert(SMEM <= 232448, "over a block's 227 KB");

// d (m64n128, f32) = A B (+ d when scale_d): A and B TF32 in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// hi = rna(x) at dst and lo = rna(x - hi) at dst + lo, for the VEC floats
// at src
template <int VEC>
__device__ __forceinline__ void split_run(const float* src, float* dst,
                                          int lo) {
  float v[VEC];
  uint32_t h[VEC], l[VEC];
  if constexpr (VEC == 4) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = src[e];
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) tc::tf32_split(v[e], h[e], l[e]);
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + lo) = make_uint4(l[0], l[1], l[2], l[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      dst[e] = __uint_as_float(h[e]);
      dst[lo + e] = __uint_as_float(l[e]);
    }
  }
}

// VEC, BVEC: floats per A and B copy, 4 (C, CO % 4 == 0 and x, w 16-byte
// aligned) or 1
template <int VEC, int BVEC>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_s1_tf32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ y, int H, int W, int C,
                           int CO, int M, int silu, int n_ntiles) {
  constexpr int A_RUN = BK / VEC;        // copies per pixel slice
  constexpr int A_PER = A_RUN / 2;       // A copies per thread and stage
  constexpr int B_PER = BK * BN / 4 / THREADS;   // B copies (16 bytes)
  extern __shared__ __align__(16) float smem_f[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warp-uniform for ptxas (see attention_wgmma_kernel)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), w4 = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = static_cast<int>(blockIdx.x / n_ntiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_ntiles) * BN;

  // A copies: unit u = warp + 8 q is VEC-channel run 4 (u / 16) + lane / 8
  // of pixel 8 (u % 16) + lane % 8, so a quarter-warp fills one 128-byte
  // core matrix and a warp reads 8 pixels' runs; a thread's pixels are
  // 8 warp + lane % 8 and that + 64, decoded once (flat index, -1 past
  // M; packed (h, w))
  int pix[2], hw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 8 * warp + 64 * i + (lane & 7);
    pix[i] = m < M ? m : -1;
    const int mw = m % W, mh = (m / W) % H;
    hw[i] = (mh << 16) | mw;
  }
  // the offset of A copy q in a stage's A (core layout), and its channel
  auto a_chan = [&](int q) {
    return (4 * ((warp + 8 * q) / 16) + (lane >> 3)) * VEC;
  };
  auto a_off = [&](int q) {
    const int r = 8 * ((warp + 8 * q) % 16) + (lane & 7), c = a_chan(q);
    return (r / 8) * SBO_A + c / 4 * 32 + (r % 8) * 4 + c % 4;
  };
  // B copies: unit u = warp + 8 q is K row 4 (u / 4) + lane / 8 of w[tap]'s
  // slice, output channels 4 (8 (u % 4) + lane % 8) .. + 3 (one 16-byte
  // run; a warp reads four 128-byte runs); its landing offset and its row
  auto b_row = [&](int q) { return 4 * ((warp + 8 * q) / 4) + (lane >> 3); };
  auto b_col = [&](int q) {
    return 4 * (8 * ((warp + 8 * q) % 4) + (lane & 7));
  };

  const int n_cs = (C + BK - 1) / BK;   // channel slices per tap
  const int n_steps = 9 * n_cs;
  auto load = [&](int step) {
    float* La = smem_f + 2 * SPLIT + (step % 2) * LAND;
    float* Lb = La + A_SZ;
    const int tap = step / n_cs;
    const int c0 = (step - tap * n_cs) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int i = q & 1;   // unit warp + 8 q: pixel group warp + 8 (q % 2)
      const int ch = c0 + a_chan(q);
      const int hh = (hw[i] >> 16) + dy, ww = (hw[i] & 0xffff) + dx;
      const bool ok = pix[i] >= 0 && ch < C && hh >= 0 && hh < H &&
                      ww >= 0 && ww < W;
      const float* src =
          ok ? x + static_cast<int64_t>(pix[i] + dy * W + dx) * C + ch : x;
      tc::cp_async<4 * VEC>(La + a_off(q), src, ok);
    }
#pragma unroll
    for (int q = 0; q < B_PER; ++q) {
      const int k = c0 + b_row(q);
#pragma unroll
      for (int j = 0; j < 4; j += BVEC) {
        const int n = n0 + b_col(q) + j;
        const bool ok = k < C && n < CO;   // BVEC 4: CO % 4 == 0
        const float* src =
            ok ? w + static_cast<int64_t>(tap * C + k) * CO + n : w;
        tc::cp_async<4 * BVEC>(Lb + b_row(q) * BN + b_col(q) + j, src, ok);
      }
    }
  };
  // the floats this thread copied for a stage (landed), split into the
  // stage: A hi | lo at their offsets, B hi | lo transposed into its core
  // matrices, then fenced for wgmma's reads
  auto split = [&](int step) {
    const float* La = smem_f + 2 * SPLIT + (step % 2) * LAND;
    const float* Lb = La + A_SZ;
    float* Sa = smem_f + (step % 2) * SPLIT;
    float* Sb = Sa + 2 * A_SZ;
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int off = a_off(q);
      split_run<VEC>(La + off, Sa + off, A_SZ);
    }
#pragma unroll
    for (int q = 0; q < B_PER; ++q) {
      const int k = b_row(q), n = b_col(q);
      const float4 v = *reinterpret_cast<const float4*>(Lb + k * BN + n);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = ((n + j) / 8) * SBO_B + k / 4 * 32 +
                        ((n + j) % 8) * 4 + k % 4;
        uint32_t hi, lo;
        tc::tf32_split(e[j], hi, lo);
        Sb[off] = __uint_as_float(hi);
        Sb[off + B_SZ] = __uint_as_float(lo);
      }
    }
    tc::fence_proxy_async();
  };

  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  load(0);
  tc::cp_async_commit();
  load(1);   // n_steps >= 9
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  split(0);
  for (int step = 0; step < n_steps; ++step) {
    __syncthreads();   // stage step split by all; step - 1's products done
    {
      const float* Ah = smem_f + (step % 2) * SPLIT + wg * 8 * SBO_A;
      const float* Bh = smem_f + (step % 2) * SPLIT + 2 * A_SZ;
      const uint64_t ah = tc::gmma_desc(Ah, 128, 4 * SBO_A);
      const uint64_t al = tc::gmma_desc(Ah + A_SZ, 128, 4 * SBO_A);
      const uint64_t bh = tc::gmma_desc(Bh, 128, 4 * SBO_B);
      const uint64_t bl = tc::gmma_desc(Bh + B_SZ, 128, 4 * SBO_B);
      // three passes over the slice's K, small terms first, into a zeroed
      // accumulator; a k8 step is two core matrices, 256 bytes, on
      tc::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc)
        wgmma_tf32_m64n128(part, al + 16 * kc, bh + 16 * kc, kc);
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc)
        wgmma_tf32_m64n128(part, ah + 16 * kc, bl + 16 * kc, 1);
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc)
        wgmma_tf32_m64n128(part, ah + 16 * kc, bh + 16 * kc, 1);
      tc::wgmma_commit();
    }
    // under the products: the copies of the stage after next (into the
    // landing stage this thread's split of step emptied) and the split
    // of the next
    if (step + 2 < n_steps) load(step + 2);
    tc::cp_async_commit();   // empty groups keep the count uniform
    if (step + 1 < n_steps) {
      tc::cp_async_wait<1>();   // this thread's copies of step + 1
      split(step + 1);
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(part);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
  }
  tc::cp_async_wait<0>();   // no copy outlives the block

  // acc[4 j + 2 h + e]: row 16 w4 + g + 8 h of the warpgroup's 64, output
  // channel 8 j + 2 t4 + e
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
    if (n >= CO) continue;
    const bool pair = n + 1 < CO;
    const float b0 = bias[n], b1 = pair ? bias[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * w4 + g + 8 * h;
      if (m >= M) continue;
      float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (silu) {
        v0 = v0 * (1.f / (1.f + expf(-v0)));
        v1 = v1 * (1.f / (1.f + expf(-v1)));
      }
      float* dst = y + static_cast<int64_t>(m) * CO + n;
      if (pair && CO % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (pair) dst[1] = v1;
      }
    }
  }
}

template <int VEC, int BVEC>
int launch_vec(const void* x, const void* w, const void* bias, void* y,
               int H, int W, int C, int CO, int M, int silu,
               cudaStream_t stream) {
  auto kernel = conv3x3_s1_tf32_kernel<VEC, BVEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ntiles = (CO + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>((M + BM - 1) / BM) * n_ntiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, C, CO, M,
      silu, n_ntiles);
  return counted_launch(kTileConvTf32);
}

template <int BVEC>
int launch_b(const void* x, const void* w, const void* bias, void* y, int H,
             int W, int C, int CO, int M, int silu, cudaStream_t stream) {
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_vec<4, BVEC>(x, w, bias, y, H, W, C, CO, M, silu, stream);
  return launch_vec<1, BVEC>(x, w, bias, y, H, W, C, CO, M, silu, stream);
}

// A's and B's copies take 4 floats where C (CO) and x's (w's) address
// allow, else 1: any f32 view is taken
int launch(const void* x, const void* w, const void* bias, void* y, int B,
           int H, int W, int C, int CO, int silu, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(B) * H * W;
  // flat pixel indices, shifted by up to W + 1 and rounded up to a block,
  // stay in int; (h, w) pack into 16 bits each
  if (M > 0x7fffffff - (1 << 17) || H >= (1 << 15) || W >= (1 << 16) ||
      reinterpret_cast<uintptr_t>(x) % 4 || reinterpret_cast<uintptr_t>(w) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(M);
  if (CO % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    return launch_b<4>(x, w, bias, y, H, W, C, CO, m, silu, stream);
  return launch_b<1>(x, w, bias, y, H, W, C, CO, m, silu, stream);
}

}  // namespace tf

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tcv {

using tc::bf16;
constexpr int BM = 128, BN = 160, BK = 32;   // block tile and K slice
constexpr int STAGES = 4;                    // shared-memory ring depth
constexpr int WM = 64, WN = 40;              // warp tile
constexpr int WARPS_N = BN / WN;
constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
constexpr int LDA = BK + 8, LDB = BN + 8;    // padded rows, elements
constexpr int STAGE = BM * LDA + BK * LDB;   // elements per stage
constexpr size_t SMEM = sizeof(bf16) * STAGES * STAGE;

// copy VEC bf16 (2 * VEC bytes) global -> shared, zeros when !ok
template <int VEC>
__device__ __forceinline__ void copy(bf16* dst, const bf16* src, bool ok) {
  if constexpr (VEC == 1)
    *dst = ok ? *src : __float2bfloat16(0.f);
  else
    tc::cp_async<2 * VEC>(dst, src, ok);
}

// VEC: channels per copy, dividing both C and CO (8, 4, 2 or 1)
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    conv3x3_s1_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias,
                          bf16* __restrict__ y, int H, int W, int C, int CO,
                          int M, int silu, int n_ntiles) {
  constexpr int A_RUN = BK / VEC;               // copies per pixel slice
  constexpr int A_PER = BM * A_RUN / THREADS;   // pixels per thread
  constexpr int B_RUN = BN / VEC;               // copies per weight row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = static_cast<int>(blockIdx.x / n_ntiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_ntiles) * BN;

  // this thread's A copies: channel run a_c of pixels a_p + i * (THREADS /
  // A_RUN), decoded once: flat index (-1 past M) and packed (h, w)
  const int a_c = (tid % A_RUN) * VEC;
  const int a_p = tid / A_RUN;
  int pix[A_PER], hw[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int m = m0 + a_p + i * (THREADS / A_RUN);
    pix[i] = m < M ? m : -1;
    const int mw = m % W, mh = (m / W) % H;
    hw[i] = (mh << 16) | mw;
  }

  const int n_cs = (C + BK - 1) / BK;   // channel slices per tap
  const int n_steps = 9 * n_cs;
  auto load = [&](int step) {
    bf16* As = smem + (step % STAGES) * STAGE;
    bf16* Bs = As + BM * LDA;
    const int tap = step / n_cs;
    const int c0 = (step - tap * n_cs) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int ch = c0 + a_c;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int hh = (hw[i] >> 16) + dy, ww = (hw[i] & 0xffff) + dx;
      const bool ok = pix[i] >= 0 && ch < C && hh >= 0 && hh < H &&
                      ww >= 0 && ww < W;
      const bf16* src =
          ok ? x + static_cast<int64_t>(pix[i] + dy * W + dx) * C + ch : x;
      copy<VEC>(As + (a_p + i * (THREADS / A_RUN)) * LDA + a_c, src, ok);
    }
    for (int i = tid; i < BK * B_RUN; i += THREADS) {
      const int kk = i / B_RUN, nn = (i - kk * B_RUN) * VEC;
      const bool ok = c0 + kk < C && n0 + nn < CO;
      const bf16* src =
          ok ? w + static_cast<int64_t>(tap * C + c0 + kk) * CO + n0 + nn : w;
      copy<VEC>(Bs + kk * LDB + nn, src, ok);
    }
  };

  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    tc::cp_async_commit();   // empty groups keep the count uniform
  }
  for (int step = 0; step < n_steps; ++step) {
    tc::cp_async_wait<STAGES - 2>();   // this step's slice has landed
    __syncthreads();                   // ... for all; step-1 is consumed
    if (step + STAGES - 1 < n_steps) load(step + STAGES - 1);
    tc::cp_async_commit();
    const bf16* As = smem + (step % STAGES) * STAGE + wm * WM * LDA;
    const bf16* Bs = smem + (step % STAGES) * STAGE + BM * LDA + wn * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[WM / 16][4], bfr[WN / 8][2];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        tc::ldsm_x4(af[i], As + (16 * i + (lane & 15)) * LDA + kk +
                               8 * (lane >> 4));
      const bf16* brow = Bs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB;
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, brow + 16 * j + 8 * (lane >> 4));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
      if constexpr (WN % 16 != 0) {   // the last n8 tile of 40
        uint32_t r[2];
        tc::ldsm_x2_t(r, brow + WN - 8);
        bfr[WN / 8 - 1][0] = r[0];
        bfr[WN / 8 - 1][1] = r[1];
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
          tc::mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  tc::cp_async_wait<0>();   // no copy outlives the block

#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int n = n0 + wn * WN + 8 * j + 2 * t4;
    if (n >= CO) continue;
    const bool pair = n + 1 < CO;
    const float b0 = bias[n], b1 = pair ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < WM / 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + 16 * i + g + 8 * h;
        if (m >= M) continue;
        float v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
        if (silu) {
          v0 = v0 * (1.f / (1.f + expf(-v0)));
          v1 = v1 * (1.f / (1.f + expf(-v1)));
        }
        bf16* dst = y + static_cast<int64_t>(m) * CO + n;
        if (pair && CO % 2 == 0)
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        else {
          dst[0] = __float2bfloat16(v0);
          if (pair) dst[1] = __float2bfloat16(v1);
        }
      }
  }
}

template <int VEC>
int launch_vec(const void* x, const void* w, const void* bias, void* y,
               int H, int W, int C, int CO, int M, int silu,
               cudaStream_t stream) {
  auto kernel = conv3x3_s1_mma_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ntiles = (CO + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>((M + BM - 1) / BM) * n_ntiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y), H, W, C, CO, M,
      silu, n_ntiles);
  return counted_launch(kTileConvMma);
}

// x and w 16-byte aligned; the copy width is the largest of 8, 4, 2, 1
// channels that divides both C and CO
int launch(const void* x, const void* w, const void* bias, void* y, int B,
           int H, int W, int C, int CO, int silu, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(B) * H * W;
  // flat pixel indices, shifted by up to W + 1 and rounded up to a block,
  // stay in int; (h, w) pack into 16 bits each
  if (M > 0x7fffffff - (1 << 17) || H >= (1 << 15) || W >= (1 << 16) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(M);
  switch ((C | CO) & -(C | CO)) {   // the lowest set bit of both
    case 1: return launch_vec<1>(x, w, bias, y, H, W, C, CO, m, silu, stream);
    case 2: return launch_vec<2>(x, w, bias, y, H, W, C, CO, m, silu, stream);
    case 4: return launch_vec<4>(x, w, bias, y, H, W, C, CO, m, silu, stream);
    default:
      return launch_vec<8>(x, w, bias, y, H, W, C, CO, m, silu, stream);
  }
}

}  // namespace tcv

}  // namespace

// x [B, H, W, C] and w [9, C, CO] contiguous, f32 (or bf16 when is_bf16,
// then 16-byte aligned); bias [CO] f32; y [B, H, W, CO] like x.  silu != 0 applies x*sigmoid(x).  Launches on
// `stream`; returns the first CUDA error, or 0.
extern "C" int conv3x3_s1_launch(const void* x, const void* w,
                                 const void* bias, void* y, int B, int H,
                                 int W, int C, int CO, int silu, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || CO <= 0 ||
      static_cast<int64_t>(9) * C > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return tcv::launch(x, w, bias, y, B, H, W, C, CO, silu, s);
  return tf::launch(x, w, bias, y, B, H, W, C, CO, silu, s);
}
