// K8: 3x3 stride-1 'SAME' convolution in NHWC as an implicit GEMM, with an
// f32 (BN-folded) bias and an optional fused SiLU:
// x [B, H, W, C], w [9, C, CO] (tap-major HWIO) -> y [B, H, W, CO].
//
// Replaces: bsc_nav_tpu/ops/conv2d.py `conv3x3_s1` (`_kernel`).  The JAX
// package dispatches it nowhere (YOLO-World uses lax.conv; the kernel is a
// measured tie on the TPU and cannot compile YOLOv8x's widths 160 and 320);
// the port keeps it as an op, dispatched nowhere either, and measures it
// against cuDNN at YOLOv8x's C2f shapes.
//
// Bound on the H100: arithmetic.  40x40x640->640 at B 8 is
// 2*B*H*W*C*CO*9 = 94 GFLOP against 40 MB of bf16 x, w and y -- ~2,300
// flops per byte: 0.095 ms at the tensor cores' 989 TFLOP/s in bf16,
// 1.41 ms at the CUDA cores' 67 TFLOP/s in f32.
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
// - f32 (conv3x3_s1_kernel) stays on the CUDA cores: on the tensor cores f32
//   would mean TF32, whose 10-bit mantissa breaks the exact-f32 parity the
//   f32 paths are held to.  A block owns a 64-pixel x 64-channel tile and
//   walks K = 9*C in slices of 16, gathering each A slice straight from x
//   (tap = k / C, channel = k % C, zero outside the image) and the matching
//   rows of w into shared memory; each of its 256 threads accumulates a 4x4
//   sub-tile in registers.
// Every edge is masked in both, so any C, CO, H and W are taken.
// Accumulation is f32 (bf16 products are exact in it), then bias, SiLU
// (x * sigmoid(x)) and one store in x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // K slice per step
constexpr int kThreads = 256;
// A (and B) elements each thread stages per K slice
constexpr int kLoads = BM * BK / kThreads;

__global__ void __launch_bounds__(kThreads)
    conv3x3_s1_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int B, int H, int W, int C, int CO, int silu) {
  __shared__ __align__(16) float As[BK][BM + 4];   // [k][pixel]
  __shared__ __align__(16) float Bs[BK][BN + 4];   // [k][out channel]
  const int tid = threadIdx.x;
  const int64_t M = static_cast<int64_t>(B) * H * W;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;

  // A staging: element e = tid + i * 256 holds k = e % BK, pixel e / BK
  const int a_k = tid % BK;
  int a_b[kLoads], a_h[kLoads], a_w[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int64_t m = m0 + (tid + i * kThreads) / BK;
    if (m < M) {
      a_w[i] = static_cast<int>(m % W);
      const int64_t t = m / W;
      a_h[i] = static_cast<int>(t % H);
      a_b[i] = static_cast<int>(t / H);
    } else {
      a_b[i] = -1;
      a_h[i] = a_w[i] = 0;
    }
  }
  // B staging: element e = tid + i * 256 holds channel e % BN, k e / BN
  const int b_n = tid % BN;

  const int tx = tid % 16, ty = tid / 16;   // 4 channels x 4 pixels each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int ka = k0 + a_k;
    const int tap = ka / C, c = ka - (ka / C) * C;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int hh = a_h[i] + dy, ww = a_w[i] + dx;
      float val = 0.f;
      if (a_b[i] >= 0 && ka < K && hh >= 0 && hh < H && ww >= 0 && ww < W)
        val = x[((static_cast<int64_t>(a_b[i]) * H + hh) * W + ww) * C + c];
      As[a_k][(tid + i * kThreads) / BK] = val;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int kk = (tid + i * kThreads) / BN;
      const int kb = k0 + kk, n = n0 + b_n;
      Bs[kk][b_n] = (kb < K && n < CO)
                        ? w[static_cast<int64_t>(kb) * CO + n]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= CO) continue;
      float v = acc[i][j] + bias[n];
      if (silu) v = v * (1.f / (1.f + expf(-v)));
      y[m * CO + n] = v;
    }
  }
}

int launch(const void* x, const void* w, const void* bias, void* y, int B,
           int H, int W, int C, int CO, int silu, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(B) * H * W;
  const int64_t gx = (M + BM - 1) / BM;
  const int gy = (CO + BN - 1) / BN;
  if (gx > 0x7fffffff || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_s1_kernel<<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0,
                      stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), B, H, W, C,
      CO, silu);
  return static_cast<int>(cudaGetLastError());
}

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
  return static_cast<int>(cudaGetLastError());
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
// then 16-byte aligned); bias [CO] f32; y [B, H, W, CO] like x.  silu != 0
// applies x*sigmoid(x).  Launches on `stream`; returns the first CUDA
// error, or 0.
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
  return launch(x, w, bias, y, B, H, W, C, CO, silu, s);
}
