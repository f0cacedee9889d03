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
// flops per byte -- and this kernel runs them on the CUDA cores in f32
// (67 TFLOP/s peak), not on the tensor cores.
//
// Design: the TPU kernel DMAs a (TH+2)-row halo strip into VMEM and runs
// nine [TH*W, C] x [C, CO] matmuls on the MXU; it needs C and CO in
// multiples of 128 lanes and H % TH == 0.  Here the product is the GEMM
// [B*H*W, 9*C] x [9*C, CO] whose A operand is never built: a block owns a
// 64-pixel x 64-channel output tile and walks K = 9*C in slices of 16,
// gathering each A slice straight from x (tap = k / C, channel = k % C,
// zero outside the image) and the matching rows of w into shared memory
// as f32; each of its 256 threads accumulates a 4x4 sub-tile in registers.
// Every edge -- pixels past B*H*W, channels past CO, K past 9*C -- is
// masked, so any C, CO, H and W are taken.  A thread's four gathered
// pixels are fixed for the whole walk, so their (b, h, w) are decoded once.
// Accumulation is f32 (bf16 products are exact in it), then bias, SiLU
// (x * sigmoid(x)) and one store in x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // K slice per step
constexpr int kThreads = 256;
// A (and B) elements each thread stages per K slice
constexpr int kLoads = BM * BK / kThreads;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_s1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
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
        val = to_f(x[((static_cast<int64_t>(a_b[i]) * H + hh) * W + ww) * C +
                     c]);
      As[a_k][(tid + i * kThreads) / BK] = val;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int kk = (tid + i * kThreads) / BN;
      const int kb = k0 + kk, n = n0 + b_n;
      Bs[kk][b_n] = (kb < K && n < CO)
                        ? to_f(w[static_cast<int64_t>(kb) * CO + n])
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
      put(y + m * CO + n, v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* y, int B,
           int H, int W, int C, int CO, int silu, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(B) * H * W;
  const int64_t gx = (M + BM - 1) / BM;
  const int gy = (CO + BN - 1) / BN;
  if (gx > 0x7fffffff || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_s1_kernel<T><<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), B, H, W, C, CO,
      silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C] and w [9, C, CO] contiguous, f32 (or bf16 when is_bf16);
// bias [CO] f32; y [B, H, W, CO] like x.  silu != 0 applies x*sigmoid(x).
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int conv3x3_s1_launch(const void* x, const void* w,
                                 const void* bias, void* y, int B, int H,
                                 int W, int C, int CO, int silu, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || CO <= 0 ||
      static_cast<int64_t>(9) * C > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, bias, y, B, H, W, C, CO, silu, s);
  return launch<float>(x, w, bias, y, B, H, W, C, CO, silu, s);
}
