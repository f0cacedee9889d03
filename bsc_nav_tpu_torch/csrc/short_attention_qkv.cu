// K1: non-causal softmax attention read straight from the fused qkv
// projection [B, S, 3*D] (q | k | v column groups, heads contiguous in
// each group), written to [B, S, D].
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `short_attention_qkv`
// (`_qkv_kernel_3in`), dispatched by `attention_from_qkv` in every ViT
// layer.
//
// Bound on the H100: at the ViT-L shapes (S = 261, 16 heads x 64) one
// layer at B = 8 is 4*B*H*S^2*hd = 2.2 GFLOP.  In bf16 it reads 12.8 MB of
// qkv once and writes 4.3 MB -- ~130 flops per byte, under the card's
// ~295 -- so the bytes bound it (0.0051 ms at 3.35 TB/s against 0.0023 ms
// on the tensor cores).  In f32 it moves 34 MB, and its products, each
// taken as three TF32 products to keep f32 accuracy, run at 495 / 3 = 165
// TFLOP/s: 0.0135 ms against 0.0102 ms of bytes, so the products bound it.
//
// Design: the TPU kernel keeps all of K and V of a head pair resident and
// reads the three column groups of the same array.  Here both dtypes run
// a tensor-core tile with its FusedQKV policy: the tile's cp.async loads
// take a row pointer, and q, k and v rows of (batch, head) sit at column
// offsets h*hd, D + h*hd and 2D + h*hd of rows with a stride of 3D, so the
// tile reads them in place -- no transpose, no separate q/k/v buffers --
// and writes its rows of [B, S, D] at column h*hd.  Two warpgroups x 64
// query rows per block, 64-key K/V tiles; S 261 gives 3 q tiles, 384
// blocks at B 8 x 16 heads.  By dtype:
// - bf16 runs attention_mma.cuh (wgmma for S = QK^T and P.V), with the
//   128-byte swizzle at hd 64 (ViT-L) and 8x8 core matrices at the other
//   head_dims; P is rounded to bf16 before P.V, so it is held to its plain
//   version by flash_attention_bf16_tolerance on the split heads.
// - f32 runs attention_tf32.cuh (S = QK^T and, at hd <= 64, P.V on
//   wgmma, V split once per block by a producer warpgroup; P.V on
//   mma.sync above), every f32 product as three TF32 products (a_lo b_hi
//   + a_hi b_lo + a_hi b_hi), so it is held to its plain version by 2e-5
//   abs; q is scaled by 1/sqrt(hd) rounded once from double, as JAX
//   rounds its Python float.
#include <cuda_runtime.h>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {
struct short_attention_qkv {};   // names the kernels in a profile
}  // namespace

// qkv [B, S, 3*heads*hd] -> out [B, S, heads*hd], both contiguous and
// 16-byte aligned, f32 (or bf16 when is_bf16).  hd % 16 == 0 and
// hd <= 128.  Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int short_attention_qkv_launch(const void* qkv, void* out, int B,
                                          int S, int heads, int hd,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || heads <= 0 || hd <= 0 || hd % 16 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return tc::launch_fused_qkv_mma<short_attention_qkv>(qkv, out, B, S,
                                                         heads, hd, s);
  return tc::launch_fused_qkv_tf32<short_attention_qkv>(qkv, out, B, S,
                                                        heads, hd, s);
}
