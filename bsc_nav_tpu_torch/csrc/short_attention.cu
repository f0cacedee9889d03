// K3: softmax attention over separate q, k, v buffers [BH, S, hd], with an
// optional square causal mask, written to [BH, Sq, hd].
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `short_attention`
// (`_short_kernel`), reached from `attention()` for every sequence of at
// most 640 keys that the fused-QKV kernel does not take: both CLIP towers
// (MetaCLIP ViT-H vision, 16 heads x 80, S = 257; text, 16 heads x 64,
// S = 77, causal) and the SD3 CLIP text encoders.
//
// Bound on the H100: the vision tower at B = 12 is 4*B*H*S^2*hd = 4.06
// GFLOP per layer.  In f32 it moves 63 MB of q, k, v and out, and its
// products, each taken as three TF32 products to keep f32 accuracy, run
// at 495 / 3 = 165 TFLOP/s: 0.0246 ms against 0.0189 ms of bytes, so the
// products bound it.  In bf16 the same call moves 32 MB (~130 flops per
// byte, under the card's ~295), so the bytes bound it: 0.0094 ms at 3.35
// TB/s, against 0.0041 ms for the products at 989 TFLOP/s.  Calls this
// short are bound in practice by the launch, each block's prologue and
// the tail of the last wave.
//
// Design: the TPU kernel holds a whole (batch, head) in VMEM and runs one
// softmax over it.  Here the launcher chooses by dtype; both dtypes run
// two warpgroups of 64 query rows per block over 64-key K/V tiles:
// - bf16 runs the tensor-core tile of attention_mma.cuh (wgmma, f32
//   accumulators, P rounded to bf16 before P.V and held to the plain
//   version by flash_attention_bf16_tolerance, as K5 and K6 in bf16).
//   Short sequences leave query rows of the last 64-row warpgroup empty
//   (S 257: one live row of 64; causal S 77: 13); such a warpgroup skips
//   its arithmetic but its block still stages the K/V ring.  Blocks of
//   one warpgroup were measured against these at K3's shapes and left
//   out: under 10% apart, and not the same way in every run (PERF.md).
// - f32 runs the tile of attention_tf32.cuh with its Contiguous policy:
//   S = QK^T on wgmma, and P.V on wgmma at hd 64 (text towers: V split
//   once per block by a producer warpgroup) and on mma.sync at hd 80
//   (vision), every f32 product as three TF32 products (a_lo b_hi + a_hi
//   b_lo + a_hi b_hi), so it is held to
//   its plain version by the same 2e-5 abs as before; S 257 gives 3 q
//   tiles, 576 blocks at B 12 x 16 heads.
#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {
struct short_attention {};   // names the kernels in a profile
}  // namespace

// q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], contiguous and
// 16-byte aligned, f32 (or bf16 when is_bf16); hd % 16 == 0 and hd <= 128;
// causal needs Sq == Sk.  Returns the first CUDA error, or 0.
extern "C" int short_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int hd, int causal,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!attention_args_ok(BH, Sq, Sk, hd, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return tc::launch_attention_mma<short_attention>(q, k, v, out, BH, Sq, Sk,
                                                     hd, causal, s);
  return tc::launch_attention_tf32<short_attention>(q, k, v, out, BH, Sq, Sk,
                                                    hd, causal, s);
}
