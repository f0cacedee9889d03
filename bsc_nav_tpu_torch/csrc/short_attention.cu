// K3: softmax attention over separate q, k, v buffers [BH, S, hd], with an
// optional square causal mask, written to [BH, Sq, hd].
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `short_attention`
// (`_short_kernel`), reached from `attention()` for every sequence of at
// most 640 keys that the fused-QKV kernel does not take: both CLIP towers
// (MetaCLIP ViT-H vision, 16 heads x 80, S = 257; text, 16 heads x 64,
// S = 77, causal) and the SD3 CLIP text encoders.
//
// Bound on the H100: in f32, arithmetic -- the vision tower at B = 12 is
// 4*B*H*S^2*hd = 4.06 GFLOP per layer against 63 MB of q, k, v and out,
// 0.061 ms at the CUDA cores' 67 TFLOP/s.  In bf16 the same call moves
// 32 MB (~130 flops per byte, under the card's ~295), so the bytes bound
// it: 0.0094 ms at 3.35 TB/s, against 0.0041 ms for the products at 989
// TFLOP/s.  Calls this short are bound in practice by the launch, each
// block's prologue and the tail of the last wave.
//
// Design: the TPU kernel holds a whole (batch, head) in VMEM and runs one
// softmax over it.  Here the launcher chooses by dtype:
// - bf16 runs the tensor-core tile of attention_mma.cuh (wgmma, f32
//   accumulators, P rounded to bf16 before P.V and held to the plain
//   version by flash_attention_bf16_tolerance, as K5 and K6 in bf16).
//   Short sequences leave query rows of the last 64-row warpgroup empty
//   (S 257: one live row of 64; causal S 77: 13); such a warpgroup skips
//   its arithmetic but its block still stages the K/V ring.  Blocks of
//   one warpgroup were measured against these at K3's shapes and left
//   out: under 10% apart, and not the same way in every run (PERF.md).
// - f32 keeps the CUDA-core tile of attention_tile.cuh with 4 query rows
//   per warp (32 per block): short sequences give few q tiles, and small
//   tiles keep enough blocks in flight to fill the card.
#include "attention_mma.cuh"
#include "attention_tile.cuh"

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
  return launch_attention<short_attention, 4>(q, k, v, out, BH, Sq, Sk, hd,
                                              causal, s);
}
