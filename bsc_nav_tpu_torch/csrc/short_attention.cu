// K3: softmax attention over separate q, k, v buffers [BH, S, hd], with an
// optional square causal mask, written to [BH, Sq, hd].
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `short_attention`
// (`_short_kernel`), reached from `attention()` for every sequence of at
// most 640 keys that the fused-QKV kernel does not take: both CLIP towers
// (MetaCLIP ViT-H vision, 16 heads x 80, S = 257; text, 16 heads x 64,
// S = 77, causal) and the SD3 CLIP text encoders.
//
// Bound on the H100: arithmetic.  The vision tower at B = 12 is
// 4*B*H*S^2*hd = 4.1 GFLOP per layer against 9.5 MB of q, k, v and out
// in f32 -- ~430 flops per byte -- and this kernel runs them on the CUDA
// cores in f32 (67 TFLOP/s peak), not on the tensor cores.
//
// Design: the TPU kernel holds a whole (batch, head) in VMEM and runs one
// softmax over it.  Here the shared tile kernel of attention_tile.cuh runs
// with 4 query rows per warp (32 per block): short sequences give few q
// tiles, and small tiles keep enough blocks in flight to fill the card.
#include "attention_tile.cuh"

namespace {
struct short_attention {};   // names the kernel in a profile
}  // namespace

extern "C" int short_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int hd, int causal,
                                      int is_bf16, void* stream) {
  return launch_attention<short_attention, 4>(q, k, v, out, BH, Sq, Sk, hd,
                                              causal, is_bf16, stream);
}
