// K6: blockwise online-softmax attention over separate q, k, v buffers
// [BH, S, hd] with an optional square causal mask, written to [BH, Sq, hd],
// for sequences whose [B, H, Sq, Sk] f32 logits would pass 4e9 bytes.
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `flash_attention`
// (`_flash_kernel`), reached from `attention()` when B*H*Sq*Sk*4 > 4e9 and
// the sequence is causal or longer than 4096 keys: the MMDiT's composed
// joint attention at SD3.5-medium's 1024^2 (B 6, 24 heads x 64,
// S = 4096 + 589 = 4685, whose logits would be 12.6 GB).
//
// Bound on the H100: arithmetic.  The 1024^2 joint call is
// 4*B*H*S^2*hd = 809 GFLOP against 86 MB of bf16 q, k, v and out --
// ~9,400 flops per byte -- and this kernel runs them on the CUDA cores in
// f32 (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16).
//
// Design: the TPU kernel runs a (B*H, Sq/bq) grid of programs that each
// carry an online softmax over K/V blocks of at most 128 keys, padded to
// the block size.  Here the shared tile kernel of attention_tile.cuh does
// the same with 64-key tiles in shared memory and 8 query rows per warp
// (64 per block), masks the ragged last q and key tiles instead of padding,
// runs the causal mask tile by tile (a block stops at its last row's tile,
// and the longest rows are scheduled first), and decodes (batch*head,
// q tile) from a one-dimensional grid, so B*H is not bound by the 65,535
// limit of a second grid dimension.
#include "attention_tile.cuh"

namespace {
struct flash_attention {};   // names the kernel in a profile
}  // namespace

// q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], as
// launch_attention; causal needs Sq == Sk.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int hd, int causal,
                                      int is_bf16, void* stream) {
  return launch_attention<flash_attention, 8>(q, k, v, out, BH, Sq, Sk, hd,
                                              causal, is_bf16, stream);
}
