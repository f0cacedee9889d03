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
// ~9,400 flops per byte: 0.82 ms at the tensor cores' 989 TFLOP/s in
// bf16, 4.90 ms in f32 at 165 TFLOP/s (three TF32 products per f32
// product, a third of the TF32 rate).
//
// Design: the TPU kernel runs a (B*H, Sq/bq) grid of programs that each
// carry an online softmax over K/V blocks of at most 128 keys, padded to
// the block size.  Here both dtypes keep that online softmax over 64-key
// tiles (128 in bf16 at head_dim 64), mask the ragged last q and key tiles
// instead of padding, run the causal mask tile by tile (a block stops at
// its last row's tile, and the longest rows are scheduled first), and
// decode (batch*head, q tile) from a one-dimensional grid, so B*H is not
// bound by the 65,535 limit of a second grid dimension.  The launcher
// chooses by dtype and head_dim alone, as K5's does:
// - bf16 at head_dim 64 (every main path's) runs attention_tma.cuh: a
//   producer warpgroup loads Q and 128-key K/V tiles by TMA into an
//   mbarrier ring, three consumer warpgroups of 64 query rows take the
//   tensor cores in turn (wgmma, f32 accumulators, the softmax in
//   registers while the previous tile's P.V runs), one block per SM
//   walking the (q tile, head) items unless causal.  Other head_dims run
//   attention_mma.cuh's tile (two warpgroups, 64-key tiles by cp.async).
//   Both round P to bf16 before P.V, as the JAX package's reference does
//   on a TPU.  Their bound is the tensor cores and the softmax's
//   exponentials together (see the headers).
// - f32 runs the tile of attention_tf32.cuh with its Contiguous policy:
//   every f32 product as three TF32 products (a_lo b_hi + a_hi b_lo +
//   a_hi b_hi), which keeps f32's accuracy (the f32 paths' 2e-5 abs);
//   S = QK^T and, at hd <= 64, P.V on wgmma from a V^T split once per
//   block, 74 key tiles per block at S 4685.
#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "attention_tma.cuh"

namespace {
struct flash_attention {};   // names the kernels in a profile
}  // namespace

// q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], contiguous and
// 16-byte aligned, f32 (or bf16 when is_bf16); hd % 16 == 0 and hd <= 128;
// causal needs Sq == Sk.  Returns the first CUDA error, or 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int hd, int causal,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!attention_args_ok(BH, Sq, Sk, hd, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && hd == 64)
    return tc::launch_attention_tma<flash_attention>(q, k, v, out, BH, Sq, Sk,
                                                     causal, s);
  if (is_bf16)
    return tc::launch_attention_mma<flash_attention>(q, k, v, out, BH, Sq, Sk,
                                                     hd, causal, s);
  return tc::launch_attention_tf32<flash_attention>(q, k, v, out, BH, Sq, Sk,
                                                    hd, causal, s);
}
