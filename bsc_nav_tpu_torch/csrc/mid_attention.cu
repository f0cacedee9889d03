// K5: non-causal softmax attention over separate q, k, v buffers
// [BH, S, hd] for 640 < Sk <= 4096, written to [BH, Sq, hd].
//
// Replaces: bsc_nav_tpu/ops/flash_attention.py `mid_attention`
// (`_mid_kernel`; tools/mid_attention_exp.py `mid_attention` is the same
// computation), reached from `attention()` for non-causal sequences of
// 641-4096 keys: the MMDiT's composed joint attention without qk-norm
// (SD3-medium at 512^2: B 6, 24 heads x 64, S = 1024 + 589 = 1613) and
// ViTs past ~350 px (DINOv2 at 518^2: 16 heads x 64, S = 1374).
//
// Bound on the H100: the tensor cores, and beside them the exponentials.
// SD3-medium's joint call is 4*B*H*S^2*hd = 95.9 GFLOP against 30 MB of
// bf16 q, k, v and out -- ~3,200 flops per byte, far above the card's
// ~295 -- so 0.097 ms at the 989 TFLOP/s bf16 rate.  Its B*H*S^2 = 3.7e8
// softmax exponentials take ~0.1 ms more on the SMs' MUFU lanes unless
// they overlap the products (attention_mma.cuh's header reckons them).
// In f32 (60 MB) the same call is 0.581 ms at 165 TFLOP/s, a third of the
// TF32 rate: every f32 product taken as three TF32 products.
//
// Design: the TPU kernel keeps a (batch, head)'s whole K/V resident in VMEM
// and runs a one-shot softmax per 256-row q tile.  K/V of 4096 keys (2 MB
// in f32) do not fit a block's 227 KB of shared memory, so both dtypes
// stream them in 64- or 128-key tiles with an online softmax instead,
// which gives the same softmax up to the order of the sums:
// - bf16 at head_dim 64 (every main path's) runs attention_tma.cuh (K6's
//   tile: TMA producer warpgroup, 128-key tiles, three consumer
//   warpgroups of 64 query rows taking the tensor cores in turn, 192 rows
//   a work item: 9 per (batch, head) at S 1613, walked by one block per
//   SM); other head_dims run attention_mma.cuh's tile (wgmma, K/V staged
//   by cp.async).  Both keep the softmax in registers while the previous
//   tile's P.V runs on the tensor cores and round P to bf16 before P.V,
//   as the JAX package's reference does on a TPU, so they are held to the
//   plain version by flash_attention_bf16_tolerance.
// - f32 runs the tile of attention_tf32.cuh with its Contiguous policy (as
//   K3): every f32 product as three TF32 products (a_lo b_hi + a_hi b_lo +
//   a_hi b_hi), S = QK^T and, at hd <= 64, P.V on wgmma from a V^T split
//   once per block; held to its plain version by the f32 paths' 2e-5 abs.
#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "attention_tma.cuh"

namespace {
struct mid_attention {};   // names the kernels in a profile
}  // namespace

// q [BH, Sq, hd], k and v [BH, Sk, hd] -> out [BH, Sq, hd], contiguous and
// 16-byte aligned, f32 (or bf16 when is_bf16); hd % 16 == 0 and hd <= 128;
// never causal.  Returns the first CUDA error, or 0.
extern "C" int mid_attention_launch(const void* q, const void* k,
                                    const void* v, void* out, int BH, int Sq,
                                    int Sk, int hd, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!attention_args_ok(BH, Sq, Sk, hd, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && hd == 64)
    return tc::launch_attention_tma<mid_attention>(q, k, v, out, BH, Sq, Sk,
                                                   0, s);
  if (is_bf16)
    return tc::launch_attention_mma<mid_attention>(q, k, v, out, BH, Sq, Sk,
                                                   hd, 0, s);
  return tc::launch_attention_tf32<mid_attention>(q, k, v, out, BH, Sq, Sk,
                                                  hd, 0, s);
}
