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
// In f32 the same call is 1.43 ms at the CUDA cores' 67 TFLOP/s.
//
// Design: the TPU kernel keeps a (batch, head)'s whole K/V resident in VMEM
// and runs a one-shot softmax per 256-row q tile.  K/V of 4096 keys (2 MB
// in f32) do not fit a block's 227 KB of shared memory, so both dtypes
// stream them in 64-key tiles with an online softmax instead, which gives
// the same softmax up to the order of the sums:
// - bf16 runs the tensor-core tile of attention_mma.cuh (wgmma with f32
//   accumulators, 64 query rows per warpgroup, K/V staged by cp.async in a
//   ring, the softmax in registers while the previous tile's P.V runs on
//   the tensor cores); it rounds P to bf16 before P.V, as the JAX
//   package's reference does on a TPU, so it is held to its plain version
//   by flash_attention_bf16_tolerance.  A sequence of 1613 rows gives 13
//   q tiles per (batch, head), 1,872 blocks at B 6 x 24 heads.
// - f32 keeps the CUDA-core tile of attention_tile.cuh with 8 query rows
//   per warp (64 per block): each K/V tile staged in shared memory serves
//   twice the rows K3's tile does.
#include "attention_mma.cuh"
#include "attention_tile.cuh"

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
  if (is_bf16)
    return tc::launch_attention_mma<mid_attention>(q, k, v, out, BH, Sq, Sk,
                                                   hd, 0, s);
  return launch_attention<mid_attention, 8>(q, k, v, out, BH, Sq, Sk, hd, 0,
                                            s);
}
