// K9: the JAX package's head-width probe on Hopper, sm_90a. Replaces the Pallas TPU
// kernel of scripts/dev/head512_probe.py (kernel :53, pallas_call :83), which asked on the
// TPU whether the 513-wide fused head's lane padding (513 -> 640) was worth removing. On
// Hopper the question is the port's: its sigma is an n16 wgmma layer of its own
// (fused_mlp_fwd.cuh); would a CUDA-core dot of h with the density row, beside the head's
// product, cost less? The modes (dmnerf_tpu_torch/kernels/head_probes.py, whose
// head512_ref is the plain version and head512_operands the table):
//   a  8 x [256, 256] ReLU trunk, then a [256, 513] head: two n256 passes and an n16 one
//   b  the trunk, a [256, 512] head (two n256 passes) and sigma = h . wd on the CUDA cores
//   c  the trunk and the [256, 512] head alone
//   d  the trunk, sigma as its own n16 layer (the port's layout) and the [256, 512] head
// Every head column is computed; 32 are stored ([head[:, :31] | sigma] in b and d).
//
// Bound. At the probe's P = 786,432 points mode c executes 655,360 multiply-accumulates a
// point, 1.031 TFLOP a call: 1.042 ms at the card's 989 TFLOP/s bf16 peak. It moves x (512
// bytes a point in), the out rows (128 bytes out) and 1.3 MB of weights: 503 MB, 0.150 ms
// at 3.35 TB/s. The kernel is bound by its products. Modes a and d execute 4,096 more
// multiply-accumulates a point (+0.6 %), b 256 fp32 FMAs on the CUDA cores.
//
// Design: the forward template's walk (fused_mlp_fwd.cuh, ROWS_H): x arrives by TMA and
// the consumers take it into the registers that chain the activations; the trunk is the
// template's ReLU layers; the head is one layer of the table per 256 columns over the
// same h, whose epilogue writes its window of columns (or nothing) and leaves h as it is.

#include "fused_mlp_fwd.cuh"

// `x` [P, 256] bf16; `edt` must be null (edt_rows 0); `wt`, `biases` and `plan` are
// head_probes.py's head512_operands and _probe_plan. Writes out [P, pitch] fp32.
extern "C" int dmnerf_head512(const void* x, const void* edt, int edt_rows, const void* wt,
                              const float* biases, float* out, long long P,
                              const long long* plan, int n_sms, void* stream) {
  if (edt != nullptr || edt_rows != 0 || plan[3] != OUT_COLS) return (int)cudaErrorInvalidValue;
  return launch_head_probe(x, nullptr, 0, wt, biases, out, P, plan, n_sms, stream);
}
