// K10: the JAX package's fused-head probe on Hopper, sm_90a. Replaces the Pallas TPU
// kernel of scripts/dev/mfu_probe4.py (k_headsnew :63, pallas_call :79), which timed the
// fused head algebra the JAX package then landed. On Hopper the question is the port's:
// its output layer is one block-diagonal product (pack_params's `out`, [2H, 4 + C] with
// zero blocks); would two products (rgb [H, 3], ins [H, C]), the JAX package's form,
// cost less? For h [P, 256] and edT [27, P] (dmnerf_tpu_torch/kernels/head_probes.py,
// whose heads_fused_ref is the plain version and heads_fused_operands the table):
//   sigma  h @ M1[:, 2H] + b1[2H]          an n16 layer, as the port's
//   head   relu([ed | h] @ [Wrh2 ; M1[:, :2H]] + b1[:2H]) -> [rh | ih] in bf16, n256
//   out    one [2H, 4 + C] product (padded to 48 columns, an n64 instruction), or split:
//          rh @ [Wro | 0] (n16) and ih @ Wio (n64), each over half of the registers' h
//   then the row sum of [rgb | sigma | ins] [P, 1].
//
// Bound. At the probe's P = 589,824 points the model executes 92.6 GFLOP (0.094 ms at 989
// TFLOP/s) and moves h (512 bytes a point), edT (54) and the row sums (4): 336 MB, 0.100
// ms at 3.35 TB/s. The kernel is bound by its bytes, and split against block-diagonal
// moves a few per cent of executed products that sit under that stream.
//
// Design: the forward template's walk (fused_mlp_fwd.cuh, ROWS_H): h arrives by TMA into
// registers, the embedding warps transpose edT into the ed tile the head's first chunk
// reads, and the output layers' epilogues sum their columns over the accumulator's quad.

#include "fused_mlp_fwd.cuh"

// `x` is h [P, 256] bf16, `edt` edT [edt_rows, P] bf16 (edt_rows <= 64); `wt`, `biases`
// and `plan` are head_probes.py's heads_fused_operands and _probe_plan; `schedule` the
// consumers' (Sched: 0 lockstep, 1 pipelined products, the path's; both give the same
// bits). Writes the row sums [P] fp32, or the columns [P, pitch].
extern "C" int dmnerf_heads_fused(const void* x, const void* edt, int edt_rows, const void* wt,
                                  const float* biases, float* out, long long P,
                                  const long long* plan, int n_sms, void* stream, int schedule) {
  if (edt == nullptr || edt_rows <= 0) return (int)cudaErrorInvalidValue;
  return with_schedule<SCHED_LOCKSTEP, SCHED_PIPELINED>(schedule, [&](auto sched) {
    return launch_head_probe<decltype(sched)::value>(x, edt, edt_rows, wt, biases, out, P, plan,
                                                     n_sms, stream);
  });
}
