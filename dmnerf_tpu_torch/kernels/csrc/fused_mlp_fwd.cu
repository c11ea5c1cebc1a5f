// K1: the fused PE + MLP forward with a per-ray viewdir table, sm_90a. Replaces the
// JAX package's Pallas TPU kernel _fwd_kernel_pet (dmnerf_tpu/kernels/fused_mlp.py:507);
// bound and design in fused_mlp_fwd.cuh.

#include "fused_mlp_fwd.cuh"

// `edr` is the per-ray viewdir embedding [P / S, EDP] bf16; point p reads row p / S.
// `wt` is pack_params's transposed weights and `plan` _fwd_plan's table.
extern "C" int dmnerf_fused_mlp_fwd(const float* pts, const void* edr, const void* wt,
                                    const float* biases, float* out, long long P, int S,
                                    const long long* plan, void* stash,
                                    const long long* stash_table, int n_sms, void* stream) {
  return launch_fused_mlp_fwd<ROWS_RAY_TABLE>(pts, edr, wt, biases, out, P, S, plan, stash,
                                              stash_table, n_sms, stream);
}
