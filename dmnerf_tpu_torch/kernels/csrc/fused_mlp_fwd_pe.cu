// K5: the DM-NeRF MLP forward over precomputed embeddings, sm_90a. Replaces the JAX
// package's Pallas TPU kernel _fwd_kernel_pe (dmnerf_tpu/kernels/fused_mlp.py:471),
// pe_mode 'outside'; bound and design in fused_mlp_fwd.cuh.

#include "fused_mlp_fwd.cuh"

// `e` is the point embedding [P, EP] bf16 (K7's output, fused_pe.cu) and `ed` the
// per-point viewdir embedding [P, EDP] bf16; the kernel loads both tiles with TMA and
// runs the layer table. `wt` is pack_params's transposed weights and `plan` _fwd_plan's
// table.
extern "C" int dmnerf_fused_mlp_fwd_pe(const void* e, const void* ed, const void* wt,
                                       const float* biases, float* out, long long P,
                                       const long long* plan, void* stash,
                                       const long long* stash_table, int n_sms, void* stream) {
  return launch_fused_mlp_fwd<ROWS_EMBEDDED>(e, ed, wt, biases, out, P, 1, plan, stash,
                                             stash_table, n_sms, stream);
}
