// K6: the parameter backward of the DM-NeRF MLP query over precomputed embeddings,
// sm_90a. Replaces the JAX package's Pallas TPU kernel _bwd_kernel_pe
// (dmnerf_tpu/kernels/fused_mlp.py:494), pe_mode 'outside'; bound and design in
// fused_mlp_bwd.cuh.

#include "fused_mlp_bwd.cuh"

// `e` is the point embedding [P, e_width] bf16 and `ed` the per-point viewdir
// embedding [P, h_col] bf16, both as the forward (K7, K5) had them; the table is
// _bwd_plan's with S = 1, no embedding in the stash, and the dW jobs reading e as
// segment source 2 and ed as source 1.
extern "C" int dmnerf_fused_mlp_bwd_pe(const void* e, const void* ed, const void* weights,
                                       const float* biases, const void* wt, const float* g,
                                       void* stash, void* dpre, float* dbpart, float* dwpart,
                                       float* dw, float* db, const long long* table,
                                       void* stream) {
  return run_fused_mlp_bwd<ROWS_EMBEDDED>(e, ed, weights, biases, wt, g, stash, dpre, dbpart,
                                          dwpart, dw, db, table, stream);
}
