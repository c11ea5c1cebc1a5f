// K6: the parameter backward of the DM-NeRF MLP query over precomputed embeddings,
// sm_90a. Replaces the JAX package's Pallas TPU kernel _bwd_kernel_pe
// (dmnerf_tpu/kernels/fused_mlp.py:494), pe_mode 'outside'; bound and design in
// fused_mlp_bwd.cuh.

#include "fused_mlp_bwd.cuh"

// `e_in` is the point embedding [P, e_width] bf16 and `ed_in` the per-point viewdir
// embedding [P, h_col] bf16, both as the forward (K7, K5) had them; `stash` holds the
// ReLU outputs that fused_mlp_fwd_pe.cu with a stash wrote, no embedding; the table is
// _bwd_plan's (rows 'embedded'), whose dW jobs read e as segment source 2 and ed as 1.
extern "C" int dmnerf_fused_mlp_bwd_pe(const void* e_in, const void* ed_in, const void* weights,
                                       const float* g, const void* stash, void* dpre, float* dbpart,
                                       float* dwpart, float* dw, float* db, const long long* table,
                                       int n_sms, void* stream) {
  return run_fused_mlp_bwd(e_in, ed_in, weights, g, stash, dpre, dbpart, dwpart, dw, db, table,
                           n_sms, stream);
}
