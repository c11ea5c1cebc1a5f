// K2: the parameter backward of the fused PE + MLP query with a per-ray viewdir
// table, sm_90a. Replaces the JAX package's Pallas TPU kernel _bwd_kernel_pet
// (dmnerf_tpu/kernels/fused_mlp.py:520); bound and design in fused_mlp_bwd.cuh.

#include "fused_mlp_bwd.cuh"

// `stash` is what the training forward (fused_mlp_fwd.cu with a stash) wrote: the point
// embedding, the per-point viewdir embedding and every ReLU output; the table is
// _bwd_plan's (rows 'ray_table'). e_in and ed_in are unused.
extern "C" int dmnerf_fused_mlp_bwd(const void* e_in, const void* ed_in, const void* weights,
                                    const float* g, const void* stash, void* dpre, float* dbpart,
                                    float* dwpart, float* dw, float* db, const long long* table,
                                    int n_sms, void* stream) {
  return run_fused_mlp_bwd(e_in, ed_in, weights, g, stash, dpre, dbpart, dwpart, dw, db, table,
                           n_sms, stream);
}
