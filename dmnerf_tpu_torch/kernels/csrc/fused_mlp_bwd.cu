// K2: the parameter backward of the fused PE + MLP query with a per-ray viewdir
// table, sm_90a. Replaces the JAX package's Pallas TPU kernel _bwd_kernel_pet
// (dmnerf_tpu/kernels/fused_mlp.py:520); bound and design in fused_mlp_bwd.cuh.

#include "fused_mlp_bwd.cuh"

// `edr` is the per-ray viewdir embedding [P / S, h_col] bf16; the table is _bwd_plan's.
extern "C" int dmnerf_fused_mlp_bwd(const float* pts, const void* edr, const void* weights,
                                    const float* biases, const void* wt, const float* g,
                                    void* stash, void* dpre, float* dbpart, float* dwpart,
                                    float* dw, float* db, const long long* table, void* stream) {
  return run_fused_mlp_bwd<ROWS_RAY_TABLE>(pts, edr, weights, biases, wt, g, stash, dpre, dbpart,
                                           dwpart, dw, db, table, stream);
}
