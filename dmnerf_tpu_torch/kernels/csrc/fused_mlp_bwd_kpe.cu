// K4: the parameter backward of the fused PE + MLP query with per-point directions
// embedded in the kernel, sm_90a. Replaces the JAX package's Pallas TPU kernel
// _bwd_kernel (dmnerf_tpu/kernels/fused_mlp.py:481), pe_mode 'kernel'; bound and
// design in fused_mlp_bwd.cuh.

#include "fused_mlp_bwd.cuh"

// `dirs` is [P, 3] fp32, one direction per point; the table is _bwd_plan's with the
// per-point viewdir embedding in the stash.
extern "C" int dmnerf_fused_mlp_bwd_kpe(const float* pts, const float* dirs, const void* weights,
                                        const float* biases, const void* wt, const float* g,
                                        void* stash, void* dpre, float* dbpart, float* dwpart,
                                        float* dw, float* db, const long long* table,
                                        void* stream) {
  return run_fused_mlp_bwd<ROWS_POINT_DIRS>(pts, dirs, weights, biases, wt, g, stash, dpre,
                                            dbpart, dwpart, dw, db, table, stream);
}
