// K1: the fused PE + MLP forward with a per-ray viewdir table, sm_90a. Replaces the
// JAX package's Pallas TPU kernel _fwd_kernel_pet (dmnerf_tpu/kernels/fused_mlp.py:507);
// bound and design in fused_mlp_fwd.cuh.

#include "fused_mlp_fwd.cuh"

// `edr` is the per-ray viewdir embedding [P / S, h_col] bf16; point p reads row p / S.
extern "C" int dmnerf_fused_mlp_fwd(const float* pts, const void* edr, const void* weights,
                                    const float* biases, float* out, long long P, int S,
                                    const int* table, int n_layers, int multires, int h_col,
                                    int e_col, int e_width, int c4, void* stash,
                                    const long long* stash_table, void* stream) {
  return launch_fused_mlp_fwd<ROWS_RAY_TABLE>(pts, edr, weights, biases, out, P, S, table,
                                              n_layers, multires, 0, h_col, e_col, e_width, c4,
                                              stash, stash_table, stream);
}
