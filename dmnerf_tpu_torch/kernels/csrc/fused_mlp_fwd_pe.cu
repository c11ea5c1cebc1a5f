// K5: the DM-NeRF MLP forward over precomputed embeddings, sm_90a. Replaces the JAX
// package's Pallas TPU kernel _fwd_kernel_pe (dmnerf_tpu/kernels/fused_mlp.py:471),
// pe_mode 'outside'; bound and design in fused_mlp_fwd.cuh.

#include "fused_mlp_fwd.cuh"

// `e` is the point embedding [P, e_width] bf16 (K7's output, fused_pe.cu) and `ed` the
// per-point viewdir embedding [P, h_col] bf16; the kernel copies both rows into shared
// memory and runs the layer table.
extern "C" int dmnerf_fused_mlp_fwd_pe(const void* e, const void* ed, const void* weights,
                                       const float* biases, float* out, long long P,
                                       const int* table, int n_layers, int h_col, int e_col,
                                       int e_width, int c4, void* stash,
                                       const long long* stash_table, void* stream) {
  return launch_fused_mlp_fwd<ROWS_EMBEDDED>(e, ed, weights, biases, out, P, 1, table, n_layers,
                                             0, 0, h_col, e_col, e_width, c4, stash, stash_table,
                                             stream);
}
