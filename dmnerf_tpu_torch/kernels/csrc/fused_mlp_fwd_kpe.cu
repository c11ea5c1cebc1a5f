// K3: the fused PE + MLP forward with per-point directions embedded in the kernel,
// sm_90a. Replaces the JAX package's Pallas TPU kernel _fwd_kernel
// (dmnerf_tpu/kernels/fused_mlp.py:462), pe_mode 'kernel'; bound and design in
// fused_mlp_fwd.cuh.

#include "fused_mlp_fwd.cuh"

// `dirs` is [P, 3] fp32, one direction per point, embedded with multires_views octaves
// into the h_col columns of the viewdir embedding.
extern "C" int dmnerf_fused_mlp_fwd_kpe(const float* pts, const float* dirs, const void* weights,
                                        const float* biases, float* out, long long P,
                                        const int* table, int n_layers, int multires,
                                        int multires_views, int h_col, int e_col, int e_width,
                                        int c4, void* stash, const long long* stash_table,
                                        void* stream) {
  return launch_fused_mlp_fwd<ROWS_POINT_DIRS>(pts, dirs, weights, biases, out, P, 1, table,
                                               n_layers, multires, multires_views, h_col, e_col,
                                               e_width, c4, stash, stash_table, stream);
}
