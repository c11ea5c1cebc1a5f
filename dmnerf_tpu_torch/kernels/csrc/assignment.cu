// K11: the masked linear-sum assignment of the instance loss, sm_90a. Replaces the JAX
// package's in-graph solver (dmnerf_tpu/objfield/hungarian.py: masked_assignment :123-159,
// _augmenting_path_step :29-110), a Jonker-Volgenant shortest-augmenting-path solve
// written with lax.while_loop / fori_loop, which keeps the train step on the device. Here
// it keeps the train step inside one CUDA graph: no host read, no allocation, no
// synchronisation, the launch on the caller's stream.
//
// It computes what the JAX function computes, in its order, so col4row is the same, not
// only an assignment of the same cost: non-finite costs read as nan_to_num(cost, 1e9, 1e9,
// -1e9); `valid` (a device value, clamped to [0, n]) rows each run one augmenting path: a
// Dijkstra scan bounded at n + 1 iterations whose argmin takes NaN first and the lowest
// index on ties (jnp.argmin), the dual updates of :82-91 with the same fp32 operations in
// the same order, and the predecessor walk of :93-108, also bounded at n + 1, from the
// sink (column 0 when the scan hit its bound); the rows past `valid` take the leftover
// columns in index order (:152-159). kernels/assignment.py's masked_assignment_ref is
// the plain version, line by line the same.
//
// Bound. The work is a chain of dependent steps, not bytes or products: a train step
// solves B = 2 matrices of n = ins_num (32 at the flagship) with a few thousand flops and
// 8 KB of costs. Each Dijkstra iteration ends in a block-wide argmin that the next one
// waits for, so the least time is the scan's iterations over the valid rows times the
// latency of one block-wide argmin (dmnerf_assignment_argmin_probe measures it); the
// blocks of a batch run side by side.
//
// Design: one block per matrix of the [B, n, n] batch, one thread per column (n <= 1024,
// blocks of n rounded up to a warp). A thread keeps its column's v, shortest, path and
// remaining bit in registers through the scan and reads its cost entry of the scanned row
// from global memory (one coalesced row an iteration). u, col4row, row4col and the
// scanned-row flags live in shared memory; the argmin is a warp shuffle, then the warps'
// (value, index) pairs through shared memory (two buffers, so one barrier an iteration),
// reduced again by every warp. After the scan each thread publishes shortest and path,
// the duals are one pass over rows and columns, and one thread walks the path.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int MAX_N = 1024;
constexpr int MAX_WARPS = MAX_N / 32;

__device__ __forceinline__ float finite_cost(float x) {
  if (isnan(x)) return 1e9f;
  if (isinf(x)) return x > 0.f ? 1e9f : -1e9f;
  return x;
}

// (a, ia) comes before (b, ib) in jnp.argmin's order: NaN first, then the smaller value,
// the lower index on ties.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The block's argmin of (v, i); every thread gets it. `buf` alternates between calls.
__device__ __forceinline__ void block_argmin(float& v, int& i, float (*red_v)[MAX_WARPS],
                                             int (*red_i)[MAX_WARPS], int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  warp_argmin(v, i);
  if (lane == 0) {
    red_v[buf][warp] = v;
    red_i[buf][warp] = i;
  }
  __syncthreads();
  v = lane < warps ? red_v[buf][lane] : INFINITY;
  i = lane < warps ? red_i[buf][lane] : INT_MAX;
  warp_argmin(v, i);
  buf ^= 1;
}

__global__ void __launch_bounds__(MAX_N) assignment_kernel(const float* __restrict__ cost,
                                                           const int* __restrict__ valid_rows,
                                                           long long* __restrict__ out, int n) {
  __shared__ float u[MAX_N], sh_shortest[MAX_N];
  __shared__ int col4row[MAX_N], row4col[MAX_N], sh_path[MAX_N], col_for_rank[MAX_N];
  __shared__ unsigned char scanned_row[MAX_N];
  __shared__ float red_v[2][MAX_WARPS];
  __shared__ int red_i[2][MAX_WARPS];

  const int t = threadIdx.x;
  const bool is_col = t < n;
  const float* c = cost + (size_t)blockIdx.x * n * n;
  const int valid = min(max(valid_rows[blockIdx.x], 0), n);
  if (is_col) {
    u[t] = 0.f;
    col4row[t] = -1;
    row4col[t] = -1;
    col_for_rank[t] = 0;
    scanned_row[t] = 0;
  }
  float v = 0.f;
  int buf = 0;
  __syncthreads();

  for (int cur = 0; cur < valid; ++cur) {
    // Dijkstra to the nearest unassigned column (:53-76)
    float shortest = INFINITY, min_val = 0.f;
    int path = -1, i = cur, sink = -1;
    bool remaining = is_col;
    for (int it = 0; sink < 0 && it <= n; ++it) {
      if (t == 0) scanned_row[i] = 1;
      float masked = INFINITY;
      if (is_col) {
        const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, finite_cost(c[(size_t)i * n + t])),
                                            u[i]), v);
        if (remaining && r < shortest) {
          path = i;
          shortest = r;
        }
        masked = remaining ? shortest : INFINITY;
      }
      int j = is_col ? t : INT_MAX;
      block_argmin(masked, j, red_v, red_i, buf);
      min_val = masked;
      const int r4c = row4col[j];
      if (r4c < 0) sink = j;
      else i = r4c;
      if (t == j) remaining = false;
    }
    sink = max(sink, 0);
    if (is_col) {
      sh_shortest[t] = shortest;
      sh_path[t] = path;
    }
    __syncthreads();

    // dual updates (:82-91): thread k updates row k's u and column k's v
    if (is_col) {
      const int ck = col4row[t];
      const float at_col = ck >= 0 ? sh_shortest[ck] : 0.f;
      float uk = __fadd_rn(u[t], t == cur ? min_val : 0.f);
      uk = __fadd_rn(uk, scanned_row[t] && t != cur ? __fsub_rn(min_val, at_col) : 0.f);
      u[t] = uk;
      v = __fsub_rn(v, remaining ? 0.f : __fsub_rn(min_val, shortest));
      scanned_row[t] = 0;
    }
    __syncthreads();

    // augment along the predecessors from the sink back to cur (:93-108)
    if (t == 0) {
      int j = sink;
      bool done = false;
      for (int it = 0; !done && it <= n; ++it) {
        const bool in = j >= 0 && j < n;
        const int row = max(in ? sh_path[j] : 0, 0);
        if (in) row4col[j] = row;
        const int next = col4row[row];
        col4row[row] = j;
        j = next;
        done = row == cur;
      }
    }
    __syncthreads();
  }

  // padding rows take the leftover columns in index order (:152-159)
  if (t == 0) {
    int rank = 0;
    for (int col = 0; col < n; ++col)
      if (row4col[col] < 0) col_for_rank[rank++] = col;
  }
  __syncthreads();
  if (is_col)
    out[(size_t)blockIdx.x * n + t] =
        t < valid ? col4row[t] : col_for_rank[min(max(t - valid, 0), n - 1)];
}

// `iters` dependent block-wide argmins in one block of `threads` threads: the latency of
// one Dijkstra iteration's reduction, the unit of K11's bound.
__global__ void argmin_probe_kernel(int iters, float* out) {
  __shared__ float red_v[2][MAX_WARPS];
  __shared__ int red_i[2][MAX_WARPS];
  float x = (float)((threadIdx.x * 37) % blockDim.x);
  int buf = 0;
  for (int it = 0; it < iters; ++it) {
    float m = x;
    int j = threadIdx.x;
    block_argmin(m, j, red_v, red_i, buf);
    if ((int)threadIdx.x == j) x += (float)blockDim.x;
  }
  if (threadIdx.x == 0) out[0] = x;
}

}  // namespace

// col4row [batch, n] int64 of the costs [batch, n, n] fp32 (contiguous) for the first
// valid[b] rows of matrix b (int32 on the device), on `stream`. Returns cudaGetLastError()
// (0 when the launch was accepted), or cudaErrorInvalidValue for n outside [1, 1024].
extern "C" int dmnerf_assignment(const float* cost, const int* valid, long long* out, int batch,
                                 int n, void* stream) {
  if (batch < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  assignment_kernel<<<batch, (n + 31) / 32 * 32, 0, (cudaStream_t)stream>>>(cost, valid, out, n);
  return (int)cudaGetLastError();
}

// The latency probe: one block of `threads` (a multiple of 32 up to 1024) runs `iters`
// block-wide argmins; out[0] keeps the result live.
extern "C" int dmnerf_assignment_argmin_probe(int threads, int iters, float* out, void* stream) {
  if (threads < 32 || threads > MAX_N || threads % 32 || iters < 1) return (int)cudaErrorInvalidValue;
  argmin_probe_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(iters, out);
  return (int)cudaGetLastError();
}
