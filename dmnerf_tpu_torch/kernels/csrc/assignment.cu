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
// 8 KB of costs. Each Dijkstra iteration picks the row the next one reads, so the least
// time is the scan's iterations over the valid rows times the shortest dependent step a
// warp can take for one (a shared-memory load, redux.sync, vote.ballot, a shuffle:
// dmnerf_assignment_chain_probe, which calls nothing of the solver), plus one global load
// for the costs; the matrices of a batch run side by side.
//
// Design, n <= 32 (the flagship's ins_num and every synthetic scene): one warp a matrix,
// a block of one warp each (one block of B warps measured the same, PERF.md), lane t
// owning column t and row t. The warp stages its n x n costs in shared memory once
// (cp.async, then nan_to_num in place as selects), then keeps everything else in
// registers: v, shortest, path, the remaining bit and row4col of its column; u, col4row
// and the scanned bit of its row. A value another lane holds is one __shfl_sync. The
// argmin is one warp reduction on an order key (order_key: jnp.argmin's order as unsigned
// order), __reduce_min_sync then __ffs of a ballot. The predecessor walk is warp-uniform
// (shuffles, a predicated write in the owning lane) and the padding rows' ranks are a
// popcount of a ballot. No block barrier, no global load on the chain, no one-thread loop.
//
// n in (32, 1024]: one block a matrix, one thread a column (blocks of n rounded up to a
// warp). A thread keeps its column's v, shortest, path and remaining bit in registers and
// reads its cost entry of the scanned row from global memory; u, col4row, row4col and the
// scanned-row flags live in shared memory; the argmin is a warp shuffle, then the warps'
// (value, index) pairs through shared memory, reduced again by every warp. After the scan
// each thread publishes shortest and path, the duals are one pass over rows and columns,
// and one thread walks the path.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int MAX_N = 1024;
constexpr int MAX_WARPS = MAX_N / 32;
constexpr int WARP_N = 32;             // n <= WARP_N: one warp a matrix
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned PAD_KEY = 0xffffffffu;   // lanes past n: above +inf's key
constexpr unsigned INF_KEY = 0xff800000u;   // order_key(+inf)

// nan_to_num(x, 1e9, 1e9, -1e9) as selects, so a run of them issues without branches.
__device__ __forceinline__ float finite_cost(float x) {
  const float big = __int_as_float((__float_as_int(x) & 0x80000000) | 0x4e6e6b28);   // +-1e9
  const float y = fabsf(x) == INFINITY ? big : x;
  return isnan(x) ? 1e9f : y;
}

// cp.async of 16 or 4 bytes from global to shared memory, and the wait for this thread's.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// jnp.argmin's order as unsigned order: NaN (any sign or payload) first, then the floats
// from -inf up to +inf, -0 and +0 equal (so the lower index wins a tie between them).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.f));   // -0 + 0 = +0; the rest unchanged
  return isnan(x) ? 0u : b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

// The warp's lowest key and the lowest lane holding it; every lane gets both.
__device__ __forceinline__ int warp_argmin_key(unsigned key) {
  const unsigned kmin = __reduce_min_sync(FULL, key);
  return __ffs(__ballot_sync(FULL, key == kmin)) - 1;
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
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
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

// One warp a matrix (n <= 32): block b is matrix b of the batch, its costs staged in
// shared memory by cp.async (16-byte pieces where the matrix allows), then made finite
// in place.
__global__ void __launch_bounds__(WARP_N)
    warp_assignment_kernel(const float* __restrict__ cost, const int* __restrict__ valid_rows,
                           long long* __restrict__ out, int n) {
  __shared__ __align__(16) float c_sh[WARP_N * WARP_N];
  const int lane = threadIdx.x, b = blockIdx.x;
  const int nn = n * n;
  const float* c = cost + (size_t)b * nn;
  const int valid = min(max(__ldg(valid_rows + b), 0), n);
  if ((nn & 3) == 0 && (reinterpret_cast<size_t>(c) & 15) == 0) {
#pragma unroll
    for (int k = lane; k < WARP_N * WARP_N / 4; k += WARP_N)
      if (k < nn / 4) copy_async16(c_sh + 4 * k, c + 4 * k);
  } else {
    for (int k = lane; k < nn; k += WARP_N) copy_async4(c_sh + k, c + k);
  }
  wait_async();
  __syncwarp();
  // nan_to_num over the warp's whole slot, in 16-byte pieces: no branch, so the loads
  // issue together (entries past n * n are never read)
  float4* s4 = reinterpret_cast<float4*>(c_sh);
  float4 q[WARP_N * WARP_N / 4 / WARP_N];
#pragma unroll
  for (int k = 0; k < WARP_N * WARP_N / 4 / WARP_N; ++k) q[k] = s4[lane + k * WARP_N];
#pragma unroll
  for (int k = 0; k < WARP_N * WARP_N / 4 / WARP_N; ++k)
    s4[lane + k * WARP_N] = make_float4(finite_cost(q[k].x), finite_cost(q[k].y),
                                        finite_cost(q[k].z), finite_cost(q[k].w));
  __syncwarp();

  const bool is_col = lane < n;
  const unsigned off_key = is_col ? INF_KEY : PAD_KEY;   // a column out of the scan
  const float* col_costs = c_sh + min(lane, n - 1);       // this lane's column, row 0
  float u = 0.f, v = 0.f;      // row lane's dual, column lane's dual
  int col4row = -1, row4col = -1;
  bool scanned = false;        // row lane scanned in this augmentation
  for (int cur = 0; cur < valid; ++cur) {
    // Dijkstra to the nearest unassigned column (:53-76)
    float shortest = INFINITY, min_val = 0.f;
    unsigned shortest_key = INF_KEY;    // order_key(shortest), kept beside it
    int path = -1, i = cur, sink = -1;
    bool remaining = is_col;
    for (int it = 0; sink < 0 && it <= n; ++it) {
      scanned |= lane == i;
      const float ui = __shfl_sync(FULL, u, i);
      const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, col_costs[i * n]), ui), v);
      const unsigned r_key = order_key(r);        // beside the compare, not after it
      if (remaining && r < shortest) {            // never in a lane past n
        path = i;
        shortest = r;
        shortest_key = r_key;
      }
      const float masked = remaining ? shortest : INFINITY;
      const int j = warp_argmin_key(remaining ? shortest_key : off_key);
      min_val = __shfl_sync(FULL, masked, j);
      const int r4c = __shfl_sync(FULL, row4col, j);
      if (r4c < 0) sink = j;
      else i = r4c;
      remaining &= lane != j;
    }
    sink = max(sink, 0);

    // dual updates (:82-91): lane k updates row k's u and column k's v
    const float at_col = __shfl_sync(FULL, shortest, max(col4row, 0));
    if (is_col) {
      u = __fadd_rn(u, lane == cur ? min_val : 0.f);
      u = __fadd_rn(u, scanned && lane != cur
                           ? __fsub_rn(min_val, col4row >= 0 ? at_col : 0.f) : 0.f);
      v = __fsub_rn(v, remaining ? 0.f : __fsub_rn(min_val, shortest));
    }
    scanned = false;

    // augment along the predecessors from the sink back to cur (:93-108), warp-uniform
    int j = sink;
    bool done = false;
    for (int it = 0; !done && it <= n; ++it) {
      const bool in = j >= 0 && j < n;
      const int pj = __shfl_sync(FULL, path, in ? j : 0);
      const int row = max(in ? pj : 0, 0);
      if (in && lane == j) row4col = row;
      const int next = __shfl_sync(FULL, col4row, row);
      if (lane == row) col4row = j;
      j = next;
      done = row == cur;
    }
  }

  // padding rows take the leftover columns in index order (:152-159): free column c of
  // rank k writes row valid + k; the rows past the leftovers read column 0
  long long* o = out + (size_t)b * n;
  const bool free_col = is_col && row4col < 0;
  const unsigned free_mask = __ballot_sync(FULL, free_col);
  const int rank = __popc(free_mask & ((1u << lane) - 1u));
  if (lane < valid) o[lane] = col4row;
  if (free_col && valid + rank < n) o[valid + rank] = lane;
  if (is_col && lane >= valid + __popc(free_mask)) o[lane] = 0;
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
// one Dijkstra iteration's reduction in the block design (its earlier bound, kept so that
// figure can still be read).
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

// The chain floor's unit, independent of the solver: one warp chains `iters` of the
// shortest step a Dijkstra iteration can take on a warp (mode 0): a shared-memory load
// whose row is the previous step's result, redux.sync.min.u32, vote.ballot + __ffs, and
// a __shfl_sync that brings the next row from the winning lane. Mode 1 chains `iters`
// dependent global loads through `ring` (ld.global.cg: L2, where a step's costs lie).
__global__ void chain_probe_kernel(int mode, int iters, const unsigned* __restrict__ ring,
                                   unsigned* out) {
  __shared__ unsigned table[WARP_N * WARP_N];
  const int lane = threadIdx.x;
  unsigned i = 0;
  if (mode == 0) {
    for (int k = lane; k < WARP_N * WARP_N; k += WARP_N) table[k] = (unsigned)k * 2654435761u;
    __syncwarp();
    for (int it = 0; it < iters; ++it) {
      const unsigned x = table[(i << 5) | lane];
      const unsigned m = __reduce_min_sync(FULL, x);
      const int j = __ffs(__ballot_sync(FULL, x == m)) - 1;
      i = __shfl_sync(FULL, x & 31u, j);
    }
  } else if (lane == 0) {
    for (int it = 0; it < iters; ++it) i = __ldcg(ring + i);
  }
  if (lane == 0) out[0] = i;
}

// K11's key and argmin alone: one warp a vector of x [count, n], lanes past n padded.
__global__ void key_probe_kernel(const float* __restrict__ x, int n, int count, unsigned* keys,
                                 int* argmin) {
  const int lane = threadIdx.x & 31, w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= count) return;
  const unsigned key = lane < n ? order_key(x[(size_t)w * n + lane]) : PAD_KEY;
  keys[(size_t)w * WARP_N + lane] = key;
  const int j = warp_argmin_key(key);
  if (lane == 0) argmin[w] = j;
}

int launch(const float* cost, const int* valid, long long* out, int batch, int n,
           bool block_design, cudaStream_t stream) {
  if (block_design)
    assignment_kernel<<<batch, (n + 31) / 32 * 32, 0, stream>>>(cost, valid, out, n);
  else
    warp_assignment_kernel<<<batch, WARP_N, 0, stream>>>(cost, valid, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// col4row [batch, n] int64 of the costs [batch, n, n] fp32 (contiguous) for the first
// valid[b] rows of matrix b (int32 on the device), on `stream`: one warp a matrix for
// n <= 32, one block a matrix above. Returns cudaGetLastError() (0 when the launch was
// accepted), or cudaErrorInvalidValue for n outside [1, 1024].
extern "C" int dmnerf_assignment(const float* cost, const int* valid, long long* out, int batch,
                                 int n, void* stream) {
  if (batch < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  return launch(cost, valid, out, batch, n, n > WARP_N, (cudaStream_t)stream);
}

// The same function by the block design at any n, for the card tests that hold the two
// designs to each other (not a path's launch).
extern "C" int dmnerf_assignment_block(const float* cost, const int* valid, long long* out,
                                       int batch, int n, void* stream) {
  if (batch < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  return launch(cost, valid, out, batch, n, true, (cudaStream_t)stream);
}

// The block design's latency probe: one block of `threads` (a multiple of 32 up to 1024)
// runs `iters` block-wide argmins; out[0] keeps the result live.
extern "C" int dmnerf_assignment_argmin_probe(int threads, int iters, float* out, void* stream) {
  if (threads < 32 || threads > MAX_N || threads % 32 || iters < 1) return (int)cudaErrorInvalidValue;
  argmin_probe_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(iters, out);
  return (int)cudaGetLastError();
}

// The chain floor's probe: one warp, `iters` steps of `mode` (0: the warp step, 1: a
// dependent L2 load through `ring`, whose entries index it); out[0] keeps it live.
extern "C" int dmnerf_assignment_chain_probe(int mode, int iters, const unsigned* ring,
                                             unsigned* out, void* stream) {
  if (mode < 0 || mode > 1 || iters < 1 || (mode == 1 && ring == nullptr))
    return (int)cudaErrorInvalidValue;
  chain_probe_kernel<<<1, WARP_N, 0, (cudaStream_t)stream>>>(mode, iters, ring, out);
  return (int)cudaGetLastError();
}

// K11's order key and warp argmin on x [count, n] fp32 (n <= 32): keys [count, 32] (lanes
// past n padded) and argmin [count] int32.
extern "C" int dmnerf_assignment_key_probe(const float* x, int n, int count, unsigned* keys,
                                           int* argmin, void* stream) {
  if (n < 1 || n > WARP_N || count < 1) return (int)cudaErrorInvalidValue;
  constexpr int warps = 4;
  key_probe_kernel<<<(count + warps - 1) / warps, WARP_N * warps, 0, (cudaStream_t)stream>>>(
      x, n, count, keys, argmin);
  return (int)cudaGetLastError();
}
