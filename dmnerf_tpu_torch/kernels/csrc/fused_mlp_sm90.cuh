// Hopper primitives of the forward, the parameter backward and the point embedding
// (fused_mlp_fwd.cuh, fused_mlp_bwd.cuh, fused_pe.cu): tensor maps for the Tensor Memory
// Accelerator (TMA), mbarrier rings, bulk copies, thread block clusters and TMA
// multicast, warpgroup matrix multiply (wgmma) with fp32 accumulators in registers, and
// register reallocation between warpgroups.
// sm_90a only (wgmma and setmaxnreg do not exist on plain sm_90).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed (a fresh barrier counts the
// phase before its first as completed, so waiting on parity 1 passes at once). A wait
// of more than 10 s means a broken ring: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(addr, parity))
    if (globaltimer_ns() - t0 > 10000000000ull) __trap();
}

// Make this thread's generic-proxy writes to shared memory visible to the async proxy
// (wgmma operands, bulk copies) once a barrier orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// threadIdx.x, read where it is called: the compiler cannot move the read, nor what
// derives from it, out of a loop
__device__ __forceinline__ uint32_t tid_opaque() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// A 32-bit store to the shared-memory address `a`; kept in order with the other asm
// statements (the fences and barriers), free to move against plain loads.
__device__ __forceinline__ void st_shared_b32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v));
}

// Four 8 x 8 b16 matrices between shared memory and a warp's registers (ldmatrix,
// stmatrix): lanes 8 m .. 8 m + 7 give the addresses of matrix m's rows (16 bytes each),
// and lane l holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix m in d[m],
// the layout of an mma accumulator's 8 x 8 pieces. Kept in order with the other asm
// statements.
__device__ __forceinline__ void ldmatrix_x4(uint32_t a, uint32_t (&d)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(a));
}
__device__ __forceinline__ void stmatrix_x4(uint32_t a, const uint32_t (&d)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]));
}

// ---- TMA: one thread copies a 2D box into shared memory; completion counts bytes
// on `bar`. Out-of-bounds elements of the box are filled with zeros. ----
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- bulk copies (the TMA engine, no tensor map): one thread sends `bytes` (a multiple
// of 16; both addresses 16-byte aligned) of shared memory to device memory as one
// group member; commit closes the group. wait_read<N> returns once at most N of this
// thread's groups still read their shared memory, wait_all<N> once at most N are
// incomplete. Shared memory written by threads is handed over by fence_proxy_async
// and a barrier. ----
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// TMA store of a 2D box from `src` (laid out as tma_load_2d leaves it) to the tensor at
// box coordinates (c0, c1), as one member of this thread's bulk group; elements out of
// the tensor's bounds are not written. The lines it writes are the first L2 evicts.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3}], [%1], pol;\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- thread block clusters ----
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster; orders the memory operations before it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Arrive on the mbarrier at `bar`'s offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}
// TMA load of a 2D box into `dst`'s offset in every block of `mask`; each block's
// mbarrier at `bar`'s offset counts the bytes it receives.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor of a tile written by TMA with 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout type 1
// (SWIZZLE_128B). The tile must sit on a 1024-byte boundary.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across an asynchronous
// wgmma: the registers are "used and redefined" here.
__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define DM_F8(i)                                                                          \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DM_F128                                                                            \
  DM_F8(0), DM_F8(8), DM_F8(16), DM_F8(24), DM_F8(32), DM_F8(40), DM_F8(48), DM_F8(56),    \
      DM_F8(64), DM_F8(72), DM_F8(80), DM_F8(88), DM_F8(96), DM_F8(104), DM_F8(112),       \
      DM_F8(120)
#define DM_D128                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "       \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "       \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "       \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "  \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
  "%125, %126, %127}"

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], bf16 in, fp32 accumulators. A from
// registers (the m16n8k16 A fragment per warp, rows 16 * warp), B K-major from shared
// memory. `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DM_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : DM_F128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The same with A from shared memory too; both operands MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n256_tt(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DM_D128
      ", %128, %129, p, 1, 1, 1, 1;\n}\n"
      : DM_F128
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The forward's products (fused_mlp_fwd.cuh): d (+)= A[64 x 16] B[16 x N], bf16 in,
// fp32 accumulators, B K-major from shared memory (a [N][64] weight box with 128-byte
// swizzle), A from registers (rs) or K-major from shared memory (ss). N is 256, 64 or
// 16; the narrow forms write d[OFF .. OFF + N / 2), which is the n256 accumulator
// layout restricted to columns [OFF * 2, OFF * 2 + N). `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DM_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : DM_F128
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#define DM_G8(i)                                                                          \
  "+f"(d[OFF + i + 0]), "+f"(d[OFF + i + 1]), "+f"(d[OFF + i + 2]), "+f"(d[OFF + i + 3]),   \
      "+f"(d[OFF + i + 4]), "+f"(d[OFF + i + 5]), "+f"(d[OFF + i + 6]), "+f"(d[OFF + i + 7])
#define DM_G32 DM_G8(0), DM_G8(8), DM_G8(16), DM_G8(24)
#define DM_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define DM_D32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

template <int OFF>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DM_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DM_G32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int OFF>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DM_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DM_G32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int OFF>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " DM_D8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : DM_G8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int OFF>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " DM_D8
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : DM_G8(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef DM_G8
#undef DM_G32
#undef DM_D8
#undef DM_D32
#undef DM_F8
#undef DM_F128
#undef DM_D128

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` (0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- host: a 2D bf16 tensor map [rows][cols] (row pitch `pitch` elements) with
// boxes of box_cols x box_rows and 128-byte swizzle. cuTensorMapEncodeTiled is a
// driver-API function; it is reached through the runtime's entry-point query, so the
// library needs no link against libcuda. Returns 0 or a nonzero error. ----
inline int encode_map(CUtensorMap* map, const void* base, unsigned long long cols,
                      unsigned long long rows, unsigned long long pitch, unsigned box_cols,
                      unsigned box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  if (reinterpret_cast<uintptr_t>(base) % 16 || (pitch * 2) % 16 || cols == 0 || rows == 0)
    return (int)cudaErrorMisalignedAddress;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {pitch * 2};
  cuuint32_t box[2] = {box_cols, box_rows};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

}  // namespace sm90
