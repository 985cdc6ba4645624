// PTX helpers for Hopper's asynchronous tensor-core path (sm_90a), used by
// the bf16 wgmma routes of flash_attention.cu and flash_attention_bwd.cu
// and the chained-scan route of mamba2_ssd_bwd.cu: mbarriers, TMA tile
// loads (cp.async.bulk.tensor) completing on an mbarrier, named barriers,
// the shared-memory matrix descriptor of a 128-byte-swizzled tile,
// warpgroup wgmma.mma_async products with f32 accumulators (bf16 and TF32
// operands), and on the host cuTensorMapEncodeTiled and the tensor maps
// of the attention operands.
//
// The tile layout every helper assumes is the one a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B and a box 128 bytes wide writes: a 64-row
// tile of a [rows, width] operand is stored as "slabs" of 64 rows × 128
// bytes (kSlabBytes: 64 bf16 or 32 f32 columns a slab), the 16-byte chunks
// of row r XOR-ed by r % 8; every slab starts on a 1024-byte boundary.
// Seen by wgmma:
//  * K-major (the reduction runs along the row, as Q·Kᵀ reads Q and K):
//    8-row groups 1024 bytes apart (SBO), the k-step kk of a slab at
//    +32·kk bytes (k16 in bf16, k8 in TF32: 32 bytes either way; the
//    hardware applies the XOR to the address it forms);
//  * MN-major (the reduction runs down the rows, as dS·K reads K; bf16
//    only — wgmma transposes no 32-bit operand): 64 output columns per
//    slab, slabs kSlabBytes apart (LBO), 8-row groups of the reduction
//    1024 bytes apart (SBO), the k16 step kk at +2048·kk bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kSlabBytes = 64 * 128;   // 64 rows of 128 bytes

// --- mbarriers (by shared-memory address) ---------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// make the initialised barriers visible to the other threads and to the
// async proxy (TMA) before anyone uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also expects `bytes` more of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --- named barriers (id 0 is __syncthreads) -------------------------------
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// shared-memory writes of the generic proxy (st.shared) made visible to
// the async proxy (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- register rebalancing between warpgroups (every warp of the
// warpgroup executes it) ------------------------------------------------------
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- TMA ------------------------------------------------------------------
// the box of `map` at element coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------
// the matrix descriptor of a 128-byte-swizzled operand at shared address
// `saddr` (1024-byte aligned tile, plus the k-step offset), leading and
// stride byte offsets `lbo`, `sbo`
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t saddr) {
  return sw128_desc(saddr, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t saddr) {
  return sw128_desc(saddr, kSlabBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 × 64) = A · B over one k16 step, both operands in shared memory,
// K-major (descriptors `da`, `db`); scale_d 0 overwrites d, 1 adds to it
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 × 64) += A · B over one k16 step: A the 64 × 16 bf16 fragment in
// registers, B in shared memory MN-major (descriptor `db`, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 128) += A · B over one k16 step: A the 64 × 16 bf16 fragment in
// registers, B in shared memory MN-major (descriptor `db`, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 192) += A · B over one k16 step: A the 64 × 16 bf16 fragment in
// registers, B in shared memory MN-major (descriptor `db`, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                            const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 256) += A · B over one k16 step: A the 64 × 16 bf16 fragment in
// registers, B in shared memory MN-major (descriptor `db`, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 64·NS) += A · B, one k16 step (see wgmma_rs_n*)
template <int NS>
__device__ __forceinline__ void wgmma_rs(float (&d)[32 * NS],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (NS == 1) wgmma_rs_n64(d, a, db);
  else if constexpr (NS == 2) wgmma_rs_n128(d, a, db);
  else if constexpr (NS == 3) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// c (64 × 64) = A rows · B rowsᵀ: A and B two 64-row tiles of NS slabs
// (shared addresses), both K-major, reduced over all 64·NS columns; the
// k16 step kk starts (kk / 4) slabs and (kk % 4) · 32 bytes in
template <int NS>
__device__ __forceinline__ void product_ss(float (&c)[32], uint32_t a_tile,
                                           uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4 * NS; ++kk) {
    const uint32_t off = (kk / 4) * kSlabBytes + (kk % 4) * 32;
    wgmma_ss_n64(c, kmajor_desc(a_tile + off), kmajor_desc(b_tile + off),
                 kk > 0);
  }
}

// acc (64 × 64·NS) += W · X: W the 64 × 64 weights as four k16 A
// fragments (w[4·kk .. 4·kk + 3]), X a 64-row tile of NS slabs read
// MN-major, the k16 step kk 16 rows (2048 bytes) in
template <int NS>
__device__ __forceinline__ void product_rs(float (&acc)[32 * NS],
                                           const uint32_t (&w)[16],
                                           uint32_t x_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<NS>(acc, w + 4 * kk, mnmajor_desc(x_tile + kk * 2048));
}

// The A fragments of W from a 64 × 64 accumulator fragment c (rounded to
// bf16): the m64nNk16 accumulator of columns 16·kk .. 16·kk + 15 is the
// A fragment of k16 step kk
__device__ __forceinline__ void pack_weights(const float (&c)[32],
                                             uint32_t (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// Load one 64-row tile (n slabs) of a [batch, rows, heads, width] bf16
// operand `map` (make_map_bf16) at rows `r0` of head `h`, batch `b`, into
// shared `dst`, completing on `bar`
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int n, int h, int r0,
                                          int b) {
  for (int s = 0; s < n; ++s)
    tma_load_4d(dst + s * kSlabBytes, map, bar, 64 * s, h, r0, b);
}

// --- TF32 ------------------------------------------------------------------
// An f32 tile of 64 rows × 64 columns under the 128-byte swizzle is two
// slabs of 32 columns; byte offset of element (r, c) from the tile's start
__device__ __forceinline__ uint32_t sw_f32(int r, int c) {
  return (uint32_t)((c >> 5) * kSlabBytes + r * 128 +
                    ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
}

// a float rounded to TF32 (10 mantissa bits, the low 13 bits zero), to
// nearest with ties away from zero — what cvt.rna.tf32.f32 gives — in two
// integer operations at the ALU's full rate
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo in TF32, the error-compensated split: hi = tf32(x), lo =
// tf32(x − hi); hi·hi + hi·lo + lo·hi misses ~2^-21 of a product
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (64 × 32) += A · B over one k8 step: A the 64 × 8 TF32 fragment in
// registers (warp w of the warpgroup rows 16·w + g and + 8, columns t and
// t + 4; g = lane / 4, t = lane % 4), B 32 rows of a K-major tile in
// shared memory (descriptor `db`); d in the m64nN accumulator layout
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- host: tensor maps ----------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// link against libcuda); 0 where the driver has none.  The encoder fails
// (invalid value) in a thread with no current context: one whose first
// CUDA work this is, such as an autograd worker whose first node is the
// attention backward.  So each thread makes the runtime bind its context
// (cudaFree(0): no operation but that) before its first encode.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  thread_local const bool bound = [] {
    cudaFree(nullptr);
    cudaGetLastError();
    return true;
  }();
  return bound ? fn : nullptr;
}

// The tensor map of a contiguous f32 operand of `rank` dimensions (dims
// innermost first, `dims[0]` floats a row): a box of 32 columns (one
// 128-byte swizzled slab) × `box_rows` along dimension `row_dim`, one
// along the others; zero filled outside the tensor
inline int make_map_f32(CUtensorMap* map, const void* ptr, int rank,
                        const cuuint64_t* dims, int row_dim, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t strides[4];
  cuuint32_t box[5], unit[5];
  cuuint64_t stride = 4;
  for (int i = 0; i < rank; ++i) {
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
    box[i] = i == 0 ? 32 : i == row_dim ? (cuuint32_t)box_rows : 1;
    unit[i] = 1;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
      const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Whether TMA tensor maps can describe bf16 attention operands of head
// dims d and dv whose addresses OR together to `addr`: 16-byte aligned
// operands and row strides (d and dv multiples of 8 bf16).  Both
// directions of the attention take their wgmma route exactly there.
inline bool tma_takes_bf16(int d, int dv, uintptr_t addr) {
  return d % 8 == 0 && dv % 8 == 0 && addr % 16 == 0;
}

// The tensor map of a contiguous bf16 [batch, rows, heads, width] operand:
// a box of 64 columns (one 128-byte swizzled slab) × 64 rows of one head,
// zero filled outside the tensor
inline int make_map(CUtensorMap* map, const void* ptr, int batch, int rows,
                    int heads, int width) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)heads * width * 2,
                                 (cuuint64_t)rows * heads * width * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the 3-d box (c0, c1, c2) of `map` into shared `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

}  // namespace
