// Device helpers of the tensor-core encode backwards (mxgrid_folded.cu:
// `folded_bwd_tc`, K2/K6; mxgrid_unsnapped.cu: `unsnapped_bwd_tc`, K4/K8):
// 16-byte cp.async, the tent-basis A fragment built in registers,
// mma.sync.m16n8k16 (bf16 in, fp32 out) and ldmatrix (the 16-byte vector
// atomic of the plane gradient, `red4_if`, is in mxgrid_common.cuh).
// Internal to the translation unit that includes it.
#pragma once

#include "mxgrid_common.cuh"

#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;        // points a tile: four k-steps of 16
constexpr int kRow = 72;         // bf16 elements of a 64-point row in shared
                                 // memory: 128 B + 16 B, so that 8 rows of a
                                 // 16-byte column fall into 8 bank groups
constexpr int kTcRw = 128;       // plane line rows: 8 row tiles

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// {lo, hi} -> bf16x2 of max(0, .), round to nearest even.
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// A fragment (16 rows x 16 points) of a tent basis: rows j0 and j0 + 8 of
// this lane, points (2q, 2q+1) from t_lo and (2q+8, 2q+9) from t_hi.
__device__ __forceinline__ void hat_fragment(float j0, float2 t_lo, float2 t_hi, uint32_t* a) {
  const float j1 = j0 + 8.f;
  a[0] = pack_relu(1.f - fabsf(t_lo.x - j0), 1.f - fabsf(t_lo.y - j0));
  a[1] = pack_relu(1.f - fabsf(t_lo.x - j1), 1.f - fabsf(t_lo.y - j1));
  a[2] = pack_relu(1.f - fabsf(t_hi.x - j0), 1.f - fabsf(t_hi.y - j0));
  a[3] = pack_relu(1.f - fabsf(t_hi.x - j1), 1.f - fabsf(t_hi.y - j1));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(const void* smem, uint32_t* r) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
