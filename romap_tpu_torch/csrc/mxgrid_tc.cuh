// Device helpers of the tensor-core encode backwards (mxgrid_folded.cu:
// `folded_bwd_tc`, K2/K6; mxgrid_unsnapped.cu: `unsnapped_bwd_tc`, K4/K8):
// 16-byte cp.async, the tent-basis A fragment built in registers (as one
// bf16 operand, or split into a bf16 hi and lo pair for fp32 inputs),
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
constexpr int kSmemPerBlock = 232448;  // dynamic shared memory a block may take on sm_90

// Tiles of 64 points the fp32 tensor-core backwards (K2/K4/K6/K8 in
// "tensor_core_split") sum in their registers before they add them to the
// gradient: the tensor cores' fp32 accumulation does not round to nearest,
// and its error grows with the number of 16-point steps a sum takes (5e-8
// of the largest entry a step at `quality`, against fp32's tolerance of
// 1e-4): at 64 tiles the unsnapped kernels read 1.3e-5 to 1.5e-5.
constexpr int kFlushTiles = 64;

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

// {lo, hi} -> bf16x2, round to nearest even (no relu: a split's lo part
// may be negative).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// x = hi + lo + r for two fp32 values: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in fp32), so |r| <= 2^-16 |x|. {lo, hi} packed as in
// pack_relu.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t* hi, uint32_t* lo) {
  const uint32_t h = pack_bf16x2(x0, x1);
  *hi = h;
  *lo = pack_bf16x2(x0 - __uint_as_float(h << 16), x1 - __uint_as_float(h & 0xffff0000u));
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

// hat_fragment for fp32 inputs: the tent in fp32 with the relu applied
// before the split, then a hi fragment `a` and a lo fragment `al`.
__device__ __forceinline__ void hat_fragment_split(float j0, float2 t_lo, float2 t_hi,
                                                   uint32_t* a, uint32_t* al) {
  const float j1 = j0 + 8.f;
  const auto tent = [](float t, float j) { return fmaxf(1.f - fabsf(t - j), 0.f); };
  split_bf16x2(tent(t_lo.x, j0), tent(t_lo.y, j0), a + 0, al + 0);
  split_bf16x2(tent(t_lo.x, j1), tent(t_lo.y, j1), a + 1, al + 1);
  split_bf16x2(tent(t_hi.x, j0), tent(t_hi.y, j0), a + 2, al + 2);
  split_bf16x2(tent(t_hi.x, j1), tent(t_hi.y, j1), a + 3, al + 3);
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
