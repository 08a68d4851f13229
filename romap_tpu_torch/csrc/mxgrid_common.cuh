// Helpers shared by the MX-grid encode kernels (mxgrid_folded.cu: K1, K2,
// K5, K6; mxgrid_unsnapped.cu: K3, K4, K7, K8; mxgrid_planes.cu: K9, K10;
// mxgrid_points.cu: K0).
// Everything here is internal to the translation unit that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The two non-zeros of hat_r(x)[i] = max(0, 1 - |x (r-1) - i|). Weights are
// computed with the same fp32 operations as the dense tent, so they agree
// with it bit for bit. A knot outside [0, r-1] is dropped (weight 0, index
// clamped only to keep the load in bounds); this is what the dense basis
// does for points that rounding put slightly outside the unit cube.
struct Taps {
  int j0, j1;
  float w0, w1;
};

__device__ __forceinline__ Taps tent_taps(float x, int r) {
  Taps tp{0, 0, 0.f, 0.f};
  const float t = __fmul_rn(x, (float)(r - 1));  // rounded, never fused
  if (!(t > -1.f && t < (float)r)) return tp;  // no knot in reach (or NaN)
  const float f = floorf(t);
  const int i = (int)f;
  if (i >= 0) {
    tp.j0 = i;
    tp.w0 = 1.f - (t - f);
  }
  if (i + 1 <= r - 1) {
    tp.j1 = i + 1;
    tp.w1 = 1.f - ((f + 1.f) - t);
  }
  return tp;
}

// d w0 / dx and d w1 / dx of tent_taps' two knots: -(r-1) and r-1 where a
// knot is kept, 0 where it is dropped. Away from the knots this is autograd
// of the dense tent; on a knot (a measure-zero set) it takes the slope of
// the interval [j0, j1] that tent_taps picks.
struct Slopes {
  float s0, s1;
};

__device__ __forceinline__ Slopes tent_slopes(float x, int r) {
  Slopes s{0.f, 0.f};
  const float t = __fmul_rn(x, (float)(r - 1));
  if (!(t > -1.f && t < (float)r)) return s;
  const int i = (int)floorf(t);
  if (i >= 0) s.s0 = -(float)(r - 1);
  if (i + 1 <= r - 1) s.s1 = (float)(r - 1);
  return s;
}

// The CP resolution ladder: level l has res[l] knots starting at row off[l]
// (the unsnapped ladder; a folded table is one level of rf knots).
constexpr int kMaxLevels = 8;

struct Ladder {
  int n;
  int res[kMaxLevels];
  int off[kMaxLevels];
};

inline int make_ladder(const int* res, const int* off, int n, Ladder* lad) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  lad->n = n;
  for (int l = 0; l < kMaxLevels; ++l) {
    lad->res[l] = l < n ? res[l] : 0;
    lad->off[l] = l < n ? off[l] : 0;
  }
  return 0;
}

// The plane levels: shapes, and per level one pointer to the planes (or
// their gradient) and one to the plane lines (or theirs).
constexpr int kMaxPlaneLevels = 4;

struct Levels {
  int n;
  int ru[kMaxPlaneLevels], rv[kMaxPlaneLevels], kp[kMaxPlaneLevels],
      rw[kMaxPlaneLevels];
  void* planes[kMaxPlaneLevels];
  void* plines[kMaxPlaneLevels];
};

inline int make_levels(int n, void* const* planes, void* const* plines,
                       const int* ru, const int* rv, const int* kp, Levels* lv,
                       int* kpl) {
  if (n < 1 || n > kMaxPlaneLevels) return (int)cudaErrorInvalidValue;
  *lv = Levels{};
  lv->n = n;
  *kpl = 0;
  for (int l = 0; l < n; ++l) {
    lv->ru[l] = ru[l];
    lv->rv[l] = rv[l];
    lv->kp[l] = kp[l];
    lv->rw[l] = ru[l] > rv[l] ? ru[l] : rv[l];
    lv->planes[l] = planes[l];
    lv->plines[l] = plines[l];
    *kpl += 3 * kp[l];
  }
  return 0;
}

// Row stride (in elements of `bytes` each) of a table staged in shared
// memory: n rounded up so that a row spans an odd number of 4-byte words.
// Threads of a warp read rows at unrelated knots; with an even word stride
// (K = 48: 24 or 48 words) they fall into 2-4 of the 32 banks.
__host__ __device__ __forceinline__ int odd_word_stride(int n, int bytes) {
  int words = (n * bytes + 3) / 4;
  if (words % 2 == 0) ++words;
  return words * 4 / bytes;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Four consecutive channels of a table row staged in shared memory, as fp32
// (two 32-bit loads in bf16: an odd-word row stride aligns rows to 4 bytes).
__device__ __forceinline__ void load4(const float* p, float* v) {
  v[0] = p[0]; v[1] = p[1]; v[2] = p[2]; v[3] = p[3];
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Four consecutive channels stored as one vector (16 B fp32, 8 B bf16).
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ int pair_axis(int axes, int pair, int slot) {
  return (axes >> (6 * pair + 2 * slot)) & 3;
}

__device__ __forceinline__ void add_if(float* dst, float w, float v) {
  if (w != 0.f) atomicAdd(dst, w * v);
}

// Plane pair i of one point, forward: bilinear plane sample f_pl x linear
// line sample f_li per channel; stores both residuals and, with kOut, their
// product (out_p points at the pair's first output column; unused without).
template <typename T, bool kOut = true>
__device__ __forceinline__ void plane_pair_fwd(
    const float* x, int i, int axes, const T* pl_o, const T* li_o, T* fpl_o,
    T* fli_o, T* out_p, int P, int p, int ru, int rv, int kp, int rw) {
  const Taps tu = tent_taps(x[pair_axis(axes, i, 0)], ru);
  const Taps tv = tent_taps(x[pair_axis(axes, i, 1)], rv);
  const Taps tw = tent_taps(x[pair_axis(axes, i, 2)], rw);
  const T* p_i = pl_o + (size_t)i * ru * rv * kp;
  const T* l_i = li_o + (size_t)i * rw * kp;
  const T* c00 = p_i + ((size_t)tu.j0 * rv + tv.j0) * kp;
  const T* c01 = p_i + ((size_t)tu.j0 * rv + tv.j1) * kp;
  const T* c10 = p_i + ((size_t)tu.j1 * rv + tv.j0) * kp;
  const T* c11 = p_i + ((size_t)tu.j1 * rv + tv.j1) * kp;
  for (int c = 0; c < kp; ++c) {
    const float f_pl =
        tu.w0 * (tv.w0 * to_f(c00[c]) + tv.w1 * to_f(c01[c])) +
        tu.w1 * (tv.w0 * to_f(c10[c]) + tv.w1 * to_f(c11[c]));
    const float f_li = tw.w0 * to_f(l_i[tw.j0 * kp + c]) +
                       tw.w1 * to_f(l_i[tw.j1 * kp + c]);
    const int row = i * kp + c;
    fpl_o[(size_t)row * P + p] = from_f<T>(f_pl);
    fli_o[(size_t)row * P + p] = from_f<T>(f_li);
    if constexpr (kOut) out_p[c] = from_f<T>(f_pl * f_li);
  }
}

// dst[0..3] += w * v[0..3] as one 16-byte atomic (dst 16-byte aligned).
__device__ __forceinline__ void red4_if(float* dst, float w, const float* v) {
  if (w == 0.f) return;
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(w * v[0], w * v[1], w * v[2], w * v[3]));
#else
#pragma unroll
  for (int c = 0; c < 4; ++c) atomicAdd(dst + c, w * v[c]);
#endif
}

// Plane pair i of one point, backward:
//   dL_i[j, c] += hat_w[j] g_i[c] f_pl[c]      (l_i: shared, row stride ls)
//   dP_i[a, b, c] += hat_u[a] hat_v[b] g_i[c] f_li[c]   (p_i: global; four
//   channels a 16-byte atomic where kp % 4 == 0, one at a time otherwise)
// g_p points at the pair's first cotangent column.
template <typename T>
__device__ __forceinline__ void plane_pair_bwd(
    const float* x, int i, int axes, const T* g_p, const T* fpl_o,
    const T* fli_o, float* l_i, int ls, float* p_i, int P, int p, int ru,
    int rv, int kp, int rw) {
  const Taps tu = tent_taps(x[pair_axis(axes, i, 0)], ru);
  const Taps tv = tent_taps(x[pair_axis(axes, i, 1)], rv);
  const Taps tw = tent_taps(x[pair_axis(axes, i, 2)], rw);
  float* c00 = p_i + ((size_t)tu.j0 * rv + tv.j0) * kp;
  float* c01 = p_i + ((size_t)tu.j0 * rv + tv.j1) * kp;
  float* c10 = p_i + ((size_t)tu.j1 * rv + tv.j0) * kp;
  float* c11 = p_i + ((size_t)tu.j1 * rv + tv.j1) * kp;
  const float w00 = tu.w0 * tv.w0, w01 = tu.w0 * tv.w1, w10 = tu.w1 * tv.w0,
              w11 = tu.w1 * tv.w1;
  for (int c0 = 0; c0 < kp; c0 += 4) {
    const int n = kp - c0 < 4 ? kp - c0 : 4;
    float gl[4];
    for (int c = 0; c < n; ++c) {
      const int row = i * kp + c0 + c;
      const float gi = to_f(g_p[c0 + c]);
      const float gp = gi * to_f(fpl_o[(size_t)row * P + p]);
      gl[c] = gi * to_f(fli_o[(size_t)row * P + p]);
      add_if(&l_i[tw.j0 * ls + c0 + c], tw.w0, gp);
      add_if(&l_i[tw.j1 * ls + c0 + c], tw.w1, gp);
    }
    if (kp % 4 == 0) {
      red4_if(c00 + c0, w00, gl);
      red4_if(c01 + c0, w01, gl);
      red4_if(c10 + c0, w10, gl);
      red4_if(c11 + c0, w11, gl);
    } else {
      for (int c = 0; c < n; ++c) {
        add_if(&c00[c0 + c], w00, gl[c]);
        add_if(&c01[c0 + c], w01, gl[c]);
        add_if(&c10[c0 + c], w10, gl[c]);
        add_if(&c11[c0 + c], w11, gl[c]);
      }
    }
  }
}

// One grid of (blocks per object, O, nz) that is resident in one wave: as
// many blocks per object and z slice as fit the slots the card has for this
// kernel (blocks per SM by its shared memory and registers, times SMs),
// rounded down, at least one, and no more than the points need (`per_block`
// points a block and pass); each block strides over its object's points.
// Rounding up instead (10 objects on 132 one-block SMs: 14 x 10 = 140
// blocks) leaves a second wave of a few blocks that runs alone.
// Returns the error of a launch the card would refuse (e.g.
// cudaErrorInvalidValue when `smem` exceeds a block's limit).
template <typename Kern>
cudaError_t plan(Kern kernel, size_t smem, int O, int P, int nz, dim3* grid,
                 int threads = kThreads, int per_block = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (P + per_block - 1) / per_block;
  const int fill = per_sm * sms / (O * nz);
  int bpo = need < fill ? need : fill;
  *grid = dim3(bpo < 1 ? 1 : bpo, O, nz);
  return cudaSuccess;
}

}  // namespace
