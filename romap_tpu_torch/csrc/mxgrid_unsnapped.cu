// Unsnapped MX-grid encode for sm_90a: forward (K3) and backward (K4) with
// one plane level, and their CP-only variants (K7, K8).
//
// K3 replaces the Pallas kernel `_make_fused_fwd_kernel`
// (romap_tpu/ops/mxgrid_pallas.py:281-304, driven by `_fused_forward`
// 307-349); K4 replaces `_make_fused_bwd_kernel` (352-374, driven by
// `_fused_backward` 377-413). K7 replaces `_fwd_cp_kernel` (205-207, driven
// by `_cp_forward` 673-695) and K8 `_bwd_cp_kernel` (255-260, driven by
// `_bwd_impl_t` 809-827): the same kernels instantiated without the plane
// pair (kPlanes = false), as K5/K6 are K1/K2 without it. They serve
// `mx_snap_levels=False` (or MX_SNAP=0): the CP ladder is not folded, so
// every level of it is read. K7 writes the factors only: on its paths (a
// CP-only spec, or the split path MX_FUSED=0) the caller forms the product
// A_0 A_1 A_2 in the table dtype, as the reference does outside its kernel
// (mxgrid_pallas.py:736).
//
// The Pallas kernels multiply by the concatenated multi-level tent basis,
// row (level l, index i) carrying a = r_l - 1, b = i (`_column_consts`,
// 81-90). Here each level is a two-tap lerp of its own rows: 2 taps x L
// levels per axis (12 rows at the flagship's 6-level ladder, against 2 for
// the folded K1), each tap weight computed as tent_taps does, so points
// just outside the cube drop knots exactly as the dense tent does.
//
// What bounds them on the card: the per-axis table reads (2L x K values a
// point and axis), which come from shared memory. The whole table
// [3, total_res, K] does not fit a block in fp32 (273,420 B at the
// flagship's 465 rows, K = 48, odd-word row stride 49; the limit is
// 232,448 B), and K4's fp32 accumulator is as large in either dtype. So a
// block handles one axis, blockIdx.z = d: it stages W_d (91,140 B fp32,
// 46,500 B bf16), computes A_d for its points, and also plane pair d.
// K3 writes the factors A_d as residuals; a second short kernel forms
// out[:K] = A_0 A_1 A_2 from the stored (rounded) factors, in fp32, rounded
// once, as the Pallas kernel does (295-298). K4's block d accumulates dW_d
// (and the plane-line gradient of pair d) in shared memory and flushes
// them with one atomicAdd per entry; the plane gradient takes global
// atomics, as in K2. At the `fast` ladder (6 levels to 256, 580 rows,
// K = 64, odd-word stride 65) K7 stages 150,800 B per axis in fp32 and
// 76,560 B in bf16, and K8's fp32 accumulator takes 150,800 B.
//
// Layouts (per object o, leading axis O on every array):
//   pts    [O, P, 3] f32          lines  [O, 3, total_res, K]  T
//   planes [O, 3, ru, rv, kp] T   plines [O, 3, rw, kp]   T   (rw = max(ru, rv))
//   out    [O, P, K + 3kp] T      afac   [O, 3, K, P]     T
//   fpl, fli [O, 3kp, P] T        g      [O, P, K + 3kp]  T
//   dlines [O, 3, total_res, K] f32  dplanes/dplines as planes/plines, f32
// (kp = 0 and no plane arrays for K7/K8; K8's g is [O, P, K].)
// T is float (dtype code 0) or __nv_bfloat16 (dtype code 1); arithmetic is
// fp32 in registers, values are rounded to T where they are stored.

#include "mxgrid_common.cuh"

namespace {

constexpr int kMaxLevels = 8;

// The CP resolution ladder: level l has res[l] knots starting at row off[l].
struct Ladder {
  int n;
  int res[kMaxLevels];
  int off[kMaxLevels];
};

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(kThreads) unsnapped_fwd(
    const float* __restrict__ pts, const T* __restrict__ lines,
    const T* __restrict__ planes, const T* __restrict__ plines,
    T* __restrict__ out, T* __restrict__ afac, T* __restrict__ fpl,
    T* __restrict__ fli, Ladder lad, int P, int K, int total_res, int ru,
    int rv, int kp, int rw, int axes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // W_d [total_res, ks]
  const int ks = odd_word_stride(K, sizeof(T));
  const int o = blockIdx.y, d = blockIdx.z;
  const int n_w = total_res * K;
  const T* w_g = lines + ((size_t)o * 3 + d) * n_w;
  for (int j = threadIdx.x; j < n_w; j += blockDim.x)
    w_s[(j / K) * ks + j % K] = w_g[j];
  __syncthreads();

  const int kpl = 3 * kp;
  const int kout = K + kpl;
  T* afac_d = afac + ((size_t)o * 3 + d) * K * P;
  const T* pl_o = planes + (size_t)o * 3 * ru * rv * kp;
  const T* li_o = plines + (size_t)o * 3 * rw * kp;
  T* fpl_o = fpl + (size_t)o * kpl * P;
  T* fli_o = fli + (size_t)o * kpl * P;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};

    // Per level: the two rows (as shared-memory offsets) and their weights.
    int r0[kMaxLevels], r1[kMaxLevels];
    float w0[kMaxLevels], w1[kMaxLevels];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      r0[l] = r1[l] = 0;
      w0[l] = w1[l] = 0.f;
      if (l < lad.n) {
        const Taps tp = tent_taps(x[d], lad.res[l]);
        r0[l] = (lad.off[l] + tp.j0) * ks;
        r1[l] = (lad.off[l] + tp.j1) * ks;
        w0[l] = tp.w0;
        w1[l] = tp.w1;
      }
    }
    for (int k = 0; k < K; ++k) {
      float a = 0.f;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l)
        if (l < lad.n)
          a += w0[l] * to_f(w_s[r0[l] + k]) + w1[l] * to_f(w_s[r1[l] + k]);
      afac_d[(size_t)k * P + p] = from_f<T>(a);
    }

    if constexpr (kPlanes)
      plane_pair_fwd<T>(x, d, axes, pl_o, li_o, fpl_o, fli_o,
                        out + op * kout + K + d * kp, P, p, ru, rv, kp, rw);
  }
}

// out[o, p, k] = A_0 A_1 A_2 for k < K, from the stored factors.
template <typename T>
__global__ void __launch_bounds__(kThreads) cp_product(
    const T* __restrict__ afac, T* __restrict__ out, int P, int K, int kout) {
  const int o = blockIdx.y;
  const T* a_o = afac + (size_t)o * 3 * K * P;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    T* out_p = out + ((size_t)o * P + p) * kout;
    for (int k = 0; k < K; ++k) {
      const float prod = to_f(a_o[(size_t)k * P + p]) *
                         to_f(a_o[((size_t)K + k) * P + p]) *
                         to_f(a_o[((size_t)2 * K + k) * P + p]);
      out_p[k] = from_f<T>(prod);
    }
  }
}

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(kThreads) unsnapped_bwd(
    const float* __restrict__ pts, const T* __restrict__ afac,
    const T* __restrict__ fpl, const T* __restrict__ fli,
    const T* __restrict__ g, float* __restrict__ dlines,
    float* __restrict__ dplanes, float* __restrict__ dplines, Ladder lad,
    int P, int K, int total_res, int ru, int rv, int kp, int rw, int axes) {
  extern __shared__ __align__(16) float s_acc[];
  const int ks = odd_word_stride(K, 4), ls = odd_word_stride(kp, 4);
  float* dw_s = s_acc;                    // dW_d [total_res, ks]
  float* dl_s = s_acc + total_res * ks;   // dL_d [rw, ls]
  for (int j = threadIdx.x; j < total_res * ks + rw * ls; j += blockDim.x)
    s_acc[j] = 0.f;
  __syncthreads();

  const int o = blockIdx.y, d = blockIdx.z;
  const int e = d == 0 ? 1 : 0, f = d == 2 ? 1 : 2;  // the other two axes
  const int kpl = 3 * kp;
  const int kout = K + kpl;
  const T* afac_o = afac + (size_t)o * 3 * K * P;
  const T* fpl_o = fpl + (size_t)o * kpl * P;
  const T* fli_o = fli + (size_t)o * kpl * P;
  float* dp_d = dplanes + ((size_t)o * 3 + d) * ru * rv * kp;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    const T* g_p = g + op * kout;

    int r0[kMaxLevels], r1[kMaxLevels];
    float w0[kMaxLevels], w1[kMaxLevels];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      r0[l] = r1[l] = 0;
      w0[l] = w1[l] = 0.f;
      if (l < lad.n) {
        const Taps tp = tent_taps(x[d], lad.res[l]);
        r0[l] = (lad.off[l] + tp.j0) * ks;
        r1[l] = (lad.off[l] + tp.j1) * ks;
        w0[l] = tp.w0;
        w1[l] = tp.w1;
      }
    }
    // dW_d[row, k] += hat_d[row] * g[k] * A_e[k] * A_f[k]
    for (int k = 0; k < K; ++k) {
      const float gk = to_f(g_p[k]);
      const float ae = to_f(afac_o[((size_t)e * K + k) * P + p]);
      const float af = to_f(afac_o[((size_t)f * K + k) * P + p]);
      const float u = gk * ae * af;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l)
        if (l < lad.n) {
          add_if(&dw_s[r0[l] + k], w0[l], u);
          add_if(&dw_s[r1[l] + k], w1[l], u);
        }
    }

    if constexpr (kPlanes)
      plane_pair_bwd<T>(x, d, axes, g_p + K + d * kp, fpl_o, fli_o, dl_s, ls,
                        dp_d, P, p, ru, rv, kp, rw);
  }

  __syncthreads();
  float* dw_g = dlines + ((size_t)o * 3 + d) * total_res * K;
  for (int j = threadIdx.x; j < total_res * K; j += blockDim.x) {
    const float v = dw_s[(j / K) * ks + j % K];
    if (v != 0.f) atomicAdd(&dw_g[j], v);
  }
  if constexpr (kPlanes) {
    float* dl_g = dplines + ((size_t)o * 3 + d) * rw * kp;
    for (int j = threadIdx.x; j < rw * kp; j += blockDim.x) {
      const float v = dl_s[(j / kp) * ls + j % kp];
      if (v != 0.f) atomicAdd(&dl_g[j], v);
    }
  }
}

int make_ladder(const int* res, const int* off, int n, Ladder* lad) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  lad->n = n;
  for (int l = 0; l < kMaxLevels; ++l) {
    lad->res[l] = l < n ? res[l] : 0;
    lad->off[l] = l < n ? off[l] : 0;
  }
  return 0;
}

template <typename T, bool kPlanes>
int launch_fwd(const void* pts, const void* lines, const void* planes,
               const void* plines, void* out, void* afac, void* fpl, void* fli,
               const Ladder& lad, int O, int P, int K, int total_res, int ru,
               int rv, int kp, int rw, int axes, cudaStream_t stream) {
  const size_t smem = (size_t)total_res * odd_word_stride(K, sizeof(T)) * sizeof(T);
  dim3 grid;
  cudaError_t err = plan(unsnapped_fwd<T, kPlanes>, smem, O, P, 3, &grid);
  if (err != cudaSuccess) return (int)err;
  unsnapped_fwd<T, kPlanes><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)lines, (const T*)planes, (const T*)plines,
      (T*)out, (T*)afac, (T*)fpl, (T*)fli, lad, P, K, total_res, ru, rv, kp,
      rw, axes);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (!kPlanes) return 0;  // K7: the caller forms the product
  if ((err = plan(cp_product<T>, 0, O, P, 1, &grid)) != cudaSuccess)
    return (int)err;
  cp_product<T><<<grid, kThreads, 0, stream>>>((const T*)afac, (T*)out, P, K,
                                               K + 3 * kp);
  return (int)cudaGetLastError();
}

template <typename T, bool kPlanes>
int launch_bwd(const void* pts, const void* afac, const void* fpl,
               const void* fli, const void* g, void* dlines, void* dplanes,
               void* dplines, const Ladder& lad, int O, int P, int K,
               int total_res, int ru, int rv, int kp, int rw, int axes,
               cudaStream_t stream) {
  const size_t smem = ((size_t)total_res * odd_word_stride(K, 4) +
                       (size_t)rw * odd_word_stride(kp, 4)) * sizeof(float);
  dim3 grid;
  cudaError_t err = plan(unsnapped_bwd<T, kPlanes>, smem, O, P, 3, &grid);
  if (err != cudaSuccess) return (int)err;
  unsnapped_bwd<T, kPlanes><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)afac, (const T*)fpl, (const T*)fli,
      (const T*)g, (float*)dlines, (float*)dplanes, (float*)dplines, lad, P, K,
      total_res, ru, rv, kp, rw, axes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = launched); the launches are
// asynchronous on `stream`. `res` and `off` are host arrays of `n_levels`
// ints (the ladder's resolutions and row offsets), at most 8 levels.

// K3.
int romap_mx_unsnapped_fwd(int dtype, const void* pts, const void* lines,
                           const void* planes, const void* plines, void* out,
                           void* afac, void* fpl, void* fli, const int* res,
                           const int* off, int n_levels, int O, int P, int K,
                           int total_res, int ru, int rv, int kp, int rw,
                           int axes, void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float, true>(pts, lines, planes, plines, out, afac,
                                   fpl, fli, lad, O, P, K, total_res, ru, rv,
                                   kp, rw, axes, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, true>(pts, lines, planes, plines, out,
                                           afac, fpl, fli, lad, O, P, K,
                                           total_res, ru, rv, kp, rw, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K4. dlines, dplanes and dplines must be zero-filled by the caller.
int romap_mx_unsnapped_bwd(int dtype, const void* pts, const void* afac,
                           const void* fpl, const void* fli, const void* g,
                           void* dlines, void* dplanes, void* dplines,
                           const int* res, const int* off, int n_levels, int O,
                           int P, int K, int total_res, int ru, int rv, int kp,
                           int rw, int axes, void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float, true>(pts, afac, fpl, fli, g, dlines, dplanes,
                                   dplines, lad, O, P, K, total_res, ru, rv,
                                   kp, rw, axes, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, true>(pts, afac, fpl, fli, g, dlines,
                                           dplanes, dplines, lad, O, P, K,
                                           total_res, ru, rv, kp, rw, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K7: afac [O, 3, K, P] from the raw ladder lines alone.
int romap_mx_unsnapped_cp_fwd(int dtype, const void* pts, const void* lines,
                              void* afac, const int* res, const int* off,
                              int n_levels, int O, int P, int K, int total_res,
                              void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float, false>(pts, lines, nullptr, nullptr, nullptr,
                                    afac, nullptr, nullptr, lad, O, P, K,
                                    total_res, 0, 0, 0, 0, 0, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, false>(pts, lines, nullptr, nullptr,
                                            nullptr, afac, nullptr, nullptr,
                                            lad, O, P, K, total_res, 0, 0, 0,
                                            0, 0, s);
  return (int)cudaErrorInvalidValue;
}

// K8: dlines [O, 3, total_res, K] f32 (zero-filled by the caller) from afac
// and the CP cotangent g [O, P, K].
int romap_mx_unsnapped_cp_bwd(int dtype, const void* pts, const void* afac,
                              const void* g, void* dlines, const int* res,
                              const int* off, int n_levels, int O, int P,
                              int K, int total_res, void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float, false>(pts, afac, nullptr, nullptr, g, dlines,
                                    nullptr, nullptr, lad, O, P, K, total_res,
                                    0, 0, 0, 0, 0, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, false>(pts, afac, nullptr, nullptr, g,
                                            dlines, nullptr, nullptr, lad, O,
                                            P, K, total_res, 0, 0, 0, 0, 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
