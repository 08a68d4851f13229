// Split-path MX-grid plane kernels for sm_90a: forward (K9) and backward
// (K10) over every plane level of the spec.
//
// K9 replaces the Pallas kernel `_make_fwd_planes_kernel`
// (romap_tpu/ops/mxgrid_pallas.py:268-278, driven by `_planes_forward`
// 698-721); K10 replaces `_make_bwd_planes_kernel` (622-637, driven by
// `_bwd_impl_t` 831-875). They serve the split path (MX_FUSED=0) of a spec
// with planes, snapped or not, beside the CP kernels K5/K6 or K7/K8. Unlike
// the fused K1-K4 they take several plane levels (at most kMaxPlaneLevels),
// each level's shape a kernel argument.
//
// Per point, level l and pair i: f_pl is the bilinear sample of plane
// (l, i) at (x_u, x_v), f_li the linear sample of line (l, i) at x_w, at
// the line resolution max(ru, rv) (mxgrid_pallas.py:193, 845). K9 stores
// both, rounded to T; the caller forms f_pl * f_li in the table dtype, as
// the reference does outside its kernel (741). K10 is the transpose:
//   dL[l][i][j, c]    += hat_w[j] g[c] f_pl[c]
//   dP[l][i][a, b, c] += hat_u[a] hat_v[b] g[c] f_li[c]
// Taps are plane_pair_fwd/bwd's (mxgrid_common.cuh): knots outside
// [0, r-1] are dropped, never clamped, and the weights round as the dense
// tent does.
//
// What bounds them on the card: bytes. At the flagship's one (128, 64, 4)
// level K9 reads a point's 12 B and writes 2 x 12 values (48 B in bf16), and
// reads 4 corners + 2 line taps per pair and channel from tables that stay
// in L1/L2 (99,840 values per object). K10 reads the point, f_pl, f_li and
// g (36 values) and scatters 6 fp32 adds per pair and channel: the line
// gradient into shared memory (7,680 B at the flagship level, flushed with
// one atomicAdd per entry), the plane gradient with global atomics into L2
// (393 KB fp32 per object), as K2 does. Atomics make K10's sums
// order-dependent. One point per thread, every pair and level in the
// thread, the object on grid y.
//
// Layouts (per object o, leading axis O on every array; level l):
//   pts    [O, P, 3] f32
//   planes[l] [O, 3, ru_l, rv_l, kp_l] T    plines[l] [O, 3, rw_l, kp_l] T
//   fpl, fli [O, 3 sum(kp), P] T, rows level-major, then pair, then channel
//   g      [O, P, 3 sum(kp)] T (the plane block of the encode's cotangent)
//   dplanes[l], dplines[l] shaped as planes[l], plines[l], f32
// T is float (dtype code 0) or __nv_bfloat16 (dtype code 1).

#include "mxgrid_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) planes_fwd(
    const float* __restrict__ pts, Levels lv, T* __restrict__ fpl,
    T* __restrict__ fli, int P, int kpl, int axes) {
  const int o = blockIdx.y;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    int row0 = 0;
    for (int l = 0; l < lv.n; ++l) {
      const int ru = lv.ru[l], rv = lv.rv[l], kp = lv.kp[l], rw = lv.rw[l];
      const T* pl_o = (const T*)lv.planes[l] + (size_t)o * 3 * ru * rv * kp;
      const T* li_o = (const T*)lv.plines[l] + (size_t)o * 3 * rw * kp;
      T* fpl_o = fpl + ((size_t)o * kpl + row0) * P;
      T* fli_o = fli + ((size_t)o * kpl + row0) * P;
      for (int i = 0; i < 3; ++i)
        plane_pair_fwd<T, false>(x, i, axes, pl_o, li_o, fpl_o, fli_o,
                                 nullptr, P, p, ru, rv, kp, rw);
      row0 += 3 * kp;
    }
  }
}

__host__ __device__ __forceinline__ int line_floats(const Levels& lv) {
  int n = 0;
  for (int l = 0; l < lv.n; ++l) n += 3 * lv.rw[l] * odd_word_stride(lv.kp[l], 4);
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) planes_bwd(
    const float* __restrict__ pts, const T* __restrict__ fpl,
    const T* __restrict__ fli, const T* __restrict__ g, Levels lv, int P,
    int kpl, int axes) {
  extern __shared__ __align__(16) float dl_s[];  // per level [3 rw, ls]
  const int n_s = line_floats(lv);
  for (int j = threadIdx.x; j < n_s; j += blockDim.x) dl_s[j] = 0.f;
  __syncthreads();

  const int o = blockIdx.y;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    const T* g_p = g + op * kpl;
    int row0 = 0, s0 = 0;
    for (int l = 0; l < lv.n; ++l) {
      const int ru = lv.ru[l], rv = lv.rv[l], kp = lv.kp[l], rw = lv.rw[l];
      const int ls = odd_word_stride(kp, 4);
      const T* fpl_o = fpl + ((size_t)o * kpl + row0) * P;
      const T* fli_o = fli + ((size_t)o * kpl + row0) * P;
      float* dp_o = (float*)lv.planes[l] + (size_t)o * 3 * ru * rv * kp;
      for (int i = 0; i < 3; ++i)
        plane_pair_bwd<T>(x, i, axes, g_p + row0 + i * kp, fpl_o, fli_o,
                          dl_s + s0 + i * rw * ls, ls,
                          dp_o + (size_t)i * ru * rv * kp, P, p, ru, rv, kp,
                          rw);
      row0 += 3 * kp;
      s0 += 3 * rw * ls;
    }
  }

  __syncthreads();
  int s0 = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int kp = lv.kp[l], rw = lv.rw[l], ls = odd_word_stride(kp, 4);
    float* dl_g = (float*)lv.plines[l] + (size_t)o * 3 * rw * kp;
    for (int j = threadIdx.x; j < 3 * rw * kp; j += blockDim.x) {
      const float v = dl_s[s0 + (j / kp) * ls + j % kp];
      if (v != 0.f) atomicAdd(&dl_g[j], v);
    }
    s0 += 3 * rw * ls;
  }
}

template <typename T>
int launch_fwd(const void* pts, const Levels& lv, void* fpl, void* fli, int O,
               int P, int kpl, int axes, cudaStream_t stream) {
  dim3 grid;
  cudaError_t err = plan(planes_fwd<T>, 0, O, P, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  planes_fwd<T><<<grid, kThreads, 0, stream>>>((const float*)pts, lv, (T*)fpl,
                                               (T*)fli, P, kpl, axes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* pts, const void* fpl, const void* fli,
               const void* g, const Levels& lv, int O, int P, int kpl,
               int axes, cudaStream_t stream) {
  const size_t smem = (size_t)line_floats(lv) * sizeof(float);
  dim3 grid;
  cudaError_t err = plan(planes_bwd<T>, smem, O, P, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  planes_bwd<T><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)fpl, (const T*)fli, (const T*)g, lv, P, kpl,
      axes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = launched); the launch is asynchronous
// on `stream`. The per-level arguments are host arrays of `n_levels`
// entries (at most 4): device pointers, and the levels' (ru, rv, kp).
// `axes` packs the (u, v, w) axis of the three plane pairs, 2 bits each.

// K9: fpl and fli [O, 3 sum(kp), P].
int romap_mx_planes_fwd(int dtype, const void* pts, int n_levels,
                        void* const* planes, void* const* plines,
                        const int* ru, const int* rv, const int* kp, void* fpl,
                        void* fli, int O, int P, int axes, void* stream) {
  Levels lv;
  int kpl = 0;
  const int bad = make_levels(n_levels, planes, plines, ru, rv, kp, &lv, &kpl);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(pts, lv, fpl, fli, O, P, kpl, axes, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(pts, lv, fpl, fli, O, P, kpl, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K10: dplanes[l] and dplines[l] f32 (zero-filled by the caller) from the
// residuals and the plane cotangent g [O, P, 3 sum(kp)].
int romap_mx_planes_bwd(int dtype, const void* pts, const void* fpl,
                        const void* fli, const void* g, int n_levels,
                        void* const* dplanes, void* const* dplines,
                        const int* ru, const int* rv, const int* kp, int O,
                        int P, int axes, void* stream) {
  Levels lv;
  int kpl = 0;
  const int bad =
      make_levels(n_levels, dplanes, dplines, ru, rv, kp, &lv, &kpl);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(pts, fpl, fli, g, lv, O, P, kpl, axes, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(pts, fpl, fli, g, lv, O, P, kpl, axes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
