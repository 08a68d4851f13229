// Folded MX-grid encode for sm_90a: forward (K1) and backward (K2) with one
// plane level, and their CP-only variants (K5, K6).
//
// K1 replaces the Pallas kernel `_make_folded_fused_fwd_kernel`
// (romap_tpu/ops/mxgrid_pallas.py:448-465, driven by `_folded_fused_forward`
// 496-535); K2 replaces `_make_folded_fused_bwd_kernel` (468-487, driven by
// `_folded_fused_backward` 547-580). K5 replaces `_folded_cp_kernel`
// (583-588, driven by `_folded_cp_forward` 603-619) and K6
// `_folded_bwd_cp_kernel` (591-600, driven by `_bwd_impl_t` 790-807): the
// same kernels instantiated without the plane level (kPlanes = false), as
// the CP-only `fast` preset needs. The Python side (ops/mxgrid_cuda.py)
// folds the CP ladder into W_eff before K1/K5 and unfolds dW_eff after
// K2/K6.
//
// The Pallas kernels build dense tent bases and feed the TPU's matrix unit.
// A tent row has exactly two non-zeros (knots floor(t) and floor(t)+1 with
// t = x (r-1)), so here every basis product is a two-tap lerp per axis and a
// four-corner bilinear read per plane, one point per thread.
//
// What bounds them on the card. K1 reads, per point, 2 taps x 3 axes x K
// rows of W_eff (the bulk of its loads), 4 corners x 3 pairs x kp plane
// values and 2 x 3 x kp line values, and writes the features plus the
// residuals (K + 3K + 2 x 3kp values). The scattered table reads dominate:
// W_eff (3 x rfp x K, 55 KB in bf16 at the flagship spec) is staged once
// per block in shared memory, rows padded to an odd word count against
// bank conflicts; planes and plane lines stay in global memory
// behind L1/L2. K2 does the transposed scatter: per point 6K fp32 adds
// into dW_eff, 6kp into the plane lines and 12kp into the planes. dW_eff
// and dL accumulate per block in shared memory (110 KB fp32 at the
// flagship spec) and are flushed with one global atomicAdd per entry; the
// plane gradient (3 x 128 x 64 x 4 fp32 = 393 KB) does not fit and takes
// global atomics into L2. Atomics make K2's sums order-dependent.
// At the `fast` spec (K = 64, rf = 256) K5 stages 101,376 B in bf16 and
// 199,680 B in fp32, and K6's fp32 dW_eff takes 199,680 B: one 256-thread
// block per SM in fp32, two in bf16.
//
// Layouts (per object o, leading axis O on every array):
//   pts    [O, P, 3] f32          weff   [O, 3, rfp, K]   T
//   planes [O, 3, ru, rv, kp] T   plines [O, 3, rw, kp]   T   (rw = max(ru, rv))
//   out    [O, P, K + 3kp] T      afac   [O, 3, K, P]     T
//   fpl, fli [O, 3kp, P] T        g      [O, P, K + 3kp]  T
//   dweff  [O, 3, rfp, K] f32     dplanes/dplines as planes/plines, f32
// (kp = 0 and no plane arrays for K5/K6.) T is float (dtype code 0) or
// __nv_bfloat16 (dtype code 1). Arithmetic is fp32 in registers; values are
// rounded to T only where they are stored, except K5's CP product, which
// rounds after each factor as the reference forms it outside its kernel
// (`afac[0] * afac[1] * afac[2]` in the table dtype, mxgrid_pallas.py:736).
// `axes` packs the (u, v, w) axis of the three plane pairs, 2 bits each.

#include "mxgrid_common.cuh"

namespace {

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(kThreads) folded_fused_fwd(
    const float* __restrict__ pts, const T* __restrict__ weff,
    const T* __restrict__ planes, const T* __restrict__ plines,
    T* __restrict__ out, T* __restrict__ afac, T* __restrict__ fpl,
    T* __restrict__ fli, int P, int K, int rf, int rfp, int ru, int rv, int kp,
    int rw, int axes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // W_eff [3 * rfp, ks]
  const int ks = odd_word_stride(K, sizeof(T));
  const int o = blockIdx.y;
  const int n_w = 3 * rfp * K;
  const T* w_g = weff + (size_t)o * n_w;
  for (int j = threadIdx.x; j < n_w; j += blockDim.x)
    w_s[(j / K) * ks + j % K] = w_g[j];
  __syncthreads();

  const int kpl = 3 * kp;
  const int kout = K + kpl;
  T* afac_o = afac + (size_t)o * 3 * K * P;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    T* out_p = out + op * kout;

    // CP lines: A_d[k] = lerp of W_eff_d rows; out[k] = A_0 A_1 A_2 from
    // the stored (rounded) factors, as the Pallas kernel forms it.
    Taps t[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) t[d] = tent_taps(x[d], rf);
    for (int k = 0; k < K; ++k) {
      float prod = 1.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T* wd = w_s + d * rfp * ks;
        const float a = t[d].w0 * to_f(wd[t[d].j0 * ks + k]) +
                        t[d].w1 * to_f(wd[t[d].j1 * ks + k]);
        const T a_t = from_f<T>(a);
        afac_o[((size_t)d * K + k) * P + p] = a_t;
        prod = kPlanes ? prod * to_f(a_t) : to_f(from_f<T>(prod * to_f(a_t)));
      }
      out_p[k] = from_f<T>(prod);
    }

    if constexpr (kPlanes) {
      const T* pl_o = planes + (size_t)o * 3 * ru * rv * kp;
      const T* li_o = plines + (size_t)o * 3 * rw * kp;
      T* fpl_o = fpl + (size_t)o * kpl * P;
      T* fli_o = fli + (size_t)o * kpl * P;
      for (int i = 0; i < 3; ++i)
        plane_pair_fwd<T>(x, i, axes, pl_o, li_o, fpl_o, fli_o,
                          out_p + K + i * kp, P, p, ru, rv, kp, rw);
    }
  }
}

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(kThreads) folded_fused_bwd(
    const float* __restrict__ pts, const T* __restrict__ afac,
    const T* __restrict__ fpl, const T* __restrict__ fli,
    const T* __restrict__ g, float* __restrict__ dweff,
    float* __restrict__ dplanes, float* __restrict__ dplines, int P, int K,
    int rf, int rfp, int ru, int rv, int kp, int rw, int axes) {
  extern __shared__ __align__(16) float s_acc[];
  const int ks = odd_word_stride(K, 4), ls = odd_word_stride(kp, 4);
  const int n_w = 3 * rfp * K;
  const int n_l = 3 * rw * kp;
  float* dw_s = s_acc;                   // dW_eff [3 * rfp, ks]
  float* dl_s = s_acc + 3 * rfp * ks;    // dL [3 * rw, ls]
  for (int j = threadIdx.x; j < 3 * rfp * ks + 3 * rw * ls; j += blockDim.x)
    s_acc[j] = 0.f;
  __syncthreads();

  const int o = blockIdx.y;
  const int kpl = 3 * kp;
  const int kout = K + kpl;
  const T* afac_o = afac + (size_t)o * 3 * K * P;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    const T* g_p = g + op * kout;

    // dW_eff_d[j, k] += hat_d[j] * g[k] * A_e[k] * A_f[k]
    Taps t[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) t[d] = tent_taps(x[d], rf);
    for (int k = 0; k < K; ++k) {
      const float gk = to_f(g_p[k]);
      const float a0 = to_f(afac_o[((size_t)0 * K + k) * P + p]);
      const float a1 = to_f(afac_o[((size_t)1 * K + k) * P + p]);
      const float a2 = to_f(afac_o[((size_t)2 * K + k) * P + p]);
      const float u[3] = {gk * a1 * a2, gk * a0 * a2, gk * a0 * a1};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float* wd = dw_s + d * rfp * ks;
        add_if(&wd[t[d].j0 * ks + k], t[d].w0, u[d]);
        add_if(&wd[t[d].j1 * ks + k], t[d].w1, u[d]);
      }
    }

    if constexpr (kPlanes) {
      const T* fpl_o = fpl + (size_t)o * kpl * P;
      const T* fli_o = fli + (size_t)o * kpl * P;
      float* dp_o = dplanes + (size_t)o * 3 * ru * rv * kp;
      for (int i = 0; i < 3; ++i)
        plane_pair_bwd<T>(x, i, axes, g_p + K + i * kp, fpl_o, fli_o,
                          dl_s + i * rw * ls, ls,
                          dp_o + (size_t)i * ru * rv * kp, P, p, ru, rv, kp,
                          rw);
    }
  }

  __syncthreads();
  float* dw_g = dweff + (size_t)o * n_w;
  for (int j = threadIdx.x; j < n_w; j += blockDim.x) {
    const float v = dw_s[(j / K) * ks + j % K];
    if (v != 0.f) atomicAdd(&dw_g[j], v);
  }
  if constexpr (kPlanes) {
    float* dl_g = dplines + (size_t)o * n_l;
    for (int j = threadIdx.x; j < n_l; j += blockDim.x) {
      const float v = dl_s[(j / kp) * ls + j % kp];
      if (v != 0.f) atomicAdd(&dl_g[j], v);
    }
  }
}

template <typename T, bool kPlanes>
int launch_fwd(const void* pts, const void* weff, const void* planes,
               const void* plines, void* out, void* afac, void* fpl, void* fli,
               int O, int P, int K, int rf, int rfp, int ru, int rv, int kp,
               int rw, int axes, cudaStream_t stream) {
  const size_t smem = (size_t)3 * rfp * odd_word_stride(K, sizeof(T)) * sizeof(T);
  dim3 grid;
  cudaError_t err = plan(folded_fused_fwd<T, kPlanes>, smem, O, P, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  folded_fused_fwd<T, kPlanes><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)weff, (const T*)planes, (const T*)plines,
      (T*)out, (T*)afac, (T*)fpl, (T*)fli, P, K, rf, rfp, ru, rv, kp, rw, axes);
  return (int)cudaGetLastError();
}

template <typename T, bool kPlanes>
int launch_bwd(const void* pts, const void* afac, const void* fpl,
               const void* fli, const void* g, void* dweff, void* dplanes,
               void* dplines, int O, int P, int K, int rf, int rfp, int ru,
               int rv, int kp, int rw, int axes, cudaStream_t stream) {
  const size_t smem = ((size_t)3 * rfp * odd_word_stride(K, 4) +
                       (size_t)3 * rw * odd_word_stride(kp, 4)) * sizeof(float);
  dim3 grid;
  cudaError_t err = plan(folded_fused_bwd<T, kPlanes>, smem, O, P, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  folded_fused_bwd<T, kPlanes><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)afac, (const T*)fpl, (const T*)fli,
      (const T*)g, (float*)dweff, (float*)dplanes, (float*)dplines, P, K, rf,
      rfp, ru, rv, kp, rw, axes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = launched). The launch is asynchronous
// on `stream`; faults during the run surface at the caller's next sync.

// K1.
int romap_mx_folded_fwd(int dtype, const void* pts, const void* weff,
                        const void* planes, const void* plines, void* out,
                        void* afac, void* fpl, void* fli, int O, int P, int K,
                        int rf, int rfp, int ru, int rv, int kp, int rw,
                        int axes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float, true>(pts, weff, planes, plines, out, afac, fpl,
                                   fli, O, P, K, rf, rfp, ru, rv, kp, rw, axes, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, true>(pts, weff, planes, plines, out,
                                           afac, fpl, fli, O, P, K, rf, rfp,
                                           ru, rv, kp, rw, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K2. dweff, dplanes and dplines must be zero-filled by the caller.
int romap_mx_folded_bwd(int dtype, const void* pts, const void* afac,
                        const void* fpl, const void* fli, const void* g,
                        void* dweff, void* dplanes, void* dplines, int O,
                        int P, int K, int rf, int rfp, int ru, int rv, int kp,
                        int rw, int axes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float, true>(pts, afac, fpl, fli, g, dweff, dplanes,
                                   dplines, O, P, K, rf, rfp, ru, rv, kp, rw,
                                   axes, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, true>(pts, afac, fpl, fli, g, dweff,
                                           dplanes, dplines, O, P, K, rf, rfp,
                                           ru, rv, kp, rw, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K5: out [O, P, K] and afac [O, 3, K, P] from W_eff alone.
int romap_mx_folded_cp_fwd(int dtype, const void* pts, const void* weff,
                           void* out, void* afac, int O, int P, int K, int rf,
                           int rfp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float, false>(pts, weff, nullptr, nullptr, out, afac,
                                    nullptr, nullptr, O, P, K, rf, rfp, 0, 0,
                                    0, 0, 0, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, false>(pts, weff, nullptr, nullptr, out,
                                            afac, nullptr, nullptr, O, P, K,
                                            rf, rfp, 0, 0, 0, 0, 0, s);
  return (int)cudaErrorInvalidValue;
}

// K6: dweff [O, 3, rfp, K] f32 (zero-filled by the caller) from afac and
// the cotangent g [O, P, K].
int romap_mx_folded_cp_bwd(int dtype, const void* pts, const void* afac,
                           const void* g, void* dweff, int O, int P, int K,
                           int rf, int rfp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float, false>(pts, afac, nullptr, nullptr, g, dweff,
                                    nullptr, nullptr, O, P, K, rf, rfp, 0, 0,
                                    0, 0, 0, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, false>(pts, afac, nullptr, nullptr, g,
                                            dweff, nullptr, nullptr, O, P, K,
                                            rf, rfp, 0, 0, 0, 0, 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
