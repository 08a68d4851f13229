// Folded MX-grid encode, forward (K1) and backward (K2), for sm_90a.
//
// K1 replaces the Pallas kernel `_make_folded_fused_fwd_kernel`
// (romap_tpu/ops/mxgrid_pallas.py:448-465, driven by `_folded_fused_forward`
// 496-535); K2 replaces `_make_folded_fused_bwd_kernel` (468-487, driven by
// `_folded_fused_backward` 547-580). The Python side (ops/mxgrid_cuda.py)
// folds the CP ladder into W_eff before K1 and unfolds dW_eff after K2.
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
//
// Layouts (per object o, leading axis O on every array):
//   pts    [O, P, 3] f32          weff   [O, 3, rfp, K]   T
//   planes [O, 3, ru, rv, kp] T   plines [O, 3, rw, kp]   T   (rw = max(ru, rv))
//   out    [O, P, K + 3kp] T      afac   [O, 3, K, P]     T
//   fpl, fli [O, 3kp, P] T        g      [O, P, K + 3kp]  T
//   dweff  [O, 3, rfp, K] f32     dplanes/dplines as planes/plines, f32
// T is float (dtype code 0) or __nv_bfloat16 (dtype code 1). Arithmetic is
// fp32 in registers; values are rounded to T only where they are stored.
// `axes` packs the (u, v, w) axis of the three plane pairs, 2 bits each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

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

// Row stride (in elements of `bytes` each) of a table staged in shared
// memory: n rounded up so that a row spans an odd number of 4-byte words.
// Threads of a warp read rows at unrelated knots; with an even word stride
// (K = 48: 24 or 48 words) they fall into 2-4 of the 32 banks.
__host__ __device__ __forceinline__ int odd_word_stride(int n, int bytes) {
  int words = (n * bytes + 3) / 4;
  if (words % 2 == 0) ++words;
  return words * 4 / bytes;
}

__device__ __forceinline__ int pair_axis(int axes, int pair, int slot) {
  return (axes >> (6 * pair + 2 * slot)) & 3;
}

template <typename T>
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
  const T* pl_o = planes + (size_t)o * 3 * ru * rv * kp;
  const T* li_o = plines + (size_t)o * 3 * rw * kp;
  T* afac_o = afac + (size_t)o * 3 * K * P;
  T* fpl_o = fpl + (size_t)o * kpl * P;
  T* fli_o = fli + (size_t)o * kpl * P;

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
        prod *= to_f(a_t);
      }
      out_p[k] = from_f<T>(prod);
    }

    // Plane pairs: bilinear plane sample x linear line sample.
    for (int i = 0; i < 3; ++i) {
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
        out_p[K + row] = from_f<T>(f_pl * f_li);
      }
    }
  }
}

__device__ __forceinline__ void add_if(float* dst, float w, float v) {
  if (w != 0.f) atomicAdd(dst, w * v);
}

template <typename T>
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
  const T* fpl_o = fpl + (size_t)o * kpl * P;
  const T* fli_o = fli + (size_t)o * kpl * P;
  float* dp_o = dplanes + (size_t)o * 3 * ru * rv * kp;

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

    // dL_i[j, c] += hat_w[j] g_i[c] f_pl[c];
    // dP_i[a, b, c] += hat_u[a] hat_v[b] g_i[c] f_li[c]
    for (int i = 0; i < 3; ++i) {
      const Taps tu = tent_taps(x[pair_axis(axes, i, 0)], ru);
      const Taps tv = tent_taps(x[pair_axis(axes, i, 1)], rv);
      const Taps tw = tent_taps(x[pair_axis(axes, i, 2)], rw);
      float* l_i = dl_s + i * rw * ls;
      float* p_i = dp_o + (size_t)i * ru * rv * kp;
      float* c00 = p_i + ((size_t)tu.j0 * rv + tv.j0) * kp;
      float* c01 = p_i + ((size_t)tu.j0 * rv + tv.j1) * kp;
      float* c10 = p_i + ((size_t)tu.j1 * rv + tv.j0) * kp;
      float* c11 = p_i + ((size_t)tu.j1 * rv + tv.j1) * kp;
      for (int c = 0; c < kp; ++c) {
        const int row = i * kp + c;
        const float gi = to_f(g_p[K + row]);
        const float gp = gi * to_f(fpl_o[(size_t)row * P + p]);
        const float gl = gi * to_f(fli_o[(size_t)row * P + p]);
        add_if(&l_i[tw.j0 * ls + c], tw.w0, gp);
        add_if(&l_i[tw.j1 * ls + c], tw.w1, gp);
        add_if(&c00[c], tu.w0 * tv.w0, gl);
        add_if(&c01[c], tu.w0 * tv.w1, gl);
        add_if(&c10[c], tu.w1 * tv.w0, gl);
        add_if(&c11[c], tu.w1 * tv.w1, gl);
      }
    }
  }

  __syncthreads();
  float* dw_g = dweff + (size_t)o * n_w;
  float* dl_g = dplines + (size_t)o * n_l;
  for (int j = threadIdx.x; j < n_w; j += blockDim.x) {
    const float v = dw_s[(j / K) * ks + j % K];
    if (v != 0.f) atomicAdd(&dw_g[j], v);
  }
  for (int j = threadIdx.x; j < n_l; j += blockDim.x) {
    const float v = dl_s[(j / kp) * ls + j % kp];
    if (v != 0.f) atomicAdd(&dl_g[j], v);
  }
}

// One grid of (blocks per object, O): enough blocks per object that every
// SM holds as many blocks as its shared memory allows, and no more blocks
// than the points need; each block strides over its object's points.
template <typename Kern>
cudaError_t plan(Kern kernel, size_t smem, int O, int P, dim3* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (P + kThreads - 1) / kThreads;
  const int fill = (per_sm * sms + O - 1) / O;
  int bpo = need < fill ? need : fill;
  *grid = dim3(bpo < 1 ? 1 : bpo, O);
  return cudaSuccess;
}

template <typename T>
int launch_fwd(const void* pts, const void* weff, const void* planes,
               const void* plines, void* out, void* afac, void* fpl, void* fli,
               int O, int P, int K, int rf, int rfp, int ru, int rv, int kp,
               int rw, int axes, cudaStream_t stream) {
  const size_t smem = (size_t)3 * rfp * odd_word_stride(K, sizeof(T)) * sizeof(T);
  dim3 grid;
  cudaError_t err = plan(folded_fused_fwd<T>, smem, O, P, &grid);
  if (err != cudaSuccess) return (int)err;
  folded_fused_fwd<T><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)weff, (const T*)planes, (const T*)plines,
      (T*)out, (T*)afac, (T*)fpl, (T*)fli, P, K, rf, rfp, ru, rv, kp, rw, axes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* pts, const void* afac, const void* fpl,
               const void* fli, const void* g, void* dweff, void* dplanes,
               void* dplines, int O, int P, int K, int rf, int rfp, int ru,
               int rv, int kp, int rw, int axes, cudaStream_t stream) {
  const size_t smem = ((size_t)3 * rfp * odd_word_stride(K, 4) +
                       (size_t)3 * rw * odd_word_stride(kp, 4)) * sizeof(float);
  dim3 grid;
  cudaError_t err = plan(folded_fused_bwd<T>, smem, O, P, &grid);
  if (err != cudaSuccess) return (int)err;
  folded_fused_bwd<T><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)afac, (const T*)fpl, (const T*)fli,
      (const T*)g, (float*)dweff, (float*)dplanes, (float*)dplines, P, K, rf,
      rfp, ru, rv, kp, rw, axes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). The launch is asynchronous on
// `stream`; faults during the run surface at the caller's next sync.
int romap_mx_folded_fwd(int dtype, const void* pts, const void* weff,
                        const void* planes, const void* plines, void* out,
                        void* afac, void* fpl, void* fli, int O, int P, int K,
                        int rf, int rfp, int ru, int rv, int kp, int rw,
                        int axes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float>(pts, weff, planes, plines, out, afac, fpl, fli, O,
                             P, K, rf, rfp, ru, rv, kp, rw, axes, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(pts, weff, planes, plines, out, afac, fpl,
                                     fli, O, P, K, rf, rfp, ru, rv, kp, rw,
                                     axes, s);
  return (int)cudaErrorInvalidValue;
}

// dweff, dplanes and dplines must be zero-filled by the caller.
int romap_mx_folded_bwd(int dtype, const void* pts, const void* afac,
                        const void* fpl, const void* fli, const void* g,
                        void* dweff, void* dplanes, void* dplines, int O,
                        int P, int K, int rf, int rfp, int ru, int rv, int kp,
                        int rw, int axes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(pts, afac, fpl, fli, g, dweff, dplanes, dplines,
                             O, P, K, rf, rfp, ru, rv, kp, rw, axes, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(pts, afac, fpl, fli, g, dweff, dplanes,
                                     dplines, O, P, K, rf, rfp, ru, rv, kp, rw,
                                     axes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
