// Points gradient of the MX-grid encode for sm_90a (K0): d loss / d points
// from the encode's cotangent and its forward's residuals, on every kernel
// path (folded or unsnapped ladder; CP only, the fused paths' one plane
// level, or the split path's plane levels).
//
// No Pallas kernel computes this: the reference's kernel VJP gives the
// points no gradient (romap_tpu/ops/mxgrid_pallas.py:892-895, 916-919), and
// its pose refinement differentiates the points through the XLA encode
// (romap_tpu/ops/mxgrid.py:242, which romap_tpu/models/nerf.py:101-112
// takes on a CPU or a GPU). K0 gives the kernel encode that gradient, so
// that refinement on the card runs the forward kernels and K0.
//
// Per point x, with afac A_d[k] and the plane residuals f_pl, f_li as the
// forward stored them (rounded to T), and the tent slopes of tent_slopes
// (-(r-1) at a kept knot j0, r-1 at a kept j1):
//   dA_d[k]   = sum_l s0_l W_d[off_l + j0_l, k] + s1_l W_d[off_l + j1_l, k]
//   dx_d     += sum_k g[k] A_e[k] A_f[k] dA_d[k]        (e, f: the other axes)
// and for plane pair (u, v, w) of each level, channel c with cotangent g_c:
//   dx_u += g_c f_li[c] sum_ab s_u[a] hat_v[b] P[a, b, c]
//   dx_v += g_c f_li[c] sum_ab hat_u[a] s_v[b] P[a, b, c]
//   dx_w += g_c f_pl[c] sum_j s_w[j] L[j, c]
// The roundings of the forward are taken as the identity (as autograd of
// the plain encode in fp32, where there are none). A folded table W_eff is
// a one-level ladder of rf knots (rows = rfp); an unsnapped one has
// rows = total_res.
//
// What bounds it: the bytes. Per point it reads 12 B, the factors, the
// cotangent and the plane residuals (4K + 3 x 3 sum(kp) values) and writes
// 12 B (936 B in fp32 at the flagship), against 2 x 2L x K + 4K fp32
// operations an axis and ~30 a plane pair and channel (4,392 unsnapped);
// the tables (W: 3 x rows x K, planes: 3 (ru rv + rw) kp an object) stay
// in L1/L2 and are read as the forward reads them. One point a thread, the
// object on grid y; a simple kernel first (refinement runs it on one object
// and 4 x 1536 x 32 points a view and step).
//
// Layouts (leading axis O on every array):
//   pts [O, P, 3] f32; tab [O, 3, rows, K] T; afac [O, 3, K, P] T;
//   planes[l] [O, 3, ru, rv, kp] T; plines[l] [O, 3, rw, kp] T;
//   fpl, fli [O, 3 sum(kp), P] T; g [O, P, K + 3 sum(kp)] T; dpts [O, P, 3] f32.
// T is float (dtype code 0) or __nv_bfloat16 (dtype code 1).

#include "mxgrid_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) points_grad(
    const float* __restrict__ pts, const T* __restrict__ tab, Ladder lad,
    int rows, int K, const T* __restrict__ afac, Levels lv,
    const T* __restrict__ fpl, const T* __restrict__ fli,
    const T* __restrict__ g, float* __restrict__ dpts, int P, int kpl,
    int axes) {
  const int o = blockIdx.y;
  const int kout = K + kpl;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    const T* g_p = g + op * kout;
    float dx[3] = {0.f, 0.f, 0.f};

#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int e = d == 0 ? 1 : 0, f = d == 2 ? 1 : 2;
      int r0[kMaxLevels], r1[kMaxLevels];
      float s0[kMaxLevels], s1[kMaxLevels];
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        r0[l] = r1[l] = 0;
        s0[l] = s1[l] = 0.f;
        if (l < lad.n) {
          const Taps tp = tent_taps(x[d], lad.res[l]);
          const Slopes sl = tent_slopes(x[d], lad.res[l]);
          r0[l] = (lad.off[l] + tp.j0) * K;
          r1[l] = (lad.off[l] + tp.j1) * K;
          s0[l] = sl.s0;
          s1[l] = sl.s1;
        }
      }
      const T* w_d = tab + ((size_t)o * 3 + d) * rows * K;
      const T* a_e = afac + ((size_t)o * 3 + e) * K * P + p;
      const T* a_f = afac + ((size_t)o * 3 + f) * K * P + p;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        float da = 0.f;
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l)
          if (l < lad.n)
            da += s0[l] * to_f(w_d[r0[l] + k]) + s1[l] * to_f(w_d[r1[l] + k]);
        acc += to_f(g_p[k]) * to_f(a_e[(size_t)k * P]) *
               to_f(a_f[(size_t)k * P]) * da;
      }
      dx[d] += acc;
    }

    int row0 = 0;
    for (int l = 0; l < lv.n; ++l) {
      const int ru = lv.ru[l], rv = lv.rv[l], kp = lv.kp[l], rw = lv.rw[l];
      const T* pl_o = (const T*)lv.planes[l] + (size_t)o * 3 * ru * rv * kp;
      const T* li_o = (const T*)lv.plines[l] + (size_t)o * 3 * rw * kp;
      for (int i = 0; i < 3; ++i) {
        const int u = pair_axis(axes, i, 0), v = pair_axis(axes, i, 1),
                  w = pair_axis(axes, i, 2);
        const Taps tu = tent_taps(x[u], ru), tv = tent_taps(x[v], rv),
                   tw = tent_taps(x[w], rw);
        const Slopes su = tent_slopes(x[u], ru), sv = tent_slopes(x[v], rv),
                     sw = tent_slopes(x[w], rw);
        const T* p_i = pl_o + (size_t)i * ru * rv * kp;
        const T* l_i = li_o + (size_t)i * rw * kp;
        const T* c00 = p_i + ((size_t)tu.j0 * rv + tv.j0) * kp;
        const T* c01 = p_i + ((size_t)tu.j0 * rv + tv.j1) * kp;
        const T* c10 = p_i + ((size_t)tu.j1 * rv + tv.j0) * kp;
        const T* c11 = p_i + ((size_t)tu.j1 * rv + tv.j1) * kp;
        float du = 0.f, dv = 0.f, dw = 0.f;
        for (int c = 0; c < kp; ++c) {
          const int row = row0 + i * kp + c;
          const float gi = to_f(g_p[K + row]);
          const float f_pl = to_f(fpl[((size_t)o * kpl + row) * P + p]);
          const float f_li = to_f(fli[((size_t)o * kpl + row) * P + p]);
          const float v00 = to_f(c00[c]), v01 = to_f(c01[c]);
          const float v10 = to_f(c10[c]), v11 = to_f(c11[c]);
          du += gi * f_li *
                (su.s0 * (tv.w0 * v00 + tv.w1 * v01) +
                 su.s1 * (tv.w0 * v10 + tv.w1 * v11));
          dv += gi * f_li *
                (tu.w0 * (sv.s0 * v00 + sv.s1 * v01) +
                 tu.w1 * (sv.s0 * v10 + sv.s1 * v11));
          dw += gi * f_pl *
                (sw.s0 * to_f(l_i[tw.j0 * kp + c]) +
                 sw.s1 * to_f(l_i[tw.j1 * kp + c]));
        }
        // axes as a switch: dx stays in registers
#pragma unroll
        for (int a = 0; a < 3; ++a)
          dx[a] += (a == u ? du : 0.f) + (a == v ? dv : 0.f) + (a == w ? dw : 0.f);
      }
      row0 += 3 * kp;
    }
    dpts[op * 3 + 0] = dx[0];
    dpts[op * 3 + 1] = dx[1];
    dpts[op * 3 + 2] = dx[2];
  }
}

template <typename T>
int launch(const void* pts, const void* tab, const Ladder& lad, int rows,
           const void* afac, const Levels& lv, const void* fpl,
           const void* fli, const void* g, void* dpts, int O, int P, int K,
           int kpl, int axes, cudaStream_t stream) {
  dim3 grid;
  cudaError_t err = plan(points_grad<T>, 0, O, P, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  points_grad<T><<<grid, kThreads, 0, stream>>>(
      (const float*)pts, (const T*)tab, lad, rows, K, (const T*)afac, lv,
      (const T*)fpl, (const T*)fli, (const T*)g, (float*)dpts, P, kpl, axes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K0: dpts [O, P, 3] f32. Returns a cudaError_t code (0 = launched); the
// launch is asynchronous on `stream`. The ladder (`res`, `off`, `n_ladder`
// entries, at most 8) and the plane levels (`n_planes`, 0 to 4: device
// pointers and (ru, rv, kp)) are host arrays; with no plane level, `fpl`,
// `fli` and the plane arrays are not read. `axes` packs the (u, v, w) axis
// of the three plane pairs, 2 bits each.
int romap_mx_points_grad(int dtype, const void* pts, const void* tab,
                         const int* res, const int* off, int n_ladder,
                         int rows, const void* afac, int n_planes,
                         void* const* planes, void* const* plines,
                         const int* ru, const int* rv, const int* kp,
                         const void* fpl, const void* fli, const void* g,
                         void* dpts, int O, int P, int K, int axes,
                         void* stream) {
  Ladder lad;
  int bad = make_ladder(res, off, n_ladder, &lad);
  if (bad) return bad;
  Levels lv{};
  int kpl = 0;
  if (n_planes > 0) {
    bad = make_levels(n_planes, planes, plines, ru, rv, kp, &lv, &kpl);
    if (bad) return bad;
  } else if (n_planes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(pts, tab, lad, rows, afac, lv, fpl, fli, g, dpts, O,
                         P, K, kpl, axes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pts, tab, lad, rows, afac, lv, fpl, fli, g,
                                 dpts, O, P, K, kpl, axes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
