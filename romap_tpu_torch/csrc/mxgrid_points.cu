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
// in L1/L2 and are read as the forward reads them. Refinement runs it on
// one object and 4 x 1536 x 32 points a view and step, 300 steps a view.
//
// Two designs, the variants of mxgrid_cuda.points_variant:
//
// "lanes_over_channels" (`points_grad_lanes`, every spec with K a multiple
// of 4 whose tiles fit a block: all shipped presets but `quality` in fp32).
// One block of 16 warps an SM walks tiles of 64 points of its object. A
// tile's raw inputs (its cotangent rows, one contiguous run; the 3K factor
// rows and 2 sum(kp) plane residual rows of its 64 points; the points)
// arrive by 16-byte cp.async into one of two stages while the block works
// on the previous tile, so the 0.9 KB a point of DRAM traffic (fp32) is in
// flight without a register held for it. With lanes over points it then
// forms, once a point, u_d[k] = g[k] A_e[k] A_f[k] (three axes from one
// read of the factors), g f_li and g f_pl of each plane channel, and each
// level's two knots as a row and two slopes (`slope_pair`), into shared
// memory. Then 8 lanes take a point (4 points a warp, the tile's 64 in one
// round): lane q holds channels 4q .. 4q + 3 (+ 32 m), reads the two rows
// of three levels at a time as vectors (16 B fp32, 8 B bf16: a point's 8
// lanes read 128 B of a row in one request), their loads in flight
// together, sums their slopes, and dots the sum with u_d; pairs of lanes
// take the plane pairs, each corner's four channels one vector load; a
// butterfly of 3 shuffles sums the 8 lanes' partial dx. The per-point
// design read the cotangent across rows (a warp's load touched 32 rows 240
// B apart, three times, once an axis), each table row once a thread and
// channel, and each plane corner as kp scalar loads. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W at one view's 196,608 points
// (tools/time_points.py): fp32 folded 0.13 ms against 0.33, split 0.29
// against 0.66; the split path's 6-level ladder (268 KB of fp32 rows an
// object) is read from L2.
//
// "per_point" (`points_grad`, the first design, kept for timing it
// against the other and for the specs the other does not take): one point
// a thread, the object on grid y.
//
// Layouts (leading axis O on every array):
//   pts [O, P, 3] f32; tab [O, 3, rows, K] T; afac [O, 3, K, P] T;
//   planes[l] [O, 3, ru, rv, kp] T; plines[l] [O, 3, rw, kp] T;
//   fpl, fli [O, 3 sum(kp), P] T; g [O, P, K + 3 sum(kp)] T; dpts [O, P, 3] f32.
// T is float (dtype code 0) or __nv_bfloat16 (dtype code 1).

#include "mxgrid_tc.cuh"

namespace {

// ---- "per_point": one point a thread -------------------------------------

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

// ---- "lanes_over_channels": 8 lanes a point, lanes over channel quads ----

constexpr int kPtsTile = 64;      // points a tile
constexpr int kPtsThreads = 512;  // 16 warps: a tile's 64 points in one round
constexpr int kPtsLanes = 8;      // lanes a point in the gather: 4 points a warp at once

// n rounded up to a multiple of 4 floats that is an odd number of 16-byte
// words: rows at that stride, read a 16-byte vector a lane, fall into
// distinct banks for the 8 lanes of each phase.
__host__ __device__ __forceinline__ int odd_quad_stride(int n) {
  int q = (n + 3) / 4;
  if (q % 2 == 0) ++q;
  return 4 * q;
}

// Four consecutive channels of a table row in global memory, as fp32: one
// vector load where `vec` (the row 16-byte aligned in fp32, 8 in bf16).
__device__ __forceinline__ void load4g(const float* p, bool vec, float* v) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = __ldg(p + c);
  }
}
__device__ __forceinline__ void load4g(const __nv_bfloat16* p, bool vec, float* v) {
  if (vec) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = to_f(p[c]);
  }
}

// Shared memory of points_grad_lanes: two stages of a tile's raw inputs in
// the residuals' dtype (bytes `stage` each: the cotangent rows as one run,
// the 3K factor rows and 2 sum(kp) plane residual rows of 64 points, the
// points), then, in 4-byte words from `derived`, what phase A forms.
struct LanesSmem {
  int us, ps;
  size_t g_b, a_b, f_b, x_b, stage;   // byte offsets in a stage, its size
  size_t u, pu, pw, row, sa, sb, x, words, total;
  __host__ __device__ LanesSmem(int K, int kpl, int elem, int n_lv) {
    const int kout = K + kpl;
    us = odd_quad_stride(K);  // u_d rows
    ps = kpl | 1;             // plane values: an odd stride
    g_b = 0;
    a_b = g_b + align16((size_t)kPtsTile * kout * elem);
    f_b = a_b + align16((size_t)3 * K * kPtsTile * elem);
    x_b = f_b + align16((size_t)2 * kpl * kPtsTile * elem);
    stage = x_b + (size_t)kPtsTile * 3 * 4;
    const size_t taps = (size_t)3 * n_lv * kPtsTile;
    u = 0;                                // [3, T, us]  u_d = g A_e A_f
    pu = u + (size_t)3 * kPtsTile * us;   // [T, ps]  g f_li
    pw = pu + (size_t)kPtsTile * ps;      // [T, ps]  g f_pl
    row = pw + (size_t)kPtsTile * ps;     // [3 L, T] ints: the tap pair's first row
    sa = row + taps;                      // [3 L, T]  its slope
    sb = sa + taps;                       // [3 L, T]  the next row's slope
    x = sb + taps;                        // [T, 3]
    words = x + (size_t)kPtsTile * 3;
    total = 2 * stage + words * 4;
  }
};

// A level's two knots as rows j, j + 1 (j + 1 = j where the level has one
// knot) and their slopes (tent_slopes: -(r-1) at a kept j0, r-1 at a kept
// j1): d/dx of the level's value is a W[j] + b W[j + 1]. Where only knot
// r - 1 is in reach, j = r - 2 and b carries its slope; where only knot 0,
// j = 0 and a carries it; so both rows stay in the level and no load is
// conditional.
__device__ __forceinline__ void slope_pair(float x, int r, int off, int* row, float* sa,
                                           float* sb) {
  const float t = __fmul_rn(x, (float)(r - 1));  // as tent_slopes
  const float s = (float)(r - 1);
  int j = 0;
  float a = 0.f, b = 0.f;
  if (t > -1.f && t < (float)r && r >= 2) {
    const int i = (int)floorf(t);
    if (i == r - 1) {  // knot r - 1 alone, as j0
      j = r - 2;
      b = -s;
    } else if (i < 0) {  // knot 0 alone, as j1
      a = s;
    } else {
      j = i;
      a = -s;
      b = s;
    }
  }
  *row = off + j;
  *sa = a;
  *sb = b;
}

// Four consecutive values of a staged row as fp32: one vector load where
// `vec` (16 B fp32, 8 B bf16, the address aligned to it).
__device__ __forceinline__ void lds4(const float* p, bool vec, float* v) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = p[c];
  }
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, bool vec, float* v) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = to_f(p[c]);
  }
}

template <typename T, int kLv>
__global__ void __launch_bounds__(kPtsThreads, 1) points_grad_lanes(
    const float* __restrict__ pts, const T* __restrict__ tab, Ladder lad,
    int rows, int K, const T* __restrict__ afac, Levels lv,
    const T* __restrict__ fpl, const T* __restrict__ fli,
    const T* __restrict__ g, float* __restrict__ dpts, int P, int kpl,
    int axes, int vec, int pvec, int avec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kout = K + kpl;
  const int n_lv = kLv == kMaxLevels ? lad.n : kLv;
  const LanesSmem S(K, kpl, sizeof(T), n_lv);
  float* dv = reinterpret_cast<float*>(smem_raw + 2 * S.stage);  // the derived values
  float* u_s = dv + S.u;
  float* pu_s = dv + S.pu;
  float* pw_s = dv + S.pw;
  int* row_s = reinterpret_cast<int*>(dv + S.row);
  float* sa_s = dv + S.sa;
  float* sb_s = dv + S.sb;
  float* x_s = dv + S.x;
  const int o = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5, n_grp = blockDim.x / kPtsTile;
  const T* tab_o = tab + (size_t)o * 3 * rows * K;
  const T* afac_o = afac + (size_t)o * 3 * K * P;
  const T* fpl_o = fpl + (size_t)o * kpl * P;
  const T* fli_o = fli + (size_t)o * kpl * P;
  const float* pts_o = pts + (size_t)o * P * 3;
  const T* g_o = g + (size_t)o * P * kout;
  const int n_tiles = (P + kPtsTile - 1) / kPtsTile;
  const bool g_vec = (kout * sizeof(T)) % (4 * sizeof(T)) == 0;  // a staged cotangent quad

  // A tile's raw inputs into stage s: with avec by 16-byte cp.async (zero
  // past P; P % 8 == 0 and 16-byte aligned bases), else element by element.
  auto load_tile = [&](int tile, int st) {
    unsigned char* base = smem_raw + st * S.stage;
    T* sg = reinterpret_cast<T*>(base + S.g_b);
    T* sa = reinterpret_cast<T*>(base + S.a_b);
    T* sf = reinterpret_cast<T*>(base + S.f_b);
    float* sx = reinterpret_cast<float*>(base + S.x_b);
    const int p0 = tile * kPtsTile;
    const int nv = P - p0 < kPtsTile ? P - p0 : kPtsTile;
    constexpr int kPer = 16 / sizeof(T);  // values a 16-byte chunk
    constexpr int kRowChunks = kPtsTile / kPer;
    if (avec) {
      const int g_chunks = kPtsTile * kout / kPer;
      for (int i = tid; i < g_chunks; i += blockDim.x)
        cp_async16(sg + i * kPer, g_o + (size_t)p0 * kout + i * kPer, i * kPer < nv * kout);
      for (int i = tid; i < (3 * K + 2 * kpl) * kRowChunks; i += blockDim.x) {
        const int r = i / kRowChunks, c = (i - r * kRowChunks) * kPer;
        const T* src = r < 3 * K ? afac_o + (size_t)r * P
                                 : (r < 3 * K + kpl ? fpl_o + (size_t)(r - 3 * K) * P
                                                    : fli_o + (size_t)(r - 3 * K - kpl) * P);
        T* dst = r < 3 * K ? sa + r * kPtsTile : sf + (r - 3 * K) * kPtsTile;
        cp_async16(dst + c, src + p0 + c, c < nv);
      }
      for (int i = tid; i < kPtsTile * 3 / 4; i += blockDim.x)
        cp_async16(sx + 4 * i, pts_o + (size_t)p0 * 3 + 4 * i, 4 * i < nv * 3);
    } else {
      const T zero = from_f<T>(0.f);
      for (int i = tid; i < kPtsTile * kout; i += blockDim.x)
        sg[i] = i < nv * kout ? g_o[(size_t)p0 * kout + i] : zero;
      for (int i = tid; i < (3 * K + 2 * kpl) * kPtsTile; i += blockDim.x) {
        const int r = i / kPtsTile, c = i - r * kPtsTile;
        const T* src = r < 3 * K ? afac_o + (size_t)r * P
                                 : (r < 3 * K + kpl ? fpl_o + (size_t)(r - 3 * K) * P
                                                    : fli_o + (size_t)(r - 3 * K - kpl) * P);
        T* dst = r < 3 * K ? sa + r * kPtsTile : sf + (r - 3 * K) * kPtsTile;
        dst[c] = c < nv ? src[p0 + c] : zero;
      }
      for (int i = tid; i < kPtsTile * 3; i += blockDim.x)
        sx[i] = i < nv * 3 ? pts_o[(size_t)p0 * 3 + i] : 0.f;
    }
    cp_async_commit();
  };

  int s = 0;
  if ((int)blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, s ^= 1) {
    if (tile + (int)gridDim.x < n_tiles) load_tile(tile + gridDim.x, s ^ 1);
    else cp_async_commit();  // an empty group keeps the count below uniform
    cp_async_wait<1>();      // this tile's stage has landed
    __syncthreads();         // ... for every thread; the last tile's gathers are done
    const int p0 = tile * kPtsTile;
    const int nv = P - p0 < kPtsTile ? P - p0 : kPtsTile;
    const unsigned char* base = smem_raw + s * S.stage;
    const T* sg = reinterpret_cast<const T*>(base + S.g_b);
    const T* sa = reinterpret_cast<const T*>(base + S.a_b);
    const T* sf = reinterpret_cast<const T*>(base + S.f_b);
    const float* sx = reinterpret_cast<const float*>(base + S.x_b);

    // ---- lanes over points: u_d, the plane values and the taps, once a point
    const int pp = tid % kPtsTile, grp = tid / kPtsTile;
    if (pp < nv) {
      for (int c = 4 * grp; c < K; c += 4 * n_grp) {
        float a[3][4];
#pragma unroll
        for (int d = 0; d < 3; ++d)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[d][j] = to_f(sa[(d * K + c + j) * kPtsTile + pp]);
        float gq[4];
        lds4(sg + pp * kout + c, g_vec, gq);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int e = d == 0 ? 1 : 0, f = d == 2 ? 1 : 2;
          float u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) u[j] = gq[j] * a[e][j] * a[f][j];
          *reinterpret_cast<float4*>(u_s + ((size_t)d * kPtsTile + pp) * S.us + c) =
              make_float4(u[0], u[1], u[2], u[3]);
        }
      }
      for (int r = grp; r < kpl; r += n_grp) {
        const float gi = to_f(sg[pp * kout + K + r]);
        pw_s[pp * S.ps + r] = gi * to_f(sf[r * kPtsTile + pp]);          // g f_pl
        pu_s[pp * S.ps + r] = gi * to_f(sf[(kpl + r) * kPtsTile + pp]);  // g f_li
      }
      for (int j = grp; j < 3 * n_lv; j += n_grp) {
        const int d = j / n_lv, l = j - d * n_lv, at = (d * n_lv + l) * kPtsTile + pp;
        slope_pair(sx[pp * 3 + d], lad.res[l], lad.off[l], row_s + at, sa_s + at, sb_s + at);
      }
      if (grp == 0)
        for (int d = 0; d < 3; ++d) x_s[pp * 3 + d] = sx[pp * 3 + d];
    }
    __syncthreads();

    // ---- 8 lanes a point, 4 points a warp at once: lane q of a point holds
    // channels 4q + 32 m and sums the slopes of every level's two rows
    const int sl = lane % kPtsLanes, lg = lane / kPtsLanes;
    for (int base = warp * (32 / kPtsLanes); base < nv; base += n_warps * (32 / kPtsLanes)) {
      const int pp2 = base + lg;
      const bool valid = pp2 < nv;
      float part[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T* w_d = tab_o + (size_t)d * rows * K;
        const float* u_p = u_s + ((size_t)d * kPtsTile + pp2) * S.us;
        for (int c = 4 * sl; valid && c < K; c += 4 * kPtsLanes) {
          // the rows of kB levels at a time (their loads in flight together),
          // then their sums, level after level
          constexpr int kB = kLv < 3 ? kLv : 3;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int l0 = 0; l0 < kLv; l0 += kB) {
            float v0[kB][4], v1[kB][4], sa[kB], sb[kB];
#pragma unroll
            for (int b = 0; b < kB; ++b) {
              const int l = l0 + b;
              sa[b] = sb[b] = 0.f;
              if (l < kLv && (kLv != kMaxLevels || l < lad.n)) {
                const int at = (d * n_lv + l) * kPtsTile + pp2;
                const int row = row_s[at];
                sa[b] = sa_s[at];
                sb[b] = sb_s[at];
                load4g(w_d + (size_t)row * K + c, vec, v0[b]);
                load4g(w_d + (size_t)(row + (lad.res[l] >= 2)) * K + c, vec, v1[b]);
              }
            }
#pragma unroll
            for (int b = 0; b < kB; ++b)
              if (l0 + b < kLv && (kLv != kMaxLevels || l0 + b < lad.n))
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[k] += sa[b] * v0[b][k] + sb[b] * v1[b][k];
          }
          const float4 u4 = *reinterpret_cast<const float4*>(u_p + c);
          part[d] += acc[0] * u4.x;
          part[d] += acc[1] * u4.y;
          part[d] += acc[2] * u4.z;
          part[d] += acc[3] * u4.w;
        }
      }

      // plane pairs: lane (i, quad) = (sl / 2, sl % 2), four channels a corner
      const float* x = x_s + pp2 * 3;  // read at the pair's axes, no local copy
      const int i = sl / 2, cq = 4 * (sl % 2);
      int row0 = 0;
      for (int lvl = 0; valid && lvl < lv.n; ++lvl) {
        const int ru = lv.ru[lvl], rv = lv.rv[lvl], kp = lv.kp[lvl], rw = lv.rw[lvl];
        if (i < 3 && cq < kp) {
          const int u = pair_axis(axes, i, 0), v = pair_axis(axes, i, 1),
                    w = pair_axis(axes, i, 2);
          const Taps tu = tent_taps(x[u], ru), tv = tent_taps(x[v], rv),
                     tw = tent_taps(x[w], rw);
          const Slopes su = tent_slopes(x[u], ru), sv = tent_slopes(x[v], rv),
                       sw = tent_slopes(x[w], rw);
          const T* p_i = (const T*)lv.planes[lvl] + ((size_t)o * 3 + i) * ru * rv * kp;
          const T* l_i = (const T*)lv.plines[lvl] + ((size_t)o * 3 + i) * rw * kp;
          const float* pu_p = pu_s + pp2 * S.ps + row0 + i * kp;
          const float* pw_p = pw_s + pp2 * S.ps + row0 + i * kp;
          float du = 0.f, dv = 0.f, dw = 0.f;
          for (int c = cq; c < kp; c += 8) {
            float v00[4], v01[4], v10[4], v11[4], l0[4], l1[4];
            const bool full = pvec && c + 4 <= kp;
            if (full) {
              load4g(p_i + ((size_t)tu.j0 * rv + tv.j0) * kp + c, true, v00);
              load4g(p_i + ((size_t)tu.j0 * rv + tv.j1) * kp + c, true, v01);
              load4g(p_i + ((size_t)tu.j1 * rv + tv.j0) * kp + c, true, v10);
              load4g(p_i + ((size_t)tu.j1 * rv + tv.j1) * kp + c, true, v11);
              load4g(l_i + (size_t)tw.j0 * kp + c, true, l0);
              load4g(l_i + (size_t)tw.j1 * kp + c, true, l1);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int ck = c + k < kp ? c + k : c;  // a channel past kp adds 0 below
                v00[k] = to_f(p_i[((size_t)tu.j0 * rv + tv.j0) * kp + ck]);
                v01[k] = to_f(p_i[((size_t)tu.j0 * rv + tv.j1) * kp + ck]);
                v10[k] = to_f(p_i[((size_t)tu.j1 * rv + tv.j0) * kp + ck]);
                v11[k] = to_f(p_i[((size_t)tu.j1 * rv + tv.j1) * kp + ck]);
                l0[k] = to_f(l_i[(size_t)tw.j0 * kp + ck]);
                l1[k] = to_f(l_i[(size_t)tw.j1 * kp + ck]);
              }
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (c + k < kp) {
                const float gl = pu_p[c + k], gp = pw_p[c + k];
                du += gl * (su.s0 * (tv.w0 * v00[k] + tv.w1 * v01[k]) +
                            su.s1 * (tv.w0 * v10[k] + tv.w1 * v11[k]));
                dv += gl * (tu.w0 * (sv.s0 * v00[k] + sv.s1 * v01[k]) +
                            tu.w1 * (sv.s0 * v10[k] + sv.s1 * v11[k]));
                dw += gp * (sw.s0 * l0[k] + sw.s1 * l1[k]);
              }
            }
          }
#pragma unroll
          for (int a = 0; a < 3; ++a)
            part[a] += (a == u ? du : 0.f) + (a == v ? dv : 0.f) + (a == w ? dw : 0.f);
        }
        row0 += 3 * kp;
      }

      // the 8 lanes' partial sums, a butterfly of shuffles within the point's lanes
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int m = kPtsLanes / 2; m >= 1; m >>= 1)
          part[a] += __shfl_xor_sync(0xffffffffu, part[a], m);
      if (sl == 0 && valid) {
        float* dst = dpts + ((size_t)o * P + p0 + pp2) * 3;
        dst[0] = part[0];
        dst[1] = part[1];
        dst[2] = part[2];
      }
    }
  }
  cp_async_wait<0>();
}

bool aligned_to(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T, int kLv>
int launch_lanes(const void* pts, const void* tab, const Ladder& lad, int rows,
                 const void* afac, const Levels& lv, const void* fpl, const void* fli,
                 const void* g, void* dpts, int O, int P, int K, int kpl, int axes,
                 cudaStream_t stream) {
  if (K % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t vbytes = 4 * sizeof(T);  // a vector of four channels
  const int vec = aligned_to(tab, vbytes) && (K * sizeof(T)) % vbytes == 0;
  int pvec = 1;
  for (int l = 0; l < lv.n; ++l)
    pvec &= lv.kp[l] % 4 == 0 && aligned_to(lv.planes[l], vbytes) &&
            aligned_to(lv.plines[l], vbytes);
  const size_t smem = LanesSmem(K, kpl, sizeof(T), lad.n).total;
  const int avec = P % 8 == 0 && aligned16(pts) && aligned16(afac) && aligned16(g) &&
                   (kpl == 0 || (aligned16(fpl) && aligned16(fli)));
  dim3 grid;
  cudaError_t err = plan(points_grad_lanes<T, kLv>, smem, O, P, 1, &grid, kPtsThreads, kPtsTile);
  if (err != cudaSuccess) return (int)err;
  points_grad_lanes<T, kLv><<<grid, kPtsThreads, smem, stream>>>(
      (const float*)pts, (const T*)tab, lad, rows, K, (const T*)afac, lv,
      (const T*)fpl, (const T*)fli, (const T*)g, (float*)dpts, P, kpl, axes, vec, pvec, avec);
  return (int)cudaGetLastError();
}

// variant 0: "per_point", 1: "lanes_over_channels"; kLv is the ladder's
// level count where it is 1 (a folded table) or 6 (the shipped unsnapped
// ladders), else kMaxLevels with a guard
template <typename T>
int launch(int variant, const void* pts, const void* tab, const Ladder& lad, int rows,
           const void* afac, const Levels& lv, const void* fpl,
           const void* fli, const void* g, void* dpts, int O, int P, int K,
           int kpl, int axes, cudaStream_t stream) {
#define ROMAP_ARGS pts, tab, lad, rows, afac, lv, fpl, fli, g, dpts, O, P, K, kpl, axes, stream
  if (variant == 1 && lad.n == 1) return launch_lanes<T, 1>(ROMAP_ARGS);
  if (variant == 1 && lad.n == 6) return launch_lanes<T, 6>(ROMAP_ARGS);
  if (variant == 1) return launch_lanes<T, kMaxLevels>(ROMAP_ARGS);
#undef ROMAP_ARGS
  if (variant != 0) return (int)cudaErrorInvalidValue;
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

// K0: dpts [O, P, 3] f32. `variant` is the caller's choice
// (mxgrid_cuda.points_variant): 0 per_point, 1 lanes_over_channels (K a
// multiple of 4). Returns a cudaError_t code (0 = launched); the
// launch is asynchronous on `stream`. The ladder (`res`, `off`, `n_ladder`
// entries, at most 8) and the plane levels (`n_planes`, 0 to 4: device
// pointers and (ru, rv, kp)) are host arrays; with no plane level, `fpl`,
// `fli` and the plane arrays are not read. `axes` packs the (u, v, w) axis
// of the three plane pairs, 2 bits each.
int romap_mx_points_grad(int dtype, int variant, const void* pts, const void* tab,
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
    return launch<float>(variant, pts, tab, lad, rows, afac, lv, fpl, fli, g, dpts, O,
                         P, K, kpl, axes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(variant, pts, tab, lad, rows, afac, lv, fpl, fli, g,
                                 dpts, O, P, K, kpl, axes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
