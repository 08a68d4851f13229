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
// the line resolution max(ru, rv) (mxgrid_pallas.py:193, 845). K10 is the
// transpose:
//   dL[l][i][j, c]    += hat_w[j] g[c] f_pl[c]
//   dP[l][i][a, b, c] += hat_u[a] hat_v[b] g[c] f_li[c]
// Taps are tent_taps' (mxgrid_common.cuh): knots outside [0, r-1] are
// dropped, never clamped, and the weights round as the dense tent does.
//
// K9 (`planes_fwd`): one point and plane pair per thread, every level in
// the thread, the object on grid y. What bounded PR 3's design was the table
// reads: a corner or line tap read channel by channel, 72 scalar loads a
// point at the flagship's (128, 64, 4) level (0.055 of its 0.133 ms at
// 10 x 131072 points in bf16, tools/ablate_backward.py on an NVIDIA H100
// 80GB HBM3 at 700 W). Now a corner's or a tap's channels come in one
// vector load (`load_chans`: 8 B at bf16 kp = 4, 16 B at fp32 kp = 4 or
// bf16 kp = 8), 18 a point at the flagship level. Besides the residuals
// f_pl and f_li (rounded to T, rows [O, 3 sum(kp), P]: a warp's 32 points
// store 64 contiguous bytes a row) it writes the plane features
// [O, P, 3 sum(kp)] as T(float(T(f_pl)) * float(T(f_li))): the product the
// reference forms after its kernel in the table dtype (mxgrid_pallas.py:
// 741), so the split step needs no product pass. Now 0.105 ms there (3.1x
// its 0.033 ms of bytes): the table reads, still random 8-byte loads that
// L1 barely reuses, take 0.047 ms of it, the stores 0.025.
//
// K10, variant "tensor_core" (`planes_bwd_tc`: bf16, one level of 128 line
// rows with kp = 4 or 8, the flagship's and `quality`'s). The line
// gradient is dL_i = hat_w^T (g_i f_pl), a [128 x points] x [points x kp]
// product, run as K2's plane part runs it (mxgrid_folded.cu): a block of 12
// warps walks its points in tiles of 64; the points, the f_pl / f_li rows
// and the tile's plane block of the cotangent arrive by cp.async in one of
// two stages; half the threads form the operand g_i f_pl in bf16 (the
// reference rounds it so, mxgrid_pallas.py:240) and t_w = x_w (rw - 1),
// the other half scatter the plane gradient, one 16-byte vector atomic
// (`red4_if`) per corner and four channels: 12 a point at the flagship
// level where PR 3's kernel made 48 scalar ones. Each warp owns one pair
// and 32 line rows, builds its hat_w fragments in registers (max(0, 1 -
// |t - j|), the dense tent's operations, rounded to bf16) and runs
// mma.sync.m16n8k16 with the channels padded to 8. The fp32 sums stay in
// registers over the block's whole point range and are flushed once, one
// global atomicAdd per non-zero entry; no shared-memory float atomic is
// left (on this card those are compare-and-swap loops). The cotangent is
// read in place: `gs` is its row stride, so the split step passes the plane
// block of the encode's full cotangent [O, P, K + 3 sum(kp)] as a view.
// The grid is one wave (`plan`). What bounds it (0.232 ms at 10 x 131072
// points, 6.8x its 0.034 ms of bytes; same card and tool as K9's): the plane
// atomics into L2, 0.10 ms (the plane gradient, 393 KB fp32 an object at the
// flagship level, does not fit a block; PR 3's 48 scalar atomics a point
// took 0.65 of its 0.747 ms), then the per-tile skeleton of loads, operand,
// barriers and flush, 0.079 ms; the products and their hat_w fragments add
// 0.05.
//
// K10, variant "scalar" (fp32, several levels, any other shape): one point
// per thread, the line gradient into shared memory (flushed with one
// atomicAdd per entry), the plane gradient with `red4_if` where kp % 4 == 0
// and scalar atomics otherwise (`plane_pair_bwd`, which K2's and K4's
// scalar kernels share). Atomics make K10's sums order-dependent.
//
// Layouts (per object o, leading axis O on every array; level l):
//   pts    [O, P, 3] f32
//   planes[l] [O, 3, ru_l, rv_l, kp_l] T    plines[l] [O, 3, rw_l, kp_l] T
//   out    [O, P, 3 sum(kp)] T (the plane features)
//   fpl, fli [O, 3 sum(kp), P] T, rows level-major, then pair, then channel
//   g      rows of stride gs >= 3 sum(kp): g[(o P + p) gs + row]
//   dplanes[l], dplines[l] shaped as planes[l], plines[l], f32
// T is float (dtype code 0) or __nv_bfloat16 (dtype code 1).

#include "mxgrid_tc.cuh"

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

// G consecutive channels of a table row as fp32, in one load of G
// sizeof(T) bytes (G = 1: one scalar).
template <typename T, int G>
__device__ __forceinline__ void load_chans(const T* __restrict__ p, float* v) {
  if constexpr (G == 1) {
    v[0] = to_f(__ldg(p));
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(G == 4, "fp32 rows: one 16-byte load of four channels");
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    static_assert(G == 4 || G == 8, "bf16 rows: 8 or 16 bytes");
    uint32_t w[G / 2];
    if constexpr (G == 4) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = a.x; w[1] = a.y;
    } else {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    }
#pragma unroll
    for (int j = 0; j < G / 2; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

// Coordinate `a` (0-2) of a point held in registers (an indexed local
// array would live in local memory).
__device__ __forceinline__ float coord(const float (&x)[3], int a) {
  return a == 0 ? x[0] : (a == 1 ? x[1] : x[2]);
}

// The residual rows (f_pl, f_li at rows `row`..row + G - 1, point p) and
// the plane features of G channels (out_p: the point's first of them; one
// vector store for G > 1: every kp is a multiple of G, so a point's row
// and the G channels lie on a G-element boundary).
template <typename T, int G>
__device__ __forceinline__ void store_rows(T* fpl_o, T* fli_o, T* out_p, size_t row, int P,
                                           int p, const float* pl, const float* li) {
  float f[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const T a = from_f<T>(pl[c]), b = from_f<T>(li[c]);
    fpl_o[(row + c) * P + p] = a;
    fli_o[(row + c) * P + p] = b;
    f[c] = to_f(a) * to_f(b);
  }
  if constexpr (G == 4) {
    store4(out_p, f);
  } else if constexpr (G == 8) {  // bf16: one 16-byte store
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(out_p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    out_p[0] = from_f<T>(f[0]);
  }
}

// Plane pair i of one point at one level, G channels a step (kp % G == 0).
template <typename T, int G>
__device__ __forceinline__ void pair_fwd(const float (&x)[3], int i, int axes, const T* pl_o,
                                         const T* li_o, T* fpl_o, T* fli_o, T* out_p, int P,
                                         int p, int ru, int rv, int kp, int rw) {
  const Taps tu = tent_taps(coord(x, pair_axis(axes, i, 0)), ru);
  const Taps tv = tent_taps(coord(x, pair_axis(axes, i, 1)), rv);
  const Taps tw = tent_taps(coord(x, pair_axis(axes, i, 2)), rw);
  const T* p_i = pl_o + (size_t)i * ru * rv * kp;
  const T* l_i = li_o + (size_t)i * rw * kp;
  const T* c00 = p_i + ((size_t)tu.j0 * rv + tv.j0) * kp;
  const T* c01 = p_i + ((size_t)tu.j0 * rv + tv.j1) * kp;
  const T* c10 = p_i + ((size_t)tu.j1 * rv + tv.j0) * kp;
  const T* c11 = p_i + ((size_t)tu.j1 * rv + tv.j1) * kp;
  const T* l0 = l_i + (size_t)tw.j0 * kp;
  const T* l1 = l_i + (size_t)tw.j1 * kp;
  for (int c0 = 0; c0 < kp; c0 += G) {
    float v00[G], v01[G], v10[G], v11[G], w0[G], w1[G];
    load_chans<T, G>(c00 + c0, v00);
    load_chans<T, G>(c01 + c0, v01);
    load_chans<T, G>(c10 + c0, v10);
    load_chans<T, G>(c11 + c0, v11);
    load_chans<T, G>(l0 + c0, w0);
    load_chans<T, G>(l1 + c0, w1);
    float pl[G], li[G];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      pl[c] = tu.w0 * (tv.w0 * v00[c] + tv.w1 * v01[c]) + tu.w1 * (tv.w0 * v10[c] + tv.w1 * v11[c]);
      li[c] = tw.w0 * w0[c] + tw.w1 * w1[c];
    }
    store_rows<T, G>(fpl_o, fli_o, out_p + i * kp + c0, (size_t)(i * kp + c0), P, p, pl, li);
  }
}

// One (point, plane pair) per thread: a warp takes 32 consecutive points
// of one pair, so its residual rows are stored as 64 contiguous bytes (bf16),
// and the three threads of a point share its coordinates through L1; every
// level in the thread. G: channels a vector load, dividing every level's kp
// (the launcher's choice: 16 bytes where the channels allow it, then 4
// channels, then 1).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) planes_fwd(
    const float* __restrict__ pts, Levels lv, T* __restrict__ out, T* __restrict__ fpl,
    T* __restrict__ fli, int P, int kpl, int axes) {
  const int o = blockIdx.y;
  const int n_items = (P + 31) / 32 * 96;  // 32-point groups x 3 pairs
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_items;
       j += gridDim.x * blockDim.x) {
    const int i = (j >> 5) % 3, p = j / 96 * 32 + (j & 31);
    if (p >= P) continue;
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    int row0 = 0;
    for (int l = 0; l < lv.n; ++l) {
      const int ru = lv.ru[l], rv = lv.rv[l], kp = lv.kp[l], rw = lv.rw[l];
      const T* pl_o = (const T*)lv.planes[l] + (size_t)o * 3 * ru * rv * kp;
      const T* li_o = (const T*)lv.plines[l] + (size_t)o * 3 * rw * kp;
      T* fpl_o = fpl + ((size_t)o * kpl + row0) * P;
      T* fli_o = fli + ((size_t)o * kpl + row0) * P;
      pair_fwd<T, G>(x, i, axes, pl_o, li_o, fpl_o, fli_o, out + op * kpl + row0, P, p, ru, rv,
                     kp, rw);
      row0 += 3 * kp;
    }
  }
}

// ---------------------------------------------------------------------------
// K10, scalar
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int line_floats(const Levels& lv) {
  int n = 0;
  for (int l = 0; l < lv.n; ++l) n += 3 * lv.rw[l] * odd_word_stride(lv.kp[l], 4);
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) planes_bwd(
    const float* __restrict__ pts, const T* __restrict__ fpl,
    const T* __restrict__ fli, const T* __restrict__ g, int gs, Levels lv, int P,
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
    const T* g_p = g + op * gs;
    int row0 = 0, s0 = 0;
    for (int l = 0; l < lv.n; ++l) {
      const int ru = lv.ru[l], rv = lv.rv[l], kp = lv.kp[l], rw = lv.rw[l];
      const int ls = odd_word_stride(kp, 4);
      const T* fpl_o = fpl + ((size_t)o * kpl + row0) * P;
      const T* fli_o = fli + ((size_t)o * kpl + row0) * P;
      float* dp_o = (float*)lv.planes[l] + (size_t)o * 3 * ru * rv * kp;
      for (int i = 0; i < 3; ++i)
        plane_pair_bwd<T>(x, i, axes, g_p + row0 + i * kp, fpl_o, fli_o,
                          dl_s + s0 + i * rw * ls, ls, dp_o + (size_t)i * ru * rv * kp, P, p,
                          ru, rv, kp, rw);
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

// ---------------------------------------------------------------------------
// K10, tensor cores
// ---------------------------------------------------------------------------

constexpr int kPlThreads = 384;  // 12 warps: four a plane pair, 32 line rows each

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 8 : 0;  // 0: nothing is read, 8 zero bytes land
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// Shared-memory bytes of planes_bwd_tc<KP>: two input stages (the tile's
// plane block of g, f_pl then f_li rows, points), then the line operand
// [3 pairs, 8 channels, kRow] and t_w [3, 64].
template <int KP>
struct PlTcSmem {
  static constexpr int kpl = 3 * KP;
  static constexpr int g_bytes = kTile * kpl * 2;
  static constexpr int f_bytes = 2 * kpl * kRow * 2;
  static constexpr int x_bytes = kTile * 3 * 4;
  static constexpr int stage = g_bytes + f_bytes + x_bytes;
  static constexpr int v_bytes = 3 * 8 * kRow * 2;
  static constexpr int t_bytes = 3 * kTile * 4;
  static constexpr int total = 2 * stage + v_bytes + t_bytes;
};

template <int KP>
__global__ void __launch_bounds__(kPlThreads, 2) planes_bwd_tc(
    const float* __restrict__ pts, const bf16* __restrict__ fpl, const bf16* __restrict__ fli,
    const bf16* __restrict__ g, int gs, float* __restrict__ dplanes,
    float* __restrict__ dplines, int P, int ru, int rv, int axes, int vec) {
  using S = PlTcSmem<KP>;
  constexpr int kpl = S::kpl;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* v_s = reinterpret_cast<bf16*>(smem_raw + 2 * S::stage);  // [3, 8, kRow]
  float* tw_s = reinterpret_cast<float*>(smem_raw + 2 * S::stage + S::v_bytes);  // [3, 64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, q = lane & 3;
  const int d = warp >> 2;               // this warp's plane pair
  const int row0 = (warp & 3) * 32;      // its first line row
  const int o = blockIdx.y;
  const float* pts_o = pts + (size_t)o * P * 3;
  const bf16* fpl_o = fpl + (size_t)o * kpl * P;
  const bf16* fli_o = fli + (size_t)o * kpl * P;
  const bf16* g_o = g + (size_t)o * P * gs;

  float lacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if constexpr (KP < 8) {  // channel rows KP-7 of the line operand stay zero
    for (int j = tid; j < 3 * 8 * kRow; j += kPlThreads) v_s[j] = __float2bfloat16(0.f);
  }

  // Raw inputs of one tile into a stage; points past P arrive as zeros
  // (their g is 0: they add nothing to the products, and skip the atomics).
  auto load_tile = [&](int tile, int s) {
    unsigned char* base = smem_raw + s * S::stage;
    bf16* sg = reinterpret_cast<bf16*>(base);
    bf16* sf = reinterpret_cast<bf16*>(base + S::g_bytes);
    float* sx = reinterpret_cast<float*>(base + S::g_bytes + S::f_bytes);
    const int p0 = tile * kTile;
    const int nv = P - p0 < kTile ? P - p0 : kTile;
    if (vec) {  // P % 8 == 0, gs % 4 == 0, aligned bases: 8- and 16-byte chunks
      constexpr int cpp = kpl / 4;  // 8-byte chunks of a point's plane block
      for (int c = tid; c < kTile * cpp; c += kPlThreads) {
        const int pp = c / cpp, j = c - pp * cpp;
        const bool ok = pp < nv;
        cp_async8(sg + pp * kpl + j * 4, g_o + (size_t)(ok ? p0 + pp : 0) * gs + j * 4, ok);
      }
      for (int c = tid; c < 2 * kpl * 8; c += kPlThreads) {
        const int r = c >> 3, cc = (c & 7) * 8;
        const bool ok = cc < nv;
        const bf16* src = r < kpl ? fpl_o + (size_t)r * P : fli_o + (size_t)(r - kpl) * P;
        cp_async16(sf + r * kRow + cc, src + (ok ? p0 + cc : 0), ok);
      }
      const unsigned char* xsrc = reinterpret_cast<const unsigned char*>(pts_o + (size_t)p0 * 3);
      for (int c = tid; c < S::x_bytes / 16; c += kPlThreads) {
        const bool ok = c * 16 < nv * 12;
        cp_async16(reinterpret_cast<unsigned char*>(sx) + c * 16, ok ? xsrc + c * 16 : xsrc, ok);
      }
    } else {  // any P, stride or alignment: element by element
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = tid; e < kTile * kpl; e += kPlThreads) {
        const int pp = e / kpl;
        sg[e] = pp < nv ? g_o[(size_t)(p0 + pp) * gs + e - pp * kpl] : zero;
      }
      for (int e = tid; e < 2 * kpl * kTile; e += kPlThreads) {
        const int r = e >> 6, pp = e & 63;
        const bf16* src = r < kpl ? fpl_o + (size_t)r * P : fli_o + (size_t)(r - kpl) * P;
        sf[r * kRow + pp] = pp < nv ? src[p0 + pp] : zero;
      }
      for (int e = tid; e < kTile * 3; e += kPlThreads)
        sx[e] = e < nv * 3 ? pts_o[(size_t)p0 * 3 + e] : 0.f;
    }
    cp_async_commit();
  };

  const int n_tiles = (P + kTile - 1) / kTile;
  int s = 0;
  if ((int)blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, s ^= 1) {
    if (tile + (int)gridDim.x < n_tiles) load_tile(tile + gridDim.x, s ^ 1);
    else cp_async_commit();  // an empty group keeps the count below uniform
    cp_async_wait<1>();      // this tile's stage has landed
    __syncthreads();         // ... for every thread; the last tile's products are done

    const unsigned char* base = smem_raw + s * S::stage;
    const bf16* sg = reinterpret_cast<const bf16*>(base);
    const bf16* sf = reinterpret_cast<const bf16*>(base + S::g_bytes);
    const float* sx = reinterpret_cast<const float*>(base + S::g_bytes + S::f_bytes);

    // ---- build: threads 0-191 the line operand and t_w, 192-383 the plane
    // scatter, each for one (pair, point) of the tile
    {
      const bool scatter = tid >= 3 * kTile;
      const int i = (scatter ? tid - 3 * kTile : tid) >> 6, pp = tid & 63;
      const float* x = sx + pp * 3;
      float gi[KP];
#pragma unroll
      for (int j = 0; j < KP / 4; ++j) {
        const uint2 raw = *reinterpret_cast<const uint2*>(sg + pp * kpl + i * KP + 4 * j);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        gi[4 * j] = a.x; gi[4 * j + 1] = a.y; gi[4 * j + 2] = b.x; gi[4 * j + 3] = b.y;
      }
      if (!scatter) {
#pragma unroll
        for (int c = 0; c < KP; ++c) {
          const float f_pl = __bfloat162float(sf[(i * KP + c) * kRow + pp]);
          v_s[(i * 8 + c) * kRow + pp] = __float2bfloat16(gi[c] * f_pl);  // dL operand
        }
        tw_s[i * kTile + pp] = __fmul_rn(x[pair_axis(axes, i, 2)], (float)(kTcRw - 1));
      } else if (tile * kTile + pp < P) {
        // dP_i[a, b, :] += hat_u[a] hat_v[b] g_i f_li
        float gl[KP];
#pragma unroll
        for (int c = 0; c < KP; ++c)
          gl[c] = gi[c] * __bfloat162float(sf[(kpl + i * KP + c) * kRow + pp]);
        const Taps tu = tent_taps(x[pair_axis(axes, i, 0)], ru);
        const Taps tv = tent_taps(x[pair_axis(axes, i, 1)], rv);
        float* p_i = dplanes + ((size_t)o * 3 + i) * ru * rv * KP;
#pragma unroll
        for (int c = 0; c < KP; c += 4) {
          red4_if(p_i + ((size_t)tu.j0 * rv + tv.j0) * KP + c, tu.w0 * tv.w0, gl + c);
          red4_if(p_i + ((size_t)tu.j0 * rv + tv.j1) * KP + c, tu.w0 * tv.w1, gl + c);
          red4_if(p_i + ((size_t)tu.j1 * rv + tv.j0) * KP + c, tu.w1 * tv.w0, gl + c);
          red4_if(p_i + ((size_t)tu.j1 * rv + tv.j1) * KP + c, tu.w1 * tv.w1, gl + c);
        }
      }
    }
    __syncthreads();

    // ---- products: dL_d[rows, 0-7] += hat_w[rows, points] (g_d f_pl)[points, 0-7]
#pragma unroll
    for (int k16 = 0; k16 < kTile; k16 += 16) {
      const float2 w_lo = *reinterpret_cast<const float2*>(tw_s + d * kTile + k16 + 2 * q);
      const float2 w_hi = *reinterpret_cast<const float2*>(tw_s + d * kTile + k16 + 8 + 2 * q);
      const bf16* vrow = v_s + (d * 8 + grp) * kRow + k16 + 2 * q;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t al[4];
        hat_fragment((float)(row0 + m * 16 + grp), w_lo, w_hi, al);
        mma16816(lacc[m], al, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // ---- flush: lane holds rows grp, grp + 8 and channels 2q, 2q + 1 of a tile
  float* dl_g = dplines + ((size_t)o * 3 + d) * kTcRw * KP;
  if (2 * q < KP) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = row0 + m * 16 + grp + (c >> 1) * 8;
        const float v = lacc[m][c];
        if (v != 0.f) atomicAdd(dl_g + (size_t)r * KP + 2 * q + (c & 1), v);
      }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T, int G>
int launch_fwd_g(const void* pts, const Levels& lv, void* out, void* fpl, void* fli, int O,
                 int P, int kpl, int axes, cudaStream_t stream) {
  dim3 grid;
  cudaError_t err = plan(planes_fwd<T, G>, 0, O, 3 * P, 1, &grid);  // a thread a pair
  if (err != cudaSuccess) return (int)err;
  planes_fwd<T, G><<<grid, kThreads, 0, stream>>>((const float*)pts, lv, (T*)out, (T*)fpl,
                                                  (T*)fli, P, kpl, axes);
  return (int)cudaGetLastError();
}

// The widest vector every level's channels and the tables' alignment allow.
template <typename T>
int launch_fwd(const void* pts, const Levels& lv, void* out, void* fpl, void* fli, int O,
               int P, int kpl, int axes, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // channels of a 16-byte load
  bool vec = aligned16(out), by_vec = true, by4 = true;
  for (int l = 0; l < lv.n; ++l) {
    vec = vec && aligned16(lv.planes[l]) && aligned16(lv.plines[l]);
    by_vec = by_vec && lv.kp[l] % kVec == 0;
    by4 = by4 && lv.kp[l] % 4 == 0;
  }
  if (vec && by_vec) return launch_fwd_g<T, kVec>(pts, lv, out, fpl, fli, O, P, kpl, axes, stream);
  if (vec && by4) return launch_fwd_g<T, 4>(pts, lv, out, fpl, fli, O, P, kpl, axes, stream);
  return launch_fwd_g<T, 1>(pts, lv, out, fpl, fli, O, P, kpl, axes, stream);
}

template <typename T>
int launch_bwd(const void* pts, const void* fpl, const void* fli, const void* g, int gs,
               const Levels& lv, int O, int P, int kpl, int axes, cudaStream_t stream) {
  const size_t smem = (size_t)line_floats(lv) * sizeof(float);
  dim3 grid;
  cudaError_t err = plan(planes_bwd<T>, smem, O, P, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  planes_bwd<T><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)fpl, (const T*)fli, (const T*)g, gs, lv, P, kpl, axes);
  return (int)cudaGetLastError();
}

template <int KP>
int launch_bwd_tc(const void* pts, const void* fpl, const void* fli, const void* g, int gs,
                  const Levels& lv, int O, int P, int axes, cudaStream_t stream) {
  const size_t smem = PlTcSmem<KP>::total;
  dim3 grid;
  cudaError_t err = plan(planes_bwd_tc<KP>, smem, O, P, 1, &grid, kPlThreads, kTile);
  if (err != cudaSuccess) return (int)err;
  const int vec = P % 8 == 0 && gs % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 8 == 0 &&
                  aligned16(pts) && aligned16(fpl) && aligned16(fli);
  planes_bwd_tc<KP><<<grid, kPlThreads, smem, stream>>>(
      (const float*)pts, (const bf16*)fpl, (const bf16*)fli, (const bf16*)g, gs,
      (float*)lv.planes[0], (float*)lv.plines[0], P, lv.ru[0], lv.rv[0], axes, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = launched); the launch is asynchronous
// on `stream`. The per-level arguments are host arrays of `n_levels`
// entries (at most 4): device pointers, and the levels' (ru, rv, kp).
// `axes` packs the (u, v, w) axis of the three plane pairs, 2 bits each.

// K9: out [O, P, 3 sum(kp)], fpl and fli [O, 3 sum(kp), P].
int romap_mx_planes_fwd(int dtype, const void* pts, int n_levels,
                        void* const* planes, void* const* plines,
                        const int* ru, const int* rv, const int* kp, void* out, void* fpl,
                        void* fli, int O, int P, int axes, void* stream) {
  Levels lv;
  int kpl = 0;
  const int bad = make_levels(n_levels, planes, plines, ru, rv, kp, &lv, &kpl);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(pts, lv, out, fpl, fli, O, P, kpl, axes, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(pts, lv, out, fpl, fli, O, P, kpl, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K10: dplanes[l] and dplines[l] f32 (zero-filled by the caller) from the
// residuals and the plane cotangent g (rows of stride gs, 3 sum(kp) values
// used a row). `variant` is the caller's choice from the spec and dtype
// (mxgrid_cuda.py: `planes_variant`): 0 scalar, 1 tensor cores (bf16, one
// level, rw = 128, kp = 4 or 8); a combination that is not instantiated
// returns cudaErrorInvalidValue.
int romap_mx_planes_bwd(int dtype, int variant, const void* pts, const void* fpl,
                        const void* fli, const void* g, int gs, int n_levels,
                        void* const* dplanes, void* const* dplines,
                        const int* ru, const int* rv, const int* kp, int O,
                        int P, int axes, void* stream) {
  Levels lv;
  int kpl = 0;
  const int bad =
      make_levels(n_levels, dplanes, dplines, ru, rv, kp, &lv, &kpl);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (dtype == 1 && lv.n == 1 && lv.rw[0] == kTcRw && lv.kp[0] == 4)
      return launch_bwd_tc<4>(pts, fpl, fli, g, gs, lv, O, P, axes, s);
    if (dtype == 1 && lv.n == 1 && lv.rw[0] == kTcRw && lv.kp[0] == 8)
      return launch_bwd_tc<8>(pts, fpl, fli, g, gs, lv, O, P, axes, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 0 && dtype == 0)
    return launch_bwd<float>(pts, fpl, fli, g, gs, lv, O, P, kpl, axes, s);
  if (variant == 0 && dtype == 1)
    return launch_bwd<__nv_bfloat16>(pts, fpl, fli, g, gs, lv, O, P, kpl, axes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
