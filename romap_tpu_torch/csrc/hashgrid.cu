// Multiresolution hash-grid encode for sm_90a (instant-ngp / tiny-cuda-nn
// HashGrid semantics): H1 the forward, H2 the table's gradient, H0 the
// points' gradient, H3 the backward of H0 (an SDF field's normal).
//
// No Pallas kernel: the reference runs this layer as an XLA gather and its
// scatter-add transpose (romap_tpu/ops/hashgrid.py:108-174, impl="gather");
// the port's plain twins (ops/hashgrid_cuda.py) repeat that arithmetic in
// PyTorch. These kernels take its place on the card: as plain PyTorch the
// encode was some 400 launches of int64 index arithmetic a call, with the
// rows, weights and corner features written out and read again.
//
// Per (point x, level l) with the level's fp32 scale, resolution res, size
// and row offset:
//   pos = x scale + 0.5 (rounded after the product and after the sum, never
//   fused, as the twin's two kernels round), cell = floor(pos), frac = pos -
//   cell; corner c (bit d set: +1 along axis d) has row
//   (cx + cy res + cz res^2) on a dense level (res^3 <= size), else
//   (cx ^ cy 2654435761 ^ cz 805459861), in uint32 arithmetic (it wraps as
//   the twin's masked int64 does, cells of points outside the cube too),
//   then % size + offset; its weight is prod_d (bit d ? frac_d : 1 - frac_d).
//
// H1: out[l, :] = sum_c w_c table[row_c, :], the blend in fp32 and one
//   rounding to the table's dtype at the store.
// H2: dtable[row_c, :] += w_c g[l, :] into an fp32 buffer the caller zeroed
//   (vector atomics where the toolkit has them for sm_90); the caller casts
//   it once to the table's dtype.
// H0: dx_d = sum_l scale_l sum_c <g[l, :], table[row_c, :]> dw_c / dfrac_d,
//   in fp32, where pose refinement differentiates the points, and the normal
//   n = grad f of NeuS2's SDF field (g = df/dfeatures).
// H3: the backward of H0 from dx's cotangent v: u_c = scale_l sum_d v_d
//   dw_c / dfrac_d, dg[l, :] = sum_c u_c table[row_c, :], dtable[row_c, :]
//   += u_c g[l, :] (H2's fp32 buffer and atomics); no gradient for the
//   points (the encode's second derivative in them).
//
// What bounds it: H1 and H2 gather or scatter 8 corner rows of F values an
// item, 67 M 4-byte rows a call at the benchmark's shape (4 objects x
// 131,072 points x 16 levels, F = 2 in bf16); the tables (3.6 MB an object
// there) stay in the 50 MB L2, so the limit is L2 requests and atomics, not
// the device memory that the counted bytes divide. Design: H1 takes one
// thread an item, items flat over (point, level) within an object
// (blockIdx.y), so a warp's 32 consecutive items write one contiguous run
// of the output, coalesced with no staging. H2 takes a warp a level and 32
// consecutive points, and sums runs of points in one cell before its
// atomics (at `hash_bwd`). The per-level constants sit in shared memory (a
// warp reads up to 32 levels' at once: from the kernel's parameter bank
// those reads would serialise). Nothing but the points is kept for the
// backward: H2 recomputes the rows and weights. H0 takes one thread a point
// over all levels (196,608 points a view in pose refinement, every sample
// of a train step for an SDF field: no atomics, one store a point). H3
// replaces no TPU kernel (the JAX package has no SDF field): it is H2's
// layout and scatter with H1's gathers of the corner rows beside them, a
// warp a level and 32 points, dg stored as H2 reads g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kMaxHashLevels = 32;
constexpr int kHashThreads = 256;
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

struct HashLevels {
  int n;
  float scale[kMaxHashLevels];
  uint32_t res[kMaxHashLevels];
  uint32_t size[kMaxHashLevels];
  uint32_t offset[kMaxHashLevels];
  uint32_t dense;  // bit l: level l is dense
};

struct SharedLevels {
  float scale[kMaxHashLevels];
  uint32_t res[kMaxHashLevels];
  uint32_t size[kMaxHashLevels];
  uint32_t offset[kMaxHashLevels];
  uint32_t dense;
};

__device__ __forceinline__ void load_levels(const HashLevels& lv, SharedLevels& s) {
  const int t = threadIdx.x + threadIdx.y * blockDim.x;
  for (int l = t; l < lv.n; l += blockDim.x * blockDim.y) {
    s.scale[l] = lv.scale[l];
    s.res[l] = lv.res[l];
    s.size[l] = lv.size[l];
    s.offset[l] = lv.offset[l];
  }
  if (t == 0) s.dense = lv.dense;
  __syncthreads();
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One table row (or output / cotangent entry) of F values, loaded and stored
// as one access of F * sizeof(T) bytes (the wrapper checks the alignment).
template <typename T, int F>
struct alignas(sizeof(T) * F) Row {
  T v[F];
};

template <typename T, int F>
__device__ __forceinline__ void load_row(const T* p, float (&out)[F]) {
  const Row<T, F> r = *reinterpret_cast<const Row<T, F>*>(p);
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = to_f(r.v[f]);
}

// The 8 corner rows (offset included) and the per-axis weights of point x
// at level l: cw[d][0] = 1 - frac_d, cw[d][1] = frac_d; c0, the cell.
__device__ __forceinline__ void corners(const float (&x)[3], const SharedLevels& s, int l,
                                        uint32_t (&rows)[8], float (&cw)[3][2],
                                        uint32_t (&c0)[3]) {
  const float scale = s.scale[l];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), 0.5f);  // never an FMA
    const float cell = floorf(pos);
    const float frac = __fsub_rn(pos, cell);
    cw[d][0] = __fsub_rn(1.f, frac);
    cw[d][1] = frac;
    c0[d] = (uint32_t)(long long)cell;  // two's complement: the twin's & 0xFFFFFFFF
  }
  const uint32_t res = s.res[l];
  uint32_t ax[2] = {c0[0], c0[0] + 1u}, ay[2], az[2];
  const bool dense = (s.dense >> l) & 1u;
  if (dense) {
    const uint32_t res2 = res * res;
    ay[0] = c0[1] * res, ay[1] = (c0[1] + 1u) * res;
    az[0] = c0[2] * res2, az[1] = (c0[2] + 1u) * res2;
  } else {
    ay[0] = c0[1] * kPrimeY, ay[1] = (c0[1] + 1u) * kPrimeY;
    az[0] = c0[2] * kPrimeZ, az[1] = (c0[2] + 1u) * kPrimeZ;
  }
  const uint32_t size = s.size[l], offset = s.offset[l];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t bx = c & 1, by = (c >> 1) & 1, bz = c >> 2;
    const uint32_t idx = dense ? ax[bx] + ay[by] + az[bz] : ax[bx] ^ ay[by] ^ az[bz];
    rows[c] = idx % size + offset;
  }
}

// The trilinear weight of corner c, in the twin's order (x * y) * z.
__device__ __forceinline__ float weight(const float (&cw)[3][2], int c) {
  return __fmul_rn(__fmul_rn(cw[0][c & 1], cw[1][(c >> 1) & 1]), cw[2][c >> 2]);
}

// dw_c / dfrac_d of corner c (bits bx, by, bz): the other two axes'
// weights, signed by the corner's bit along d.
__device__ __forceinline__ void weight_slopes(const float (&cw)[3][2], int c, float& sx,
                                              float& sy, float& sz) {
  const int bx = c & 1, by = (c >> 1) & 1, bz = c >> 2;
  const float wx = cw[0][bx], wy = cw[1][by], wz = cw[2][bz];
  sx = bx ? wy * wz : -(wy * wz);
  sy = by ? wx * wz : -(wx * wz);
  sz = bz ? wx * wy : -(wx * wy);
}

// H1: out [O, N, L, F] (T) from points [O, N, 3] f32 and table [O, rows, F].
template <typename T, int F>
__global__ void __launch_bounds__(kHashThreads)
    hash_fwd(const float* __restrict__ pts, const T* __restrict__ table, T* __restrict__ out,
             const HashLevels lv, int N, int n_rows) {
  __shared__ SharedLevels s;
  load_levels(lv, s);
  const int L = lv.n;
  const int i = blockIdx.x * kHashThreads + threadIdx.x;  // item (point, level)
  if (i >= N * L) return;
  const int o = blockIdx.y;
  const int p = i / L, l = i - p * L;
  const float* xp = pts + ((size_t)o * N + p) * 3;
  const float x[3] = {xp[0], xp[1], xp[2]};
  uint32_t rows[8], c0[3];
  float cw[3][2];
  corners(x, s, l, rows, cw, c0);
  const T* tab = table + (size_t)o * n_rows * F;
  float v[8][F];
#pragma unroll
  for (int c = 0; c < 8; ++c) load_row<T, F>(tab + (size_t)rows[c] * F, v[c]);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = weight(cw, c);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = fmaf(w, v[c][f], acc[f]);
  }
  Row<T, F> r;
#pragma unroll
  for (int f = 0; f < F; ++f) r.v[f] = from_f<T>(acc[f]);
  *reinterpret_cast<Row<T, F>*>(out + ((size_t)o * N * L + i) * F) = r;
}

// Whether the toolkit declares the sm_90 vector atomicAdd for V (float2,
// float4): detected, so that an older toolkit builds the scalar adds.
template <typename V, typename = void>
struct HasVectorAtomic : std::false_type {};
template <typename V>
struct HasVectorAtomic<V, decltype((void)atomicAdd((V*)nullptr, V{}))> : std::true_type {};

template <typename V>
__device__ __forceinline__ void add2(float* p, float a, float b) {
  if constexpr (HasVectorAtomic<V>::value) {
    atomicAdd(reinterpret_cast<V*>(p), V{a, b});
  } else {
    atomicAdd(p, a);
    atomicAdd(p + 1, b);
  }
}

template <typename V>
__device__ __forceinline__ void add4(float* p, float a, float b, float c, float d) {
  if constexpr (HasVectorAtomic<V>::value) {
    atomicAdd(reinterpret_cast<V*>(p), V{a, b, c, d});
  } else {
    atomicAdd(p, a);
    atomicAdd(p + 1, b);
    atomicAdd(p + 2, c);
    atomicAdd(p + 3, d);
  }
}

// dst[:F] += v[:F], one vector atomic a row where the toolkit has it
template <int F>
__device__ __forceinline__ void add_row(float* dst, const float (&v)[F]) {
  if constexpr (F == 1) {
    atomicAdd(dst, v[0]);
  } else if constexpr (F == 2) {
    add2<float2>(dst, v[0], v[1]);
  } else {
#pragma unroll
    for (int f = 0; f < F; f += 4) add4<float4>(dst + f, v[f], v[f + 1], v[f + 2], v[f + 3]);
  }
}

// The 8 corners' contributions v [8][F] of one (point, level) item added
// into dt [rows, F] f32 at their rows. Neighbouring points in one cell (a
// run: a ray crosses a coarse cell in consecutive samples) sum their 8 x F
// contributions by a segmented scan over shuffles, and the run's last lane
// adds the sums with one atomic a corner: the coarse levels' rows, which
// every ray hits, take a few atomics a ray and not 32. A warp in which no
// point shares its neighbour's cell adds directly. Every lane of the warp
// calls it, last in its kernel; `rows` are read on live lanes only.
template <int F>
__device__ __forceinline__ void add_corners(float* dt, const uint32_t (&rows)[8],
                                            float (&v)[8][F], const uint32_t (&c0)[3],
                                            bool live, int lane) {
  // every lane shuffles (no short-circuit): a lane missing from a full-mask
  // shuffle hangs the warp
  const int prev_live = __shfl_up_sync(~0u, (int)live, 1);
  const uint32_t prev_x = __shfl_up_sync(~0u, c0[0], 1);
  const uint32_t prev_y = __shfl_up_sync(~0u, c0[1], 1);
  const uint32_t prev_z = __shfl_up_sync(~0u, c0[2], 1);
  const bool start = lane == 0 || prev_live != (int)live || prev_x != c0[0] ||
                     prev_y != c0[1] || prev_z != c0[2];
  const uint32_t starts = __ballot_sync(~0u, start);
  if (starts != ~0u) {  // warp-uniform: some run is longer than one point
    // the first lane of this lane's run
    const int first = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float up = __shfl_up_sync(~0u, v[c][f], d);
          if (lane - d >= first) v[c][f] += up;
        }
      }
    }
    if (lane != 31 && !((starts >> (lane + 1)) & 1u)) return;  // not the run's last lane
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) add_row<F>(dt + (size_t)rows[c] * F, v[c]);
}

// H2: dtable [O, rows, F] f32 (zeroed by the caller) += the corners'
// weights times the cotangent g [O, N, L, F] (T). A block is 32 points x L
// levels, a warp one level of 32 consecutive points (in a train step, one
// ray's samples); `add_corners` sums runs of points in one cell before its
// atomics. (One atomic a corner and item, the first design, took 0.848 ms
// against this one's 0.712 at room4's shape, bf16, H100, zeroing and cast
// included.) F = 8 in fp32 spills (no preset has it).
template <typename T, int F>
__global__ void __launch_bounds__(1024)
    hash_bwd(const float* __restrict__ pts, const T* __restrict__ g, float* __restrict__ dtable,
             const HashLevels lv, int N, int n_rows) {
  __shared__ SharedLevels s;
  load_levels(lv, s);
  const int L = lv.n;
  const int lane = threadIdx.x, l = threadIdx.y;
  const int o = blockIdx.y;
  const int p = blockIdx.x * 32 + lane;
  const bool live = p < N;
  uint32_t rows[8], c0[3] = {0u, 0u, 0u};
  float cw[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}}, gv[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gv[f] = 0.f;
  if (live) {
    const float* xp = pts + ((size_t)o * N + p) * 3;
    const float x[3] = {xp[0], xp[1], xp[2]};
    load_row<T, F>(g + (((size_t)o * N + p) * L + l) * F, gv);
    corners(x, s, l, rows, cw, c0);
  }
  float v[8][F];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = weight(cw, c);
#pragma unroll
    for (int f = 0; f < F; ++f) v[c][f] = w * gv[f];
  }
  add_corners<F>(dtable + (size_t)o * n_rows * F, rows, v, c0, live, lane);
}

// H0: dpts [O, N, 3] f32 from points, table [O, rows, F] and g [O, N, L, F].
template <typename T, int F>
__global__ void __launch_bounds__(kHashThreads)
    hash_points_grad(const float* __restrict__ pts, const T* __restrict__ table,
                     const T* __restrict__ g, float* __restrict__ dpts, const HashLevels lv,
                     int N, int n_rows) {
  __shared__ SharedLevels s;
  load_levels(lv, s);
  const int L = lv.n;
  const int p = blockIdx.x * kHashThreads + threadIdx.x;
  if (p >= N) return;
  const int o = blockIdx.y;
  const float* xp = pts + ((size_t)o * N + p) * 3;
  const float x[3] = {xp[0], xp[1], xp[2]};
  const T* tab = table + (size_t)o * n_rows * F;
  const T* gp = g + ((size_t)o * N + p) * L * F;
  float dx[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < L; ++l) {
    uint32_t rows[8], c0[3];
    float cw[3][2];
    corners(x, s, l, rows, cw, c0);
    float gl[F];
    load_row<T, F>(gp + l * F, gl);
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v[F];
      load_row<T, F>(tab + (size_t)rows[c] * F, v);
      float gv = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) gv = fmaf(gl[f], v[f], gv);
      float dx_c, dy_c, dz_c;
      weight_slopes(cw, c, dx_c, dy_c, dz_c);
      sx = fmaf(gv, dx_c, sx);
      sy = fmaf(gv, dy_c, sy);
      sz = fmaf(gv, dz_c, sz);
    }
    const float scale = s.scale[l];
    dx[0] = fmaf(scale, sx, dx[0]);
    dx[1] = fmaf(scale, sy, dx[1]);
    dx[2] = fmaf(scale, sz, dx[2]);
  }
  float* dp = dpts + ((size_t)o * N + p) * 3;
  dp[0] = dx[0];
  dp[1] = dx[1];
  dp[2] = dx[2];
}

// H3: the backward of H0, from points, table [O, rows, F], H0's cotangent g
// [O, N, L, F] (T) and dx's cotangent v [O, N, 3] f32: dg [O, N, L, F] (T,
// summed in fp32 and rounded once) and dtable [O, rows, F] f32 (zeroed by
// the caller) += u_c g[l, :]. H2's block (32 points x L levels, a warp a
// level) and its `add_corners`; each item also gathers its 8 corner rows,
// as H1 does, for dg.
template <typename T, int F>
__global__ void __launch_bounds__(1024)
    hash_normal_bwd(const float* __restrict__ pts, const T* __restrict__ table,
                    const T* __restrict__ g, const float* __restrict__ vin, T* __restrict__ dg,
                    float* __restrict__ dtable, const HashLevels lv, int N, int n_rows) {
  __shared__ SharedLevels s;
  load_levels(lv, s);
  const int L = lv.n;
  const int lane = threadIdx.x, l = threadIdx.y;
  const int o = blockIdx.y;
  const int p = blockIdx.x * 32 + lane;
  const bool live = p < N;
  uint32_t rows[8], c0[3] = {0u, 0u, 0u};
  float u[8], gl[F];
#pragma unroll
  for (int c = 0; c < 8; ++c) u[c] = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) gl[f] = 0.f;
  if (live) {
    const size_t item = (size_t)o * N + p;
    const float x[3] = {pts[item * 3], pts[item * 3 + 1], pts[item * 3 + 2]};
    const float v0 = vin[item * 3], v1 = vin[item * 3 + 1], v2 = vin[item * 3 + 2];
    load_row<T, F>(g + (item * L + l) * F, gl);
    float cw[3][2];
    corners(x, s, l, rows, cw, c0);
    const T* tab = table + (size_t)o * n_rows * F;
    const float scale = s.scale[l];
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float sx, sy, sz;
      weight_slopes(cw, c, sx, sy, sz);
      u[c] = scale * fmaf(v2, sz, fmaf(v1, sy, v0 * sx));
      float r[F];
      load_row<T, F>(tab + (size_t)rows[c] * F, r);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(u[c], r[f], acc[f]);
    }
    Row<T, F> out;
#pragma unroll
    for (int f = 0; f < F; ++f) out.v[f] = from_f<T>(acc[f]);
    *reinterpret_cast<Row<T, F>*>(dg + (item * L + l) * F) = out;
  }
  float v[8][F];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[c][f] = u[c] * gl[f];
  }
  add_corners<F>(dtable + (size_t)o * n_rows * F, rows, v, c0, live, lane);
}

// The per-level constants from the wrapper's host arrays: `scales` [L] and
// `ints` [4 L] = resolutions, sizes, offsets, dense flags.
int make_levels(const float* scales, const int* ints, int L, HashLevels* lv) {
  if (L < 1 || L > kMaxHashLevels) return (int)cudaErrorInvalidValue;
  lv->n = L;
  lv->dense = 0;
  for (int l = 0; l < L; ++l) {
    if (ints[l] < 1 || ints[L + l] < 1 || ints[2 * L + l] < 0)
      return (int)cudaErrorInvalidValue;
    lv->scale[l] = scales[l];
    lv->res[l] = (uint32_t)ints[l];
    lv->size[l] = (uint32_t)ints[L + l];
    lv->offset[l] = (uint32_t)ints[2 * L + l];
    if (ints[3 * L + l]) lv->dense |= 1u << l;
  }
  return 0;
}

enum class Kind { kForward, kBackward, kPoints, kNormal };

// A launch's arrays: points, then the kind's inputs a, b, c and outputs.
struct Arrays {
  const void* pts;
  const void* a;
  const void* b;
  const void* c;
  void* out;
  void* out2;
};

template <typename T, int F>
int launch(Kind kind, const Arrays& x, const HashLevels& lv, int O, int N, int n_rows,
           cudaStream_t stream) {
  if (O == 0 || N == 0) return 0;
  const long long items = kind == Kind::kPoints ? (long long)N : (long long)N * lv.n;
  if (O > 65535 || items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((items + kHashThreads - 1) / kHashThreads), (unsigned)O);
  // H2 and H3: 32 points x L levels a block
  const dim3 warps((unsigned)((N + 31) / 32), (unsigned)O), levels(32, lv.n);
  const float* pts = (const float*)x.pts;
  if (kind == Kind::kForward)
    hash_fwd<T, F><<<grid, kHashThreads, 0, stream>>>(pts, (const T*)x.a, (T*)x.out, lv, N,
                                                      n_rows);
  else if (kind == Kind::kBackward)
    hash_bwd<T, F><<<warps, levels, 0, stream>>>(pts, (const T*)x.a, (float*)x.out, lv, N,
                                                 n_rows);
  else if (kind == Kind::kPoints)
    hash_points_grad<T, F><<<grid, kHashThreads, 0, stream>>>(
        pts, (const T*)x.a, (const T*)x.b, (float*)x.out, lv, N, n_rows);
  else
    hash_normal_bwd<T, F><<<warps, levels, 0, stream>>>(
        pts, (const T*)x.a, (const T*)x.b, (const float*)x.c, (T*)x.out, (float*)x.out2, lv,
        N, n_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_f(Kind kind, int F, const Arrays& x, const HashLevels& lv, int O, int N,
               int n_rows, cudaStream_t s) {
  switch (F) {
    case 1: return launch<T, 1>(kind, x, lv, O, N, n_rows, s);
    case 2: return launch<T, 2>(kind, x, lv, O, N, n_rows, s);
    case 4: return launch<T, 4>(kind, x, lv, O, N, n_rows, s);
    case 8: return launch<T, 8>(kind, x, lv, O, N, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(Kind kind, int dtype, const Arrays& x, const float* scales, const int* ints,
             int L, int F, int O, int N, int n_rows, void* stream) {
  HashLevels lv;
  const int bad = make_levels(scales, ints, L, &lv);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_f<float>(kind, F, x, lv, O, N, n_rows, s);
  if (dtype == 1) return dispatch_f<__nv_bfloat16>(kind, F, x, lv, O, N, n_rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = launched, or nothing to launch for
// O = 0 or N = 0); the launch is asynchronous on `stream`. dtype 0 is
// float32, 1 bfloat16 (the table's, the output's and the cotangent's);
// F is 1, 2, 4 or 8; `scales` [L] and `ints` [4 L] (resolutions, sizes,
// offsets, dense flags) are host arrays, L <= 32. Points are [O, N, 3] f32;
// the table [O, n_rows, F].

// H1: out [O, N, L F].
int romap_hash_fwd(int dtype, const void* pts, const void* table, void* out,
                   const float* scales, const int* ints, int L, int F, int O, int N,
                   int n_rows, void* stream) {
  return dispatch(Kind::kForward, dtype, Arrays{pts, table, nullptr, nullptr, out, nullptr},
                  scales, ints, L, F, O, N, n_rows, stream);
}

// H2: dtable [O, n_rows, F] f32, zero-filled by the caller; g [O, N, L F].
int romap_hash_bwd(int dtype, const void* pts, const void* g, void* dtable,
                   const float* scales, const int* ints, int L, int F, int O, int N,
                   int n_rows, void* stream) {
  return dispatch(Kind::kBackward, dtype, Arrays{pts, g, nullptr, nullptr, dtable, nullptr},
                  scales, ints, L, F, O, N, n_rows, stream);
}

// H0: dpts [O, N, 3] f32; g [O, N, L F].
int romap_hash_points_grad(int dtype, const void* pts, const void* table, const void* g,
                           void* dpts, const float* scales, const int* ints, int L, int F,
                           int O, int N, int n_rows, void* stream) {
  return dispatch(Kind::kPoints, dtype, Arrays{pts, table, g, nullptr, dpts, nullptr}, scales,
                  ints, L, F, O, N, n_rows, stream);
}

// H3: dg [O, N, L F] (the table's dtype) and dtable [O, n_rows, F] f32,
// zero-filled by the caller; g [O, N, L F], v [O, N, 3] f32.
int romap_hash_normal_bwd(int dtype, const void* pts, const void* table, const void* g,
                          const void* v, void* dg, void* dtable, const float* scales,
                          const int* ints, int L, int F, int O, int N, int n_rows,
                          void* stream) {
  return dispatch(Kind::kNormal, dtype, Arrays{pts, table, g, v, dg, dtable}, scales, ints, L,
                  F, O, N, n_rows, stream);
}

}  // extern "C"
