// A1: the optimizer's update for sm_90a, one pass over each parameter leaf.
//
// No Pallas kernel: the reference runs this layer as plain jnp and optax
// (romap_tpu/models/nerf.py: zero_nans -> add_decayed_weights ->
// scale_by_adam, the exponential-decay rate, the EMA and the per-slot
// masked update). The port's plain twin (ops/optimizer_cuda.py,
// `update_plain`) repeats it as eager PyTorch: some 28 elementwise launches
// a leaf, each reading and writing the leaf's full size.
//
// For each element of a leaf of object o, in the twin's order of fp32
// roundings (each operation rounded once: __f*_rn, never contracted into
// an FMA, which nvcc does to a * b + c by default):
//   g0  = isnan(g) ? 0 : g                 found |= isnan(g)
//   g1  = g0 + l2 p
//   mu' = (1 - b1) g1 + b1 mu
//   nu' = (1 - b2) (g1 g1) + b2 nu
//   u   = (mu' / c1[o]) / (sqrt(nu' / c2[o]) + eps)
//   p'  = p - lr[o] u
//   e'  = decay e + (1 - decay) p'
// and where ok[o] is false the old p, mu, nu, e and found, bit for bit. The
// scalars come rounded to fp32 from the host as PyTorch rounds a Python
// number; c1, c2, lr and ok are [O] device vectors.
//
// What bounds it: bytes. An element reads g, p, mu, nu and e and writes p,
// mu, nu and e, all fp32: 36 B for some 20 operations, far below the card's
// 295 operations a byte. Design: one launch for up to kMaxLeaves leaves,
// their pointers and sizes passed by value; a 2D grid, blockIdx.y the
// object (its scalars loaded once a block) and blockIdx.x a tile of
// kTile elements of one leaf's row (the leaf found from the tiles' prefix).
// A thread moves kUnroll 16-byte vectors of each array, all loads issued
// before any arithmetic; a row that does not start on a multiple of 4
// elements takes its first and last few elements as scalars. 64-bit
// offsets. A block ORs its NaN flags (__syncthreads_or); where one is set,
// one atomic marks (leaf, object), and the last block of that row to
// finish (a counter, after a fence) writes found[o]. Inactive rows are
// copied without reading g.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kTile = int64_t(kThreads) * 4 * kUnroll;

struct Leaf {
  const float* g;
  const float* p;
  const float* mu;
  const float* nu;
  const float* e;
  float* p_out;
  float* mu_out;
  float* nu_out;
  float* e_out;
  const bool* found_old;
  bool* found_out;
  int64_t row;  // elements an object
  int tile0;    // the leaf's first tile in blockIdx.x
  int tiles;    // tiles an object, at least 1
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int n;
};

struct Consts {
  float omb1, b1, omb2, b2, l2, eps, decay, omdecay;  // om: one minus
};

struct Scalars {
  float c1, c2, lr;
};

struct State {
  float p, mu, nu, e;
};

__device__ __forceinline__ State step(float g, State s, const Consts& k, const Scalars& o,
                                      int& nan) {
  const bool is_nan = isnan(g);
  nan |= is_nan;
  const float g0 = is_nan ? 0.0f : g;
  const float g1 = __fadd_rn(g0, __fmul_rn(k.l2, s.p));
  State r;
  r.mu = __fadd_rn(__fmul_rn(k.omb1, g1), __fmul_rn(k.b1, s.mu));
  r.nu = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g1, g1)), __fmul_rn(k.b2, s.nu));
  const float u = __fdiv_rn(__fdiv_rn(r.mu, o.c1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(r.nu, o.c2)), k.eps));
  r.p = __fsub_rn(s.p, __fmul_rn(o.lr, u));
  r.e = __fadd_rn(__fmul_rn(k.decay, s.e), __fmul_rn(k.omdecay, r.p));
  return r;
}

// One element i (global, over all objects) as a scalar.
__device__ __forceinline__ void scalar_element(const Leaf& lf, int64_t i, bool active,
                                               const Consts& k, const Scalars& o, int& nan) {
  State s{__ldg(lf.p + i), __ldg(lf.mu + i), __ldg(lf.nu + i), __ldg(lf.e + i)};
  if (active) s = step(__ldg(lf.g + i), s, k, o, nan);
  lf.p_out[i] = s.p;
  lf.mu_out[i] = s.mu;
  lf.nu_out[i] = s.nu;
  lf.e_out[i] = s.e;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int c, float x) {
  if (c == 0) v.x = x;
  else if (c == 1) v.y = x;
  else if (c == 2) v.z = x;
  else v.w = x;
}

__global__ void __launch_bounds__(kThreads)
    adam_ema(const Leaves ls, const Consts k, const float* __restrict__ c1,
             const float* __restrict__ c2, const float* __restrict__ lr,
             const bool* __restrict__ ok, int* flags, unsigned* done, int n_objects) {
  __shared__ Leaf s_leaf;
  __shared__ int s_l;
  if (threadIdx.x == 0) {  // the leaf of this tile, by constant indices only
    int l = 0;
#pragma unroll
    for (int i = 1; i < kMaxLeaves; ++i)
      if (i < ls.n && static_cast<int>(blockIdx.x) >= ls.leaf[i].tile0) l = i;
#pragma unroll
    for (int i = 0; i < kMaxLeaves; ++i)
      if (i == l) s_leaf = ls.leaf[i];
    s_l = l;
  }
  __syncthreads();
  const Leaf lf = s_leaf;
  const int o = blockIdx.y;
  const bool active = ok[o];
  const Scalars sc{c1[o], c2[o], lr[o]};

  const int64_t lo = int64_t(blockIdx.x - lf.tile0) * kTile;
  const int64_t base = int64_t(o) * lf.row;
  const int64_t a = base + lo;
  const int64_t b = base + min(lo + kTile, lf.row);
  const int64_t va = min((a + 3) & ~int64_t(3), b);  // the vector body [va, vb)
  const int64_t vb = max(va, b & ~int64_t(3));
  int nan = 0;
  if (threadIdx.x < va - a) scalar_element(lf, a + threadIdx.x, active, k, sc, nan);
  if (threadIdx.x < b - vb) scalar_element(lf, vb + threadIdx.x, active, k, sc, nan);

  const int64_t v0 = va >> 2, nv = (vb - va) >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(lf.g) + v0;
  const float4* p4 = reinterpret_cast<const float4*>(lf.p) + v0;
  const float4* mu4 = reinterpret_cast<const float4*>(lf.mu) + v0;
  const float4* nu4 = reinterpret_cast<const float4*>(lf.nu) + v0;
  const float4* e4 = reinterpret_cast<const float4*>(lf.e) + v0;
  float4 G[kUnroll], P[kUnroll], M[kUnroll], N[kUnroll], E[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t j = int64_t(u) * kThreads + threadIdx.x;
    if (j < nv) {
      if (active) G[u] = __ldg(g4 + j);
      P[u] = __ldg(p4 + j);
      M[u] = __ldg(mu4 + j);
      N[u] = __ldg(nu4 + j);
      E[u] = __ldg(e4 + j);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t j = int64_t(u) * kThreads + threadIdx.x;
    if (j >= nv) continue;
    if (active) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const State s = step(lane(G[u], c),
                             State{lane(P[u], c), lane(M[u], c), lane(N[u], c), lane(E[u], c)},
                             k, sc, nan);
        set_lane(P[u], c, s.p);
        set_lane(M[u], c, s.mu);
        set_lane(N[u], c, s.nu);
        set_lane(E[u], c, s.e);
      }
    }
    reinterpret_cast<float4*>(lf.p_out)[v0 + j] = P[u];
    reinterpret_cast<float4*>(lf.mu_out)[v0 + j] = M[u];
    reinterpret_cast<float4*>(lf.nu_out)[v0 + j] = N[u];
    reinterpret_cast<float4*>(lf.e_out)[v0 + j] = E[u];
  }

  const int any = __syncthreads_or(nan);
  if (threadIdx.x == 0) {
    const int idx = s_l * n_objects + o;
    if (any) atomicOr(flags + idx, 1);
    __threadfence();  // the flag lands before this block counts as done
    if (atomicAdd(done + idx, 1u) == static_cast<unsigned>(lf.tiles) - 1u)
      lf.found_out[o] = active ? atomicOr(flags + idx, 0) != 0 : lf.found_old[o];
  }
}

}  // namespace

extern "C" {

// A1. Returns a cudaError_t code (0 = launched, or nothing to launch for
// O = 0); the launch is asynchronous on `stream`. dtype must be 0
// (float32). `ptrs` holds 11 device pointers a leaf: g, p, mu, nu, e (each
// [O, row] fp32, 16-byte aligned), p_out, mu_out, nu_out, e_out (the same),
// found_old, found_out ([O] bool); `rows` the leaves' elements an object;
// `consts` 1 - b1, b1, 1 - b2, b2, l2, eps, decay, 1 - decay; c1, c2, lr
// [O] fp32 and ok [O] bool on the device; `scratch` 2 n_leaves O int32,
// zero-filled by the caller. 1 <= n_leaves <= 16.
int romap_adam_ema(int dtype, int n_leaves, void* const* ptrs, const int64_t* rows,
                   const float* consts, const void* c1, const void* c2, const void* lr,
                   const void* ok, void* scratch, int n_objects, void* stream) {
  if (dtype != 0 || n_leaves < 1 || n_leaves > kMaxLeaves || n_objects < 0 ||
      n_objects > 65535)
    return cudaErrorInvalidValue;
  if (n_objects == 0) return cudaSuccess;
  Leaves ls;
  ls.n = n_leaves;
  int64_t tiles = 0;
  for (int l = 0; l < n_leaves; ++l) {
    void* const* q = ptrs + 11 * l;
    Leaf& lf = ls.leaf[l];
    lf.g = static_cast<const float*>(q[0]);
    lf.p = static_cast<const float*>(q[1]);
    lf.mu = static_cast<const float*>(q[2]);
    lf.nu = static_cast<const float*>(q[3]);
    lf.e = static_cast<const float*>(q[4]);
    lf.p_out = static_cast<float*>(q[5]);
    lf.mu_out = static_cast<float*>(q[6]);
    lf.nu_out = static_cast<float*>(q[7]);
    lf.e_out = static_cast<float*>(q[8]);
    lf.found_old = static_cast<const bool*>(q[9]);
    lf.found_out = static_cast<bool*>(q[10]);
    lf.row = rows[l];
    const int64_t t = rows[l] > 0 ? (rows[l] + kTile - 1) / kTile : 1;
    lf.tile0 = static_cast<int>(tiles);
    lf.tiles = static_cast<int>(t);
    tiles += t;
    if (rows[l] < 0 || tiles > 0x7fffffff) return cudaErrorInvalidValue;
  }
  const Consts k{consts[0], consts[1], consts[2], consts[3],
                 consts[4], consts[5], consts[6], consts[7]};
  int* flags = static_cast<int*>(scratch);
  unsigned* done = reinterpret_cast<unsigned*>(flags + n_leaves * n_objects);
  adam_ema<<<dim3(static_cast<unsigned>(tiles), n_objects), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
      ls, k, static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<const float*>(lr), static_cast<const bool*>(ok), flags, done, n_objects);
  return cudaGetLastError();
}

}  // extern "C"
