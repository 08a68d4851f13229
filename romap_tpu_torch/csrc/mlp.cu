// The last product of each network for sm_90a: M1 the forward, M2 both
// gradients in one pass over the points (and M2's fixed-order sum of the
// weight gradient's block partials).
//
// No Pallas kernel: the reference leaves this einsum to XLA
// (romap_tpu/ops/mlp.py:45, preferred_element_type=jnp.float32), and the
// port's plain twin (ops/mlp_cuda.py) is torch.bmm(h.float(), w.float())
// with autograd's backward. These kernels take its place on the card because
// cuBLAS runs the twin's fp32 weight gradient, a 131,072-long reduction into
// a 64 x N output an object, on about 20 blocks of a 32 x 32 tile (4.2 ms at
// 10 objects, whatever N), and the twin writes an fp32 copy of h and an fp32
// dh around it.
//
// For each object o, point p, input k < K and output n < N:
//   M1: out[p, n] = sum_k h[p, k] w[k, n]                      fp32 out
//   M2: dh[p, k]  = sum_n dy[p, n] w[k, n], rounded once to h's dtype
//       dw[k, n]  = sum_p h[p, k] dy[p, n], rounded once to w's dtype
// h and w are fp32 or bf16 (one dtype), dy fp32; every product and sum is
// an fp32 FMA on the CUDA cores (no TF32, no bf16 split of dy), as the twin
// computes in fp32. Only the order of the fp32 sums differs from the twin's.
//
// What bounds them: bytes. At K = 64 and N = 16, M2 does 4 K N operations a
// point over 2 K (bf16 h) + 4 N (dy) + 2 K (dh) = 320 bytes, 13 a byte,
// under the card's fp32 ridge of about 20 (67 TFLOP/s over 3.35 TB/s); M1
// and smaller N are further below it. Design: both stream h (and dy) once
// through a ring of kStages shared-memory tiles of kTileP points, filled
// with cp.async (16-byte copies of h, 4-byte copies of dy), so that the
// bytes in flight do not depend on registers; a block takes a fixed run of
// tiles of one object (blockIdx.y), so every block's work, and with it the
// order of every sum, follows from the shapes alone.
//   M1: G lanes a point, lane c holding the fp32 weights of its KC inputs
//   [KC c, KC c + KC) in registers (staged through shared memory once a
//   block); each lane sums its KC products for all N outputs, then a
//   butterfly that halves the vector at each step (reduce-scatter, N/2 +
//   N/4 + ... shuffles) leaves each lane the sums of N/G outputs to store.
//   M2: K/2 threads a point, thread j holding w[2j..2j+1, :] and the
//   weight gradient's partial sums of those two rows in registers; it
//   writes its two values of dh (one rounding) and adds h dy to its
//   partials. At the end a block sums its threads' partials in shared
//   memory in thread order and writes them to a [O, B, K, N] fp32 buffer;
//   M2's second launch sums the B blocks of each object in block order and
//   rounds once. No float atomics: two runs give the same bits.
// Needed outputs only: M2 skips dw when w needs no gradient (pose
// refinement) and dh when h needs none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

namespace {

// Tiles of 64 points, 3 in the ring, and blocks of 2048 (M1) and 1024 (M2)
// points: on an H100 at 10 x 131,072 points these took M1 from 0.249 to
// 0.168 ms and M2 from 0.353 to 0.291 ms (out = 16, bf16) against tiles of
// 32, a ring of 4 and M1 blocks of 256 points; tiles of 128 were slower in
// fp32, 128-thread M2 blocks no better over the three widths.
constexpr int kStages = 3;       // tiles in the ring of a block
constexpr int kTileP = 64;       // points a tile
constexpr int kFwdThreads = 128;
constexpr int kFwdTiles = 32;    // tiles a block in M1: 2048 points
constexpr int kBwdThreads = 256;
constexpr int kBwdTiles = 16;    // tiles a block in M2: 1024 points (mlp_cuda.BLOCK_POINTS)
constexpr int kSumThreads = 256;
constexpr int kMaxIn = 128;
constexpr int kMaxOut = 32;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies tile t (points [t kTileP, t kTileP + kTileP) of one object), where
// `h` is given, of h into `dst` [kTileP][K], and where `dy` is given, of dy
// into `dy_dst` [kTileP][NP] (columns n < N only); points past P are
// zero-filled. Commits one group either way.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* h, float* dy_dst, const float* dy,
                                          int64_t t, int64_t P, int K, int N, int NP,
                                          int valid_tile) {
  const int64_t p0 = t * kTileP;
  if (valid_tile && h != nullptr) {
    const int row_chunks = K * static_cast<int>(sizeof(T)) / 16;
    for (int c = threadIdx.x; c < kTileP * row_chunks; c += blockDim.x) {
      const int q = c / row_chunks;
      const bool in = p0 + q < P;
      const T* src = in ? h + (p0 + q) * K + (c - q * row_chunks) * (16 / sizeof(T)) : h;
      cp_async16(reinterpret_cast<char*>(dst) + 16 * c, src, in);
    }
  }
  if (valid_tile && dy != nullptr) {
    for (int c = threadIdx.x; c < kTileP * N; c += blockDim.x) {
      const int q = c / N;
      const bool in = p0 + q < P;
      cp_async4(dy_dst + q * NP + (c - q * N), in ? dy + p0 * N + c : dy, in);
    }
  }
  cp_async_commit();
}

// KC consecutive values of a tile row, as fp32.
template <int KC>
__device__ __forceinline__ void read_row(const float* src, float* v) {
#pragma unroll
  for (int i = 0; i < KC; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    v[i] = x.x;
    v[i + 1] = x.y;
    v[i + 2] = x.z;
    v[i + 3] = x.w;
  }
}

template <int KC>
__device__ __forceinline__ void read_row(const __nv_bfloat16* src, float* v) {
  uint32_t u[KC / 2];
  if constexpr (KC == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    u[0] = x.x, u[1] = x.y, u[2] = x.z, u[3] = x.w;
  } else {
    static_assert(KC == 4, "bf16 rows are read 8 or 16 bytes at a time");
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    u[0] = x.x, u[1] = x.y;
  }
#pragma unroll
  for (int i = 0; i < KC / 2; ++i) {  // bf16 -> fp32 is exact: the high 16 bits
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Sums the vectors v[0..W) of the lanes of an aligned group over the lane
// masks M, M/2, ..., 1: while W > 1 each step sends half the vector to the
// partner and keeps the other half (the lane with bit M set the upper one);
// afterwards the lane holds max(W / 2M, 1) sums, those of outputs `base`
// on. A step at W = 1 sums the one value whole (both lanes then hold it).
template <int W, int M>
__device__ __forceinline__ void reduce_scatter(float* v, int& base) {
  if constexpr (M > 0) {
    if constexpr (W > 1) {
      const bool up = threadIdx.x & M;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const float send = up ? v[i] : v[i + W / 2];
        const float keep = up ? v[i + W / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (up) base += W / 2;
      reduce_scatter<W / 2, M / 2>(v, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      reduce_scatter<1, M / 2>(v, base);
    }
  }
}

// M1. Grid (blocks an object, O); kFwdThreads threads, G lanes a point
// (lane c: inputs [KC c, KC c + KC), none where KC c >= K), kFwdThreads / G
// points at a time. Dynamic shared memory: w as fp32 [K][NP], then the ring.
template <typename T, int NP, int G, int KC>
__global__ void __launch_bounds__(kFwdThreads)
    last_fwd(const T* __restrict__ h, const T* __restrict__ w, float* __restrict__ out,
             int64_t P, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + K * NP * sizeof(float));
  const int o = blockIdx.y;
  const T* ho = h + static_cast<int64_t>(o) * P * K;
  const int64_t n_tiles = (P + kTileP - 1) / kTileP;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kFwdTiles;
  const int nt = static_cast<int>(min(static_cast<int64_t>(kFwdTiles), n_tiles - t0));
  const int tile_elems = kTileP * K;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    load_tile<T>(ring + i * tile_elems, ho, nullptr, nullptr, t0 + i, P, K, N, NP, i < nt);
  const T* wo = w + static_cast<int64_t>(o) * K * N;
  for (int i = threadIdx.x; i < K * NP; i += blockDim.x) {
    const int k = i / NP, n = i - k * NP;
    ws[i] = n < N ? to_f(wo[k * N + n]) : 0.0f;
  }
  __syncthreads();

  const int c = threadIdx.x % G;
  const bool has_inputs = KC * c < K;
  float wr[KC][NP];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
#pragma unroll
    for (int n = 0; n < NP; n += 4) {
      const float4 x = has_inputs ? *reinterpret_cast<const float4*>(ws + (KC * c + kk) * NP + n)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      wr[kk][n] = x.x, wr[kk][n + 1] = x.y, wr[kk][n + 2] = x.z, wr[kk][n + 3] = x.w;
    }
  constexpr int kSlots = kFwdThreads / G;
  constexpr int kOwn = NP / G > 0 ? NP / G : 1;  // sums a lane holds
  constexpr int kDup = G / NP > 0 ? G / NP : 1;  // lanes that hold the same sums
  const bool writer = (threadIdx.x % kDup) == 0;
  float* oo = out + static_cast<int64_t>(o) * P * N;

  for (int i = 0; i < nt; ++i) {
    load_tile<T>(ring + ((i + kStages - 1) % kStages) * tile_elems, ho, nullptr, nullptr,
                 t0 + i + kStages - 1, P, K, N, NP, i + kStages - 1 < nt);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* tile = ring + (i % kStages) * tile_elems;
    const int64_t p0 = (t0 + i) * kTileP;
    for (int q = threadIdx.x / G; q < kTileP; q += kSlots) {  // as many for every lane
      float acc[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) acc[n] = 0.0f;
      if (has_inputs) {
        float hv[KC];
        read_row<KC>(tile + q * K + KC * c, hv);
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
#pragma unroll
          for (int n = 0; n < NP; ++n) acc[n] = fmaf(hv[kk], wr[kk][n], acc[n]);
      }
      int base = 0;
      reduce_scatter<NP, G / 2>(acc, base);
      if (writer && p0 + q < P) {
#pragma unroll
        for (int n = 0; n < kOwn; ++n)
          if (base + n < N) oo[(p0 + q) * N + base + n] = acc[n];
      }
    }
    __syncthreads();
  }
}

// M2. Grid (B blocks an object, O); kBwdThreads threads as (K/2 threads a
// point) x slots. Dynamic shared memory: the ring of (h tile [kTileP][K],
// dy tile [kTileP][NP] fp32), or the partials' staging after the last tile,
// whichever is larger.
template <typename T, int NP>
__global__ void __launch_bounds__(kBwdThreads)
    last_bwd(const T* __restrict__ h, const T* __restrict__ w, const float* __restrict__ dy,
             T* __restrict__ dh, float* __restrict__ partials, int64_t P, int K, int N,
             int need_dh, int need_dw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int64_t n_tiles = (P + kTileP - 1) / kTileP;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kBwdTiles;
  const int nt = static_cast<int>(min(static_cast<int64_t>(kBwdTiles), n_tiles - t0));
  const int h_bytes = kTileP * K * static_cast<int>(sizeof(T));
  const int stage_bytes = h_bytes + kTileP * NP * static_cast<int>(sizeof(float));
  auto h_tile = [&](int s) { return reinterpret_cast<T*>(smem + s * stage_bytes); };
  auto dy_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * stage_bytes + h_bytes); };
  const T* ho = need_dw ? h + static_cast<int64_t>(o) * P * K : nullptr;  // dh needs no h
  const float* dyo = dy + static_cast<int64_t>(o) * P * N;

  for (int i = threadIdx.x; i < kStages * kTileP * NP; i += blockDim.x) {
    const int s = i / (kTileP * NP), e = i - s * kTileP * NP;
    dy_tile(s)[e] = 0.0f;  // columns N..NP stay zero; cp.async fills the rest
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    load_tile<T>(h_tile(i), ho, dy_tile(i), dyo, t0 + i, P, K, N, NP, i < nt);

  const int g = K / 2;                  // threads a point
  const int slots = kBwdThreads / g;
  const int j = threadIdx.x % g, slot = threadIdx.x / g;
  const bool active = slot < slots;
  float wr[2][NP], acc[2][NP];
  const T* wo = w + static_cast<int64_t>(o) * K * N;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      wr[kk][n] = need_dh && active && n < N ? to_f(wo[(2 * j + kk) * N + n]) : 0.0f;
      acc[kk][n] = 0.0f;
    }
  T* dho = dh + static_cast<int64_t>(o) * P * K;

  for (int i = 0; i < nt; ++i) {
    const int s_next = (i + kStages - 1) % kStages;
    load_tile<T>(h_tile(s_next), ho, dy_tile(s_next), dyo, t0 + i + kStages - 1, P, K, N, NP,
                 i + kStages - 1 < nt);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* ht = h_tile(i % kStages);
    const float* dyt = dy_tile(i % kStages);
    const int64_t p0 = (t0 + i) * kTileP;
    if (active) {
      for (int q = slot; q < kTileP; q += slots) {
        float d[NP];
        read_row<NP>(dyt + q * NP, d);
        if (need_dh && p0 + q < P) {
          float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            s0 = fmaf(d[n], wr[0][n], s0);
            s1 = fmaf(d[n], wr[1][n], s1);
          }
          T* dst = dho + (p0 + q) * K + 2 * j;
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(dst) = make_float2(s0, s1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(s0, s1);
          }
        }
        if (need_dw) {
          float hv[2];
          if constexpr (std::is_same<T, float>::value) {
            const float2 x = *reinterpret_cast<const float2*>(ht + q * K + 2 * j);
            hv[0] = x.x, hv[1] = x.y;
          } else {
            const uint32_t u = *reinterpret_cast<const uint32_t*>(ht + q * K + 2 * j);
            hv[0] = __uint_as_float(u << 16), hv[1] = __uint_as_float(u & 0xffff0000u);
          }
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            acc[0][n] = fmaf(hv[0], d[n], acc[0][n]);
            acc[1][n] = fmaf(hv[1], d[n], acc[1][n]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!need_dw) return;

  // The block's partials, four outputs at a time: each thread stages its
  // two rows' four sums, then K x 4 threads add the slots in slot order.
  float* red = reinterpret_cast<float*>(smem);  // [slots][K][4]
  float* po = partials + (static_cast<int64_t>(o) * gridDim.x + blockIdx.x) * K * N;
#pragma unroll
  for (int n4 = 0; n4 < NP; n4 += 4) {
    if (active) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        *reinterpret_cast<float4*>(red + (slot * K + 2 * j + kk) * 4) =
            make_float4(acc[kk][n4], acc[kk][n4 + 1], acc[kk][n4 + 2], acc[kk][n4 + 3]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < K * 4; e += blockDim.x) {
      const int k = e / 4, n = n4 + (e & 3);
      float s = 0.0f;
      for (int sl = 0; sl < slots; ++sl) s += red[(sl * K + k) * 4 + (e & 3)];
      if (n < N) po[k * N + n] = s;
    }
    __syncthreads();
  }
}

// M2's sum: dw[o, k, n] = the B block partials of object o added in block
// order, rounded once to w's dtype.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    last_bwd_sum(const float* __restrict__ partials, T* __restrict__ dw, int n_objects,
                 int blocks, int KN) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(n_objects) * KN) return;
  const int64_t o = i / KN, e = i - o * KN;
  const float* src = partials + o * blocks * KN + e;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += src[static_cast<int64_t>(b) * KN];
  dw[i] = from_f<T>(s);
}

// The padded output width a kernel is built for.
int padded_out(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32; }

bool widths_ok(int K, int N) {
  return K >= 8 && K <= kMaxIn && K % 8 == 0 && N >= 1 && N <= kMaxOut;
}

cudaError_t with_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int NP, int G, int KC>
cudaError_t launch_fwd(const void* h, const void* w, void* out, int O, int64_t P, int K, int N,
                       cudaStream_t stream) {
  const int64_t n_tiles = (P + kTileP - 1) / kTileP;
  const int64_t blocks = (n_tiles + kFwdTiles - 1) / kFwdTiles;
  if (blocks == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(K) * NP * sizeof(float) +
                      static_cast<size_t>(kStages) * kTileP * K * sizeof(T);
  const cudaError_t err = with_smem(reinterpret_cast<const void*>(last_fwd<T, NP, G, KC>), smem);
  if (err != cudaSuccess) return err;
  last_fwd<T, NP, G, KC><<<dim3(static_cast<unsigned>(blocks), O), kFwdThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<float*>(out), P, K, N);
  return cudaGetLastError();
}

// G: the lanes a point, KC inputs each (8 up to 16 outputs, 4 above, so
// that a lane's weights stay at 128 registers); a power of two >= K / KC.
template <typename T, int NP>
cudaError_t fwd_by_lanes(const void* h, const void* w, void* out, int O, int64_t P, int K, int N,
                         cudaStream_t s) {
  constexpr int KC = NP <= 16 ? 8 : 4;
  constexpr int G0 = KC == 8 ? 4 : 8;  // K <= 128: K / KC <= 4 G0
  const int chunks = K / KC;
  if (chunks <= G0) return launch_fwd<T, NP, G0, KC>(h, w, out, O, P, K, N, s);
  if (chunks <= 2 * G0) return launch_fwd<T, NP, 2 * G0, KC>(h, w, out, O, P, K, N, s);
  return launch_fwd<T, NP, 4 * G0, KC>(h, w, out, O, P, K, N, s);
}

template <typename T>
cudaError_t fwd_by_width(const void* h, const void* w, void* out, int O, int64_t P, int K, int N,
                         cudaStream_t s) {
  switch (padded_out(N)) {
    case 4: return fwd_by_lanes<T, 4>(h, w, out, O, P, K, N, s);
    case 8: return fwd_by_lanes<T, 8>(h, w, out, O, P, K, N, s);
    case 16: return fwd_by_lanes<T, 16>(h, w, out, O, P, K, N, s);
    default: return fwd_by_lanes<T, 32>(h, w, out, O, P, K, N, s);
  }
}

template <typename T, int NP>
cudaError_t launch_bwd(const void* h, const void* w, const void* dy, void* dh, void* partials,
                       int O, int64_t P, int K, int N, int blocks, int need_dh, int need_dw,
                       cudaStream_t stream) {
  if (blocks == 0) return cudaSuccess;
  const size_t ring = static_cast<size_t>(kStages) *
                      (static_cast<size_t>(kTileP) * K * sizeof(T) + kTileP * NP * sizeof(float));
  const size_t staging = static_cast<size_t>(kBwdThreads / (K / 2)) * K * 4 * sizeof(float);
  const size_t smem = ring > staging ? ring : staging;
  const auto kernel = last_bwd<T, NP>;
  const cudaError_t err = with_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(blocks), O), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const float*>(dy),
      static_cast<T*>(dh), static_cast<float*>(partials), P, K, N, need_dh, need_dw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_by_width(const void* h, const void* w, const void* dy, void* dh, void* partials,
                         int O, int64_t P, int K, int N, int blocks, int need_dh, int need_dw,
                         cudaStream_t s) {
  switch (padded_out(N)) {
    case 4:
      return launch_bwd<T, 4>(h, w, dy, dh, partials, O, P, K, N, blocks, need_dh, need_dw, s);
    case 8:
      return launch_bwd<T, 8>(h, w, dy, dh, partials, O, P, K, N, blocks, need_dh, need_dw, s);
    case 16:
      return launch_bwd<T, 16>(h, w, dy, dh, partials, O, P, K, N, blocks, need_dh, need_dw, s);
    default:
      return launch_bwd<T, 32>(h, w, dy, dh, partials, O, P, K, N, blocks, need_dh, need_dw, s);
  }
}

int64_t bwd_blocks(int64_t P) {
  const int64_t n_tiles = (P + kTileP - 1) / kTileP;
  return (n_tiles + kBwdTiles - 1) / kBwdTiles;
}

}  // namespace

extern "C" {

// M1. Returns a cudaError_t code (0 = launched, or nothing to launch); the
// launch is asynchronous on `stream`. dtype 0 float32, 1 bfloat16 (h's and
// w's). h [O, P, K] and w [O, K, N] contiguous, 16-byte aligned; out
// [O, P, N] fp32. 8 <= K <= 128, K % 8 == 0; 1 <= N <= 32.
int romap_last_fwd(int dtype, const void* h, const void* w, void* out, int n_objects, int64_t P,
                   int K, int N, void* stream) {
  if ((dtype != 0 && dtype != 1) || !widths_ok(K, N) || n_objects < 0 || n_objects > 65535 ||
      P < 0)
    return cudaErrorInvalidValue;
  if (n_objects == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fwd_by_width<float>(h, w, out, n_objects, P, K, N, s)
                    : fwd_by_width<__nv_bfloat16>(h, w, out, n_objects, P, K, N, s);
}

// M2, first launch. As M1, with dy [O, P, N] fp32 contiguous, dh [O, P, K]
// in h's dtype (written where need_dh), partials [O, blocks, K, N] fp32
// (written where need_dw); blocks must be ceil(P / 1024).
int romap_last_bwd(int dtype, const void* h, const void* w, const void* dy, void* dh,
                   void* partials, int n_objects, int64_t P, int K, int N, int blocks,
                   int need_dh, int need_dw, void* stream) {
  if ((dtype != 0 && dtype != 1) || !widths_ok(K, N) || n_objects < 0 || n_objects > 65535 ||
      P < 0 || blocks != bwd_blocks(P))
    return cudaErrorInvalidValue;
  if (n_objects == 0 || (!need_dh && !need_dw)) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? bwd_by_width<float>(h, w, dy, dh, partials, n_objects, P, K, N, blocks,
                                          need_dh, need_dw, s)
                    : bwd_by_width<__nv_bfloat16>(h, w, dy, dh, partials, n_objects, P, K, N,
                                                  blocks, need_dh, need_dw, s);
}

// M2, second launch: dw [O, K, N] in w's dtype from the partials of the
// first.
int romap_last_bwd_sum(int dtype, const void* partials, void* dw, int n_objects, int K, int N,
                       int blocks, void* stream) {
  if ((dtype != 0 && dtype != 1) || !widths_ok(K, N) || n_objects < 0 || blocks < 0)
    return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(n_objects) * K * N;
  if (total == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((total + kSumThreads - 1) / kSumThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(partials);
  if (dtype == 0)
    last_bwd_sum<float><<<grid, kSumThreads, 0, s>>>(src, static_cast<float*>(dw), n_objects,
                                                     blocks, K * N);
  else
    last_bwd_sum<__nv_bfloat16><<<grid, kSumThreads, 0, s>>>(
        src, static_cast<__nv_bfloat16*>(dw), n_objects, blocks, K * N);
  return cudaGetLastError();
}

}  // extern "C"
