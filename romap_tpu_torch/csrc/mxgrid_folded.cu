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
// folds the CP ladder into W_eff before K1/K5, unfolds dW_eff after K2/K6,
// and names the variant of each launch from the spec and dtype alone
// (`folded_variant`, `forward_variant`).
//
// Forward (K1, K5; `folded_fused_fwd`). A tent row has exactly two
// non-zeros (knots floor(t) and floor(t)+1 with t = x (r-1)), so every basis
// product is a two-tap lerp per axis and a four-corner bilinear read per
// plane, one point per thread, fp32 in registers, one rounding at the store.
// W_eff (3 x rfp x K, 57,600 B in bf16 at the flagship spec) is staged once
// per block in shared memory, rows padded to an odd word count so that
// lanes at unrelated knots fall into unrelated banks; a bf16 row is read two
// channels a 32-bit load. What bounds it is the store side: per point K +
// 3kp features, 3K factors and 6kp plane residuals. The residuals are
// channel-major ([.., P]), so a warp's 32 points store 64 contiguous bytes.
// The feature rows are point-major (120 B a row at the flagship spec): a
// thread storing its own row one value at a time touches 32 sectors an
// instruction. Variant "staged": a warp collects its 32 rows in shared
// memory (four channels a 64- or 128-bit store, conflict-free) and writes
// them out as one contiguous run of 16-byte vectors. It costs occupancy
// (bf16 flagship: 88,320 B, two blocks an SM instead of three; fp32:
// 174,336 B, one instead of two) and is still 2.2x faster in both dtypes.
// Variant "direct": a thread stores four channels as one vector into its
// own row; taken only where the staged rows do not fit beside the table
// (`fast` in fp32: 199,680 B of table).
//
// Backward, tensor cores (K2, K6 at the instantiated shapes, bf16 and fp32;
// `folded_bwd_tc`). The function is dW_d[j, k] = sum_p hat_d[j, p] u_d[p, k]
// with u_d = g A_e A_f: per axis a [rfp x points] x [points x K] product.
// A block of 12 warps walks its points in tiles of 64. Per tile the raw
// inputs (64 rows of g: one contiguous run; afac, fpl, fli: 128 B rows; the
// points) arrive by 16-byte cp.async into one of two stages, so the next
// tile loads while this one is used. All threads then form u_d in bf16 in
// shared memory ([3, K, 64], 144 B rows: conflict-free for ldmatrix) and
// t = x (rf - 1); each warp owns one axis and MT row tiles of 16, builds
// its `hat` fragments in registers from t (max(0, 1 - |t - j|), the dense
// tent's own operations, rounded to bf16), reads u_d with ldmatrix and
// runs mma.sync.m16n8k16 (bf16 in, fp32 out). The fp32 sums stay in
// registers for the block's whole point range (flagship: 3 x 6 tiles x 4 =
// 72 registers a thread; `fast` and `quality`: 128) and are flushed once, one
// global atomicAdd per non-zero entry: at most floor(SMs / O) blocks an
// object meet on an entry, and a second pass over per-block partials would
// move more bytes than these atomics do. 93 % of `hat` is zeros; the tensor
// cores have nothing else to do here. With planes (rw = 128; kp = 4 at the
// flagship, padded to the 8 columns of an mma tile, kp = 8 at `quality`),
// the line gradient dL_i = hat_w^T (g_i f_pl) is two more row tiles a warp
// on the same path, summed over a tile's points in registers and then into
// fp32 sums in shared memory, and the plane gradient, which does not fit a
// block (393 KB fp32 an object at the flagship, 1.57 MB at `quality`), is
// scattered into L2 with one 16-byte vector atomicAdd per corner and four
// channels, a thread for each (pair, point, 4 channels). `quality` (<4, 8,
// true, 8>) keeps its 128 sums a thread in the 168 registers that 384
// threads have, without spill, because the line sums live in shared memory
// and the loops over a tile are not unrolled; 0.85 ms at 10 objects x
// 131072 points against the scalar kernel's 5.4 (NVIDIA H100 80GB HBM3,
// 700 W, tools/time_encode.py --pairs K1q). What bounds the flagship's
// (tools/ablate_backward.py, three runs on an NVIDIA H100 80GB HBM3 at 700
// W, 10 objects x 131072 points, 0.65-0.70 ms): the products 0.14-0.20 ms
// (55 kFLOP a point: about what mma.sync reaches without wgmma), the
// cp.async loads 0.08-0.14 ms although started a tile ahead, `hat`, u and
// the scatter 0.03-0.16 ms each depending on the run, the rest launch,
// memsets, barriers and the flush. The parts add up: forming tile n + 1's
// operands before tile n's products under one barrier a tile measured no
// faster.
// Rounding `hat` and `u` to bf16 costs 2^-9 a term, unbiased; the error
// against the fp32 plain version is reported by chip_smoke.py.
// fp32 inputs ("tensor_core_split", the fp32 train step of every folded
// preset: `TrainConfig(compute_dtype="float32")`, the gate's
// `--compute-dtype float32`) take the same kernel: rows staged in fp32 (68
// floats), `hat`, u and the line operand formed in fp32 and split into a
// bf16 hi and lo part (after the relu: a lo part may be negative), three
// mma.sync a fragment (hi hi, hi lo, lo hi), the sums added to the gradient
// every kFlushTiles tiles (the tensor cores' fp32 accumulation does not
// round to nearest; unflushed it drifted to 1.03e-4 of the largest entry in
// the unsnapped twin at 10 objects). u gains a lo plane, so two fp32 stages
// do not fit beside it at `quality` (253,184 bytes): that instantiation runs
// one stage (164,608 bytes) and loads the next tile while the products run.
// With 128 sums a thread (`fast`, `quality`) the hi and lo `hat` fragments
// of all four row tiles leave the 168 registers short: those two spill
// about 300 bytes. Forming one or two row tiles' fragments at a time spilled
// more (680-700, 316-324 bytes); at 10 objects x 131072 points `fast`'s K6
// took 2.59 and 1.98 ms so against 1.77, `quality`'s K2 3.14 and 2.29
// against 2.38 (NVIDIA H100 80GB HBM3, 700 W).
//
// Backward, scalar (`folded_fused_bwd`): the specs the tensor-core
// instantiations (flagship, `quality`, CP-only 192 x 48 and 256 x 64) do
// not cover, in both dtypes (the tests' tiny specs, the tiny fp32 train step
// of chip_smoke's parity phase). One thread a point, fp32 atomicAdd into a
// per-block shared-memory accumulator (compiled to a compare-and-swap loop,
// ATOMS.CAST.SPIN), one global atomicAdd per entry at the end. Atomics make
// the backward sums order-dependent in every variant.
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

#include "mxgrid_tc.cuh"

namespace {

template <typename T, bool kPlanes, bool kStage>
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's 32 staged feature rows [32, kout]
  T* st = reinterpret_cast<T*>(smem_raw + align16((size_t)3 * rfp * ks * sizeof(T))) +
          (size_t)warp * 32 * kout;
  // four channels a step where the rows keep a vector store aligned
  const int k_vec = (K % 4 == 0 && kout % 4 == 0) ? K : 0;
  T* afac_o = afac + (size_t)o * 3 * K * P;

  for (int pw = blockIdx.x * blockDim.x + warp * 32; pw < P;
       pw += gridDim.x * blockDim.x) {
    const int p = pw + lane;
    if (p < P) {
      const size_t op = (size_t)o * P + p;
      const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
      T* row = kStage ? st + lane * kout : out + op * kout;

      // CP lines: A_d[k] = lerp of W_eff_d rows; out[k] = A_0 A_1 A_2 from
      // the stored (rounded) factors, as the Pallas kernel forms it.
      Taps t[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) t[d] = tent_taps(x[d], rf);
      int k = 0;
      for (; k < k_vec; k += 4) {
        float prod[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const T* wd = w_s + d * rfp * ks;
          float w0[4], w1[4];
          load4(wd + t[d].j0 * ks + k, w0);
          load4(wd + t[d].j1 * ks + k, w1);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float a = t[d].w0 * w0[c] + t[d].w1 * w1[c];
            const T a_t = from_f<T>(a);
            afac_o[((size_t)d * K + k + c) * P + p] = a_t;
            prod[c] = kPlanes ? prod[c] * to_f(a_t) : to_f(from_f<T>(prod[c] * to_f(a_t)));
          }
        }
        store4(row + k, prod);
      }
      for (; k < K; ++k) {
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
        row[k] = from_f<T>(prod);
      }

      if constexpr (kPlanes) {
        const T* pl_o = planes + (size_t)o * 3 * ru * rv * kp;
        const T* li_o = plines + (size_t)o * 3 * rw * kp;
        T* fpl_o = fpl + (size_t)o * kpl * P;
        T* fli_o = fli + (size_t)o * kpl * P;
        for (int i = 0; i < 3; ++i)
          plane_pair_fwd<T>(x, i, axes, pl_o, li_o, fpl_o, fli_o,
                            row + K + i * kp, P, p, ru, rv, kp, rw);
      }
    }

    if constexpr (kStage) {
      // the warp's rows are one contiguous run of the output
      __syncwarp();
      const int n_rows = P - pw < 32 ? P - pw : 32;
      T* dst = out + ((size_t)o * P + pw) * kout;
      const size_t n_bytes = (size_t)n_rows * kout * sizeof(T);
      if (n_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        const uint4* src4 = reinterpret_cast<const uint4*>(st);
        uint4* dst4 = reinterpret_cast<uint4*>(dst);
        for (int v = lane; v < (int)(n_bytes / 16); v += 32) dst4[v] = src4[v];
      } else {
        for (int e = lane; e < n_rows * kout; e += 32) dst[e] = st[e];
      }
      __syncwarp();
    }
  }
}

// --------------------------------------------------------------------------
// Backward, scalar
// --------------------------------------------------------------------------

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

// --------------------------------------------------------------------------
// Backward, tensor cores (bf16, and fp32 split into bf16 hi and lo parts)
// --------------------------------------------------------------------------

constexpr int kTcThreads = 384;  // 12 warps: four an axis (and plane pair)
constexpr int kTcWarps = kTcThreads / 32;

// Shared-memory bytes of folded_bwd_tc<T, MT, NT, kPlanes, KP>: the input
// stages in T (g, afac, fpl + fli, points), then u and the line operand in
// bf16 (a hi and a lo plane each where T is fp32), t and t_w, and the line
// gradient's fp32 sums. A staged row of 64 points is padded by 16 bytes (72
// bf16, 68 fp32), so that 8 rows of a 16-byte column fall into 8 bank
// groups. Two stages where they fit a block (the next tile loads while this
// one is used), else one, whose next tile loads once this one's operands are
// built: fp32 `quality` would take 2 x 88,576 + 76,032 = 253,184 bytes with
// two, and takes 164,608 with one.
template <typename T, int NT, bool kPlanes, int KP>
struct TcSmem {
  static constexpr int kSplit = sizeof(T) == 4;
  static constexpr int K = NT * 8;
  static constexpr int kout = K + (kPlanes ? 3 * KP : 0);
  static constexpr int row = kTile + 16 / (int)sizeof(T);  // elements of a staged row
  static constexpr int g_bytes = kTile * kout * sizeof(T);
  static constexpr int a_bytes = 3 * K * row * sizeof(T);
  static constexpr int f_bytes = kPlanes ? 2 * 3 * KP * row * sizeof(T) : 0;
  static constexpr int x_bytes = kTile * 3 * 4;
  static constexpr int stage = g_bytes + a_bytes + f_bytes + x_bytes;
  static constexpr int u_bytes = (1 + kSplit) * 3 * K * kRow * 2;
  static constexpr int v_bytes = kPlanes ? (1 + kSplit) * 3 * 8 * kRow * 2 : 0;
  static constexpr int t_bytes = 3 * kTile * 4;
  static constexpr int l_bytes = kPlanes ? 3 * kTcRw * 8 * 4 : 0;
  static constexpr int rest = u_bytes + v_bytes + 2 * t_bytes + l_bytes;
  static constexpr int stages = 2 * stage + rest <= kSmemPerBlock ? 2 : 1;
  static constexpr int total = stages * stage + rest;
  static_assert(total <= kSmemPerBlock, "one stage must fit a block");
};

// Adds a warp's dW_eff sums to the gradient with global atomics (pad rows
// past rf skipped) and restarts them from zero: lane holds rows grp, grp + 8
// and columns 2q, 2q + 1 of each tile.
template <int MT, int NT>
__device__ __forceinline__ void flush_dweff(float (&acc)[MT][NT][4], float* dw_g, int row0,
                                            int rf, int grp, int q) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = row0 + m * 16 + grp + (c >> 1) * 8;
        const float v = acc[m][n][c];
        if (r < rf && v != 0.f) atomicAdd(dw_g + (size_t)r * (NT * 8) + n * 8 + 2 * q + (c & 1), v);
        acc[m][n][c] = 0.f;
      }
}

// K2 (KP plane channels, 4 or 8) and K6 (kPlanes off) on the tensor cores.
// T = bf16 rounds `hat` and u to bf16 ("tensor_core"); T = float forms them
// in fp32, splits each into a bf16 hi and lo part and sums hat_hi u_hi +
// hat_hi u_lo + hat_lo u_hi ("tensor_core_split"; the dropped lo x lo and
// the split's remainders are about 2^-16 of a product), adding its register
// sums to the gradient every kFlushTiles tiles.
template <typename T, int MT, int NT, bool kPlanes, int KP = 4>
__global__ void __launch_bounds__(kTcThreads, 1) folded_bwd_tc(
    const float* __restrict__ pts, const T* __restrict__ afac,
    const T* __restrict__ fpl, const T* __restrict__ fli,
    const T* __restrict__ g, float* __restrict__ dweff,
    float* __restrict__ dplanes, float* __restrict__ dplines, int P, int rf,
    int ru, int rv, int axes, int vec) {
  using S = TcSmem<T, NT, kPlanes, KP>;
  constexpr bool kSplit = S::kSplit;
  constexpr int K = S::K, kout = S::kout, rfp = MT * 64, kRowIn = S::row;
  constexpr int kpl = 3 * KP;
  // 16-byte chunks of a staged row (8 bf16, 16 fp32) and values a chunk
  constexpr int kChunkShift = kSplit ? 4 : 3, kPerChunk = 16 / sizeof(T);
  static_assert(kTile * sizeof(T) / 16 == 1 << kChunkShift, "chunks of a row");
  // The plane work of a tile: one (pair, point, 4-channel chunk) a thread,
  // on the last kItems threads (KP = 4: threads 192-383, beside t on 0-191;
  // KP = 8: all 384, so that a thread holds four channels, not eight, beside
  // its sums).
  constexpr int kChunks = KP / 4, kItems = 3 * kTile * kChunks;
  static_assert(!kPlanes || (KP % 4 == 0 && KP <= 8 && kItems <= kTcThreads),
                "one 4-channel chunk a thread; the line operand has 8 columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ops = smem_raw + S::stages * S::stage;
  bf16* u_s = reinterpret_cast<bf16*>(ops);                // [3, K, kRow] (hi, lo)
  bf16* v_s = reinterpret_cast<bf16*>(ops + S::u_bytes);   // [3, 8, kRow] (hi, lo)
  bf16* ul_s = u_s + 3 * K * kRow;  // the lo planes (read only where kSplit)
  bf16* vl_s = v_s + 3 * 8 * kRow;
  float* t_s = reinterpret_cast<float*>(ops + S::u_bytes + S::v_bytes);
  float* tw_s = t_s + 3 * kTile;  // [3, 64] each
  float* l_s = tw_s + 3 * kTile;  // [3, kTcRw, 8]: the line gradient's sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, q = lane & 3;
  const int d = warp >> 2;                  // this warp's axis and plane pair
  const int row0 = (warp & 3) * MT * 16;    // its first row of dW_eff_d
  const int o = blockIdx.y;
  const T* afac_o = afac + (size_t)o * 3 * K * P;
  const T* g_o = g + (size_t)o * P * kout;
  const float* pts_o = pts + (size_t)o * P * 3;
  const T* fpl_o = kPlanes ? fpl + (size_t)o * kpl * P : nullptr;
  const T* fli_o = kPlanes ? fli + (size_t)o * kpl * P : nullptr;

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;

  if constexpr (kPlanes) {
    for (int j = tid; j < 3 * kTcRw * 8; j += kTcThreads) l_s[j] = 0.f;
    if constexpr (KP < 8) {  // channel rows KP-7 of the line operand stay zero
      for (int j = tid; j < (1 + kSplit) * 3 * 8 * kRow; j += kTcThreads)
        v_s[j] = __float2bfloat16(0.f);
    }
    __syncthreads();  // the flush reads the sums even where a block gets no tile
  }

  // Raw inputs of one tile into a stage; points past P arrive as zeros, so
  // that they add nothing (u = 0) and no stale shared memory reaches a sum.
  // This loop and the others over a tile (u, the line gradient) are not
  // unrolled: unrolled, their counters and trip counts take the registers
  // that `quality`'s 128 sums a thread leave (they spilled 28 bytes).
  auto load_tile = [&](int tile, int s) {
    unsigned char* base = smem_raw + s * S::stage;
    T* sg = reinterpret_cast<T*>(base);
    T* sa = reinterpret_cast<T*>(base + S::g_bytes);
    T* sf = reinterpret_cast<T*>(base + S::g_bytes + S::a_bytes);
    float* sx = reinterpret_cast<float*>(base + S::g_bytes + S::a_bytes + S::f_bytes);
    const int p0 = tile * kTile;
    const int nv = P - p0 < kTile ? P - p0 : kTile;
    if (vec) {  // rows of 16-byte multiples and 16-byte aligned bases: whole 16-byte chunks
      const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(g_o + (size_t)p0 * kout);
#pragma unroll 1
      for (int c = tid; c < S::g_bytes / 16; c += kTcThreads) {
        const bool ok = c * 16 < nv * kout * (int)sizeof(T);
        cp_async16(reinterpret_cast<unsigned char*>(sg) + c * 16, ok ? gsrc + c * 16 : gsrc, ok);
      }
#pragma unroll 1
      for (int c = tid; c < (3 * K) << kChunkShift; c += kTcThreads) {
        const int r = c >> kChunkShift, cc = (c & ((1 << kChunkShift) - 1)) * kPerChunk;
        const bool ok = cc < nv;
        cp_async16(sa + r * kRowIn + cc, afac_o + (size_t)r * P + (ok ? p0 + cc : 0), ok);
      }
      if constexpr (kPlanes) {
#pragma unroll 1
        for (int c = tid; c < (2 * kpl) << kChunkShift; c += kTcThreads) {
          const int r = c >> kChunkShift, cc = (c & ((1 << kChunkShift) - 1)) * kPerChunk;
          const bool ok = cc < nv;
          const T* src = r < kpl ? fpl_o + (size_t)r * P : fli_o + (size_t)(r - kpl) * P;
          cp_async16(sf + r * kRowIn + cc, src + (ok ? p0 + cc : 0), ok);
        }
      }
      const unsigned char* xsrc = reinterpret_cast<const unsigned char*>(pts_o + (size_t)p0 * 3);
#pragma unroll 1
      for (int c = tid; c < S::x_bytes / 16; c += kTcThreads) {
        const bool ok = c * 16 < nv * 12;
        cp_async16(reinterpret_cast<unsigned char*>(sx) + c * 16, ok ? xsrc + c * 16 : xsrc, ok);
      }
    } else {  // any P, any alignment: element by element
      const T zero = from_f<T>(0.f);
#pragma unroll 1
      for (int e = tid; e < kTile * kout; e += kTcThreads)
        sg[e] = e < nv * kout ? g_o[(size_t)p0 * kout + e] : zero;
#pragma unroll 1
      for (int e = tid; e < 3 * K * kTile; e += kTcThreads) {
        const int r = e >> 6, pp = e & 63;
        sa[r * kRowIn + pp] = pp < nv ? afac_o[(size_t)r * P + p0 + pp] : zero;
      }
      if constexpr (kPlanes) {
#pragma unroll 1
        for (int e = tid; e < 2 * kpl * kTile; e += kTcThreads) {
          const int r = e >> 6, pp = e & 63;
          const T* src = r < kpl ? fpl_o + (size_t)r * P : fli_o + (size_t)(r - kpl) * P;
          sf[r * kRowIn + pp] = pp < nv ? src[p0 + pp] : zero;
        }
      }
#pragma unroll 1
      for (int e = tid; e < kTile * 3; e += kTcThreads)
        sx[e] = e < nv * 3 ? pts_o[(size_t)p0 * 3 + e] : 0.f;
    }
    cp_async_commit();
  };

  float* dw_g = dweff + ((size_t)o * 3 + d) * rfp * K;
  const int n_tiles = (P + kTile - 1) / kTile;
  int s = 0, since_flush = 0;
  if ((int)blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  // s ^= stages - 1: the two stages take turns; one stage stays stage 0
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, s ^= S::stages - 1) {
    const bool more = tile + (int)gridDim.x < n_tiles;
    if constexpr (S::stages == 2) {
      if (more) load_tile(tile + gridDim.x, s ^ 1);
      else cp_async_commit();  // an empty group keeps the count below uniform
      cp_async_wait<1>();      // this tile's stage has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... for every thread; the last tile's products are done

    unsigned char* base = smem_raw + s * S::stage;
    const T* sg = reinterpret_cast<const T*>(base);
    const T* sa = reinterpret_cast<const T*>(base + S::g_bytes);
    const T* sf = reinterpret_cast<const T*>(base + S::g_bytes + S::a_bytes);
    const float* sx = reinterpret_cast<const float*>(base + S::g_bytes + S::a_bytes + S::f_bytes);

    // ---- build: t, then (planes) the line operand and the plane scatter
    if (tid < 3 * kTile) {
      const int dd = tid >> 6, pp = tid & 63;
      t_s[dd * kTile + pp] = __fmul_rn(sx[pp * 3 + dd], (float)(rf - 1));
    }
    if constexpr (kPlanes) {
      const int item = tid - (kTcThreads - kItems);  // (pair, chunk, point), point fastest
      if (item >= 0) {
        const int pp = item & 63, c0 = ((item >> 6) % kChunks) * 4, i = (item >> 6) / kChunks;
        const float* x = sx + pp * 3;
        float gi[4];
        if constexpr (kSplit) {
          load4(sg + pp * kout + K + i * KP + c0, gi);
        } else {
          const uint2 graw = *reinterpret_cast<const uint2*>(sg + pp * kout + K + i * KP + c0);
          const float2 g01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&graw.x));
          const float2 g23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&graw.y));
          gi[0] = g01.x, gi[1] = g01.y, gi[2] = g23.x, gi[3] = g23.y;
        }
        float gl[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = i * KP + c0 + c;
          const float f_pl = to_f(sf[r * kRowIn + pp]);
          const float f_li = to_f(sf[(kpl + r) * kRowIn + pp]);
          const float v = gi[c] * f_pl;  // the dL operand
          const bf16 v_hi = __float2bfloat16(v);
          v_s[(i * 8 + c0 + c) * kRow + pp] = v_hi;
          if constexpr (kSplit)
            vl_s[(i * 8 + c0 + c) * kRow + pp] = __float2bfloat16(v - __bfloat162float(v_hi));
          gl[c] = gi[c] * f_li;
        }
        if (c0 == 0) tw_s[i * kTile + pp] = __fmul_rn(x[pair_axis(axes, i, 2)], (float)(kTcRw - 1));
        if (tile * kTile + pp < P) {
          // dP_i[a, b, c0..c0+3] += hat_u[a] hat_v[b] g_i f_li
          const Taps tu = tent_taps(x[pair_axis(axes, i, 0)], ru);
          const Taps tv = tent_taps(x[pair_axis(axes, i, 1)], rv);
          float* p_i = dplanes + ((size_t)o * 3 + i) * ru * rv * KP + c0;
          red4_if(p_i + ((size_t)tu.j0 * rv + tv.j0) * KP, tu.w0 * tv.w0, gl);
          red4_if(p_i + ((size_t)tu.j0 * rv + tv.j1) * KP, tu.w0 * tv.w1, gl);
          red4_if(p_i + ((size_t)tu.j1 * rv + tv.j0) * KP, tu.w1 * tv.w0, gl);
          red4_if(p_i + ((size_t)tu.j1 * rv + tv.j1) * KP, tu.w1 * tv.w1, gl);
        }
      }
    }
    // ---- build: u_d[k, p] = g[p, k] A_e[k, p] A_f[k, p], two points a
    // thread; a warp covers 8 channels x 4 point pairs, which keeps its
    // reads of afac and writes of u free of bank conflicts
#pragma unroll 1
    for (int ws = warp; ws < K; ws += kTcWarps) {
      const int ch = (ws >> 3) * 8 + (lane & 7);
      const int p2 = ((ws & 7) * 4 + (lane >> 3)) * 2;
      float2 a0, a1, a2;
      if constexpr (kSplit) {
        a0 = *reinterpret_cast<const float2*>(sa + (0 * K + ch) * kRowIn + p2);
        a1 = *reinterpret_cast<const float2*>(sa + (1 * K + ch) * kRowIn + p2);
        a2 = *reinterpret_cast<const float2*>(sa + (2 * K + ch) * kRowIn + p2);
      } else {
        a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sa + (0 * K + ch) * kRowIn + p2));
        a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sa + (1 * K + ch) * kRowIn + p2));
        a2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sa + (2 * K + ch) * kRowIn + p2));
      }
      const float gx = to_f(sg[p2 * kout + ch]);
      const float gy = to_f(sg[(p2 + 1) * kout + ch]);
      const float u[3][2] = {{gx * a1.x * a2.x, gy * a1.y * a2.y},
                             {gx * a0.x * a2.x, gy * a0.y * a2.y},
                             {gx * a0.x * a1.x, gy * a0.y * a1.y}};
      if constexpr (kSplit) {
#pragma unroll
        for (int dd = 0; dd < 3; ++dd)
          split_bf16x2(u[dd][0], u[dd][1], reinterpret_cast<uint32_t*>(u_s + (dd * K + ch) * kRow + p2),
                       reinterpret_cast<uint32_t*>(ul_s + (dd * K + ch) * kRow + p2));
      } else {
        __nv_bfloat162 h[3];
#pragma unroll
        for (int dd = 0; dd < 3; ++dd) h[dd] = __floats2bfloat162_rn(u[dd][0], u[dd][1]);
#pragma unroll
        for (int dd = 0; dd < 3; ++dd)
          *reinterpret_cast<__nv_bfloat162*>(u_s + (dd * K + ch) * kRow + p2) = h[dd];
      }
    }
    __syncthreads();
    // one stage: its inputs are spent, so the next tile loads under the products
    if constexpr (S::stages == 1) {
      if (more) load_tile(tile + gridDim.x, 0);
    }

    // ---- products: dW_d[row0.., :] += hat_d[rows, 64 points] u_d[64 points, :]
#pragma unroll 1
    for (int k16 = 0; k16 < kTile; k16 += 16) {
      const float2 t_lo = *reinterpret_cast<const float2*>(t_s + d * kTile + k16 + 2 * q);
      const float2 t_hi = *reinterpret_cast<const float2*>(t_s + d * kTile + k16 + 8 + 2 * q);
      uint32_t a[MT][4], al[kSplit ? MT : 1][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float j0 = (float)(row0 + m * 16 + grp);
        if constexpr (kSplit) hat_fragment_split(j0, t_lo, t_hi, a[m], al[m]);
        else hat_fragment(j0, t_lo, t_hi, a[m]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // four 8 x 8 blocks of u_d: channels 16 np + (0-7, 0-7, 8-15, 8-15),
        // points k16 + (0-7, 8-15, 0-7, 8-15); lane l gives row l % 8 of
        // block l / 8
        const int blk = lane >> 3;
        const int off = (d * K + (2 * np + (blk >> 1)) * 8 + (lane & 7)) * kRow + k16 +
                        (blk & 1) * 8;
        uint32_t b[4], bl[4];
        ldmatrix_x4(u_s + off, b);
        if constexpr (kSplit) ldmatrix_x4(ul_s + off, bl);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma16816(acc[m][2 * np], a[m], b[0], b[1]);
          mma16816(acc[m][2 * np + 1], a[m], b[2], b[3]);
          if constexpr (kSplit) {
            mma16816(acc[m][2 * np], a[m], bl[0], bl[1]);
            mma16816(acc[m][2 * np + 1], a[m], bl[2], bl[3]);
            mma16816(acc[m][2 * np], al[m], b[0], b[1]);
            mma16816(acc[m][2 * np + 1], al[m], b[2], b[3]);
          }
        }
      }
    }
    if constexpr (kPlanes) {
      // dL_d[rows, 0-7] += hat_w[rows, points] (g_d f_pl)[points, 0-7] for the
      // warp's two line tiles: summed in registers over this tile's points,
      // then added to the block's sums in shared memory, each lane to its
      // own entries (the sums of every tile held in registers, beside
      // `quality`'s 128 sum registers, would spill)
      float la[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
      for (int k16 = 0; k16 < kTile; k16 += 16) {
        const float2 w_lo = *reinterpret_cast<const float2*>(tw_s + d * kTile + k16 + 2 * q);
        const float2 w_hi = *reinterpret_cast<const float2*>(tw_s + d * kTile + k16 + 8 + 2 * q);
        const int off = (d * 8 + grp) * kRow + k16 + 2 * q;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(v_s + off);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(v_s + off + 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float j0 = (float)((warp & 3) * 32 + m * 16 + grp);
          uint32_t aw[4];
          if constexpr (kSplit) {
            uint32_t awl[4];
            hat_fragment_split(j0, w_lo, w_hi, aw, awl);
            mma16816(la[m], aw, b0, b1);
            mma16816(la[m], aw, *reinterpret_cast<const uint32_t*>(vl_s + off),
                     *reinterpret_cast<const uint32_t*>(vl_s + off + 8));
            mma16816(la[m], awl, b0, b1);
          } else {
            hat_fragment(j0, w_lo, w_hi, aw);
            mma16816(la[m], aw, b0, b1);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // lane: rows grp, grp + 8 of the tile, columns 2q, 2q + 1
        float* l = l_s + ((size_t)d * kTcRw + (warp & 3) * 32 + m * 16 + grp) * 8 + 2 * q;
        float2* lo = reinterpret_cast<float2*>(l);
        float2* hi = reinterpret_cast<float2*>(l + 8 * 8);
        *lo = make_float2(lo->x + la[m][0], lo->y + la[m][1]);
        *hi = make_float2(hi->x + la[m][2], hi->y + la[m][3]);
      }
    }
    if (kSplit && ++since_flush == kFlushTiles) {
      since_flush = 0;
      flush_dweff(acc, dw_g, row0, rf, grp, q);
    }
  }
  cp_async_wait<0>();

  // ---- flush: the sums left in registers, then the line gradient's
  flush_dweff(acc, dw_g, row0, rf, grp, q);
  if constexpr (kPlanes) {
    float* dl_g = dplines + ((size_t)o * 3 + d) * kTcRw * KP;
    if (2 * q < KP) {  // columns 2q, 2q + 1 are channels; past KP, zero pads
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = (warp & 3) * 32 + m * 16 + grp + (c >> 1) * 8;
          const float v = l_s[((size_t)d * kTcRw + r) * 8 + 2 * q + (c & 1)];
          if (v != 0.f) atomicAdd(dl_g + (size_t)r * KP + 2 * q + (c & 1), v);
        }
    }
  }
}

// --------------------------------------------------------------------------
// Launchers
// --------------------------------------------------------------------------

template <typename T, bool kPlanes, bool kStage>
int launch_fwd(const void* pts, const void* weff, const void* planes,
               const void* plines, void* out, void* afac, void* fpl, void* fli,
               int O, int P, int K, int rf, int rfp, int ru, int rv, int kp,
               int rw, int axes, cudaStream_t stream) {
  size_t smem = (size_t)3 * rfp * odd_word_stride(K, sizeof(T)) * sizeof(T);
  if (kStage) smem = align16(smem) + (size_t)(kThreads / 32) * 32 * (K + 3 * kp) * sizeof(T);
  dim3 grid;
  cudaError_t err = plan(folded_fused_fwd<T, kPlanes, kStage>, smem, O, P, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  folded_fused_fwd<T, kPlanes, kStage><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)weff, (const T*)planes, (const T*)plines,
      (T*)out, (T*)afac, (T*)fpl, (T*)fli, P, K, rf, rfp, ru, rv, kp, rw, axes);
  return (int)cudaGetLastError();
}

// variant 0: "direct", 1: "staged"
template <bool kPlanes>
int dispatch_fwd(int dtype, int variant, const void* pts, const void* weff,
                 const void* planes, const void* plines, void* out, void* afac,
                 void* fpl, void* fli, int O, int P, int K, int rf, int rfp,
                 int ru, int rv, int kp, int rw, int axes, cudaStream_t s) {
#define ROMAP_FWD(T, STAGE)                                                      \
  return launch_fwd<T, kPlanes, STAGE>(pts, weff, planes, plines, out, afac, fpl, \
                                       fli, O, P, K, rf, rfp, ru, rv, kp, rw, axes, s)
  if (dtype == 0 && variant == 0) ROMAP_FWD(float, false);
  if (dtype == 0 && variant == 1) ROMAP_FWD(float, true);
  if (dtype == 1 && variant == 0) ROMAP_FWD(__nv_bfloat16, false);
  if (dtype == 1 && variant == 1) ROMAP_FWD(__nv_bfloat16, true);
#undef ROMAP_FWD
  return (int)cudaErrorInvalidValue;
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

template <typename T, int MT, int NT, bool kPlanes, int KP = 4>
int launch_bwd_tc(const void* pts, const void* afac, const void* fpl,
                  const void* fli, const void* g, void* dweff, void* dplanes,
                  void* dplines, int O, int P, int rf, int ru, int rv, int axes,
                  cudaStream_t stream) {
  const size_t smem = TcSmem<T, NT, kPlanes, KP>::total;
  dim3 grid;
  cudaError_t err = plan(folded_bwd_tc<T, MT, NT, kPlanes, KP>, smem, O, P, 1, &grid,
                         kTcThreads, kTile);
  if (err != cudaSuccess) return (int)err;
  // 16-byte chunks: a row of P values (and 64 points' coordinates) a whole
  // number of them (bf16: P % 8 == 0, fp32: P % 4 == 0), the bases aligned
  const int vec = P * (int)sizeof(T) % 16 == 0 && aligned16(pts) && aligned16(afac) &&
                  aligned16(g) && aligned16(fpl) && aligned16(fli);
  folded_bwd_tc<T, MT, NT, kPlanes, KP><<<grid, kTcThreads, smem, stream>>>(
      (const float*)pts, (const T*)afac, (const T*)fpl, (const T*)fli, (const T*)g,
      (float*)dweff, (float*)dplanes, (float*)dplines, P, rf, ru, rv, axes, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = launched). The launch is asynchronous
// on `stream`; faults during the run surface at the caller's next sync.
// `variant` is the caller's choice from the spec and dtype (mxgrid_cuda.py:
// `forward_variant`: 0 direct, 1 staged; `folded_variant`: 0 scalar, 1 tensor
// cores in bf16, 2 tensor cores on fp32 split into bf16 hi and lo parts); a
// combination that is not instantiated returns cudaErrorInvalidValue.

// K1.
int romap_mx_folded_fwd(int dtype, int variant, const void* pts, const void* weff,
                        const void* planes, const void* plines, void* out,
                        void* afac, void* fpl, void* fli, int O, int P, int K,
                        int rf, int rfp, int ru, int rv, int kp, int rw,
                        int axes, void* stream) {
  return dispatch_fwd<true>(dtype, variant, pts, weff, planes, plines, out, afac, fpl,
                            fli, O, P, K, rf, rfp, ru, rv, kp, rw, axes,
                            (cudaStream_t)stream);
}

// K2. dweff, dplanes and dplines must be zero-filled by the caller. The
// tensor-core variants (1: bf16, 2: fp32 split into bf16 hi and lo parts)
// take (rfp, K) = (192, 48) with kp = 4 (the flagship) and (256, 64) with
// kp = 8 (`quality`), rw = 128 in both.
int romap_mx_folded_bwd(int dtype, int variant, const void* pts, const void* afac,
                        const void* fpl, const void* fli, const void* g,
                        void* dweff, void* dplanes, void* dplines, int O,
                        int P, int K, int rf, int rfp, int ru, int rv, int kp,
                        int rw, int axes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ROMAP_ARGS pts, afac, fpl, fli, g, dweff, dplanes, dplines, O, P, rf, ru, rv, axes, s
  if (variant == 1) {
    if (dtype == 1 && rfp == 192 && K == 48 && kp == 4 && rw == kTcRw)
      return launch_bwd_tc<bf16, 3, 6, true, 4>(ROMAP_ARGS);
    if (dtype == 1 && rfp == 256 && K == 64 && kp == 8 && rw == kTcRw)
      return launch_bwd_tc<bf16, 4, 8, true, 8>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 2) {
    if (dtype == 0 && rfp == 192 && K == 48 && kp == 4 && rw == kTcRw)
      return launch_bwd_tc<float, 3, 6, true, 4>(ROMAP_ARGS);
    if (dtype == 0 && rfp == 256 && K == 64 && kp == 8 && rw == kTcRw)
      return launch_bwd_tc<float, 4, 8, true, 8>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#undef ROMAP_ARGS
  if (variant == 0 && dtype == 0)
    return launch_bwd<float, true>(pts, afac, fpl, fli, g, dweff, dplanes,
                                   dplines, O, P, K, rf, rfp, ru, rv, kp, rw,
                                   axes, s);
  if (variant == 0 && dtype == 1)
    return launch_bwd<__nv_bfloat16, true>(pts, afac, fpl, fli, g, dweff,
                                           dplanes, dplines, O, P, K, rf, rfp,
                                           ru, rv, kp, rw, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K5: out [O, P, K] and afac [O, 3, K, P] from W_eff alone.
int romap_mx_folded_cp_fwd(int dtype, int variant, const void* pts, const void* weff,
                           void* out, void* afac, int O, int P, int K, int rf,
                           int rfp, void* stream) {
  return dispatch_fwd<false>(dtype, variant, pts, weff, nullptr, nullptr, out, afac,
                             nullptr, nullptr, O, P, K, rf, rfp, 0, 0, 0, 0, 0,
                             (cudaStream_t)stream);
}

// K6: dweff [O, 3, rfp, K] f32 (zero-filled by the caller) from afac and
// the cotangent g [O, P, K]. The tensor-core variants (1: bf16, 2: fp32
// split) take (rfp, K) = (192, 48) and (256, 64).
int romap_mx_folded_cp_bwd(int dtype, int variant, const void* pts, const void* afac,
                           const void* g, void* dweff, int O, int P, int K,
                           int rf, int rfp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ROMAP_ARGS pts, afac, nullptr, nullptr, g, dweff, nullptr, nullptr, O, P, rf, 0, 0, 0, s
  if (variant == 1) {
    if (dtype == 1 && rfp == 192 && K == 48)
      return launch_bwd_tc<bf16, 3, 6, false>(ROMAP_ARGS);
    if (dtype == 1 && rfp == 256 && K == 64)
      return launch_bwd_tc<bf16, 4, 8, false>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 2) {
    if (dtype == 0 && rfp == 192 && K == 48)
      return launch_bwd_tc<float, 3, 6, false>(ROMAP_ARGS);
    if (dtype == 0 && rfp == 256 && K == 64)
      return launch_bwd_tc<float, 4, 8, false>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#undef ROMAP_ARGS
  if (variant == 0 && dtype == 0)
    return launch_bwd<float, false>(pts, afac, nullptr, nullptr, g, dweff,
                                    nullptr, nullptr, O, P, K, rf, rfp, 0, 0,
                                    0, 0, 0, s);
  if (variant == 0 && dtype == 1)
    return launch_bwd<__nv_bfloat16, false>(pts, afac, nullptr, nullptr, g,
                                            dweff, nullptr, nullptr, O, P, K,
                                            rf, rfp, 0, 0, 0, 0, 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
