// Unsnapped MX-grid encode for sm_90a: forward (K3) and backward (K4) with
// one plane level, and their CP-only variants (K7, K8).
//
// K3 replaces the Pallas kernel `_make_fused_fwd_kernel`
// (romap_tpu/ops/mxgrid_pallas.py:281-304, driven by `_fused_forward`
// 307-349); K4 replaces `_make_fused_bwd_kernel` (352-374, driven by
// `_fused_backward` 377-413). K7 replaces `_fwd_cp_kernel` (205-207, driven
// by `_cp_forward` 673-695) and K8 `_bwd_cp_kernel` (255-260, driven by
// `_bwd_impl_t` 809-827): the same kernels instantiated without the plane
// pair (kPlanes = false), as K5/K6 are K1/K2 without it. They serve
// `mx_snap_levels=False` (or MX_SNAP=0): the CP ladder is not folded, so
// every level of it is read.
//
// The Pallas kernels multiply by the concatenated multi-level tent basis,
// row (level l, index i) carrying a = r_l - 1, b = i (`_column_consts`,
// 81-90). Here each level is a two-tap lerp of its own rows: 2 taps x L
// levels per axis (12 rows at the flagship's 6-level ladder, against 2 for
// the folded K1), each tap weight computed as tent_taps does, so points
// just outside the cube drop knots exactly as the dense tent does.
//
// Forward, three axes a block (`unsnapped_fwd3`; bf16 at the flagship and
// `fast` ladders, and any spec whose tables fit). What the function needs
// is the bytes (0.18 ms at 10 objects x 131072 points in bf16: the factors
// and features written once); what costs the kernel time is the 12 table
// rows a point, axis and channel it reads from shared memory. A block holds
// all three axes of its object (bf16 flagship: 3 x 465 rows x 50, 139,500
// B), so it forms afac and the product A_0 A_1 A_2 in registers: no second
// pass reads the factors back. Rows are read four channels a step (two
// 32-bit loads; the odd-word stride aligns a row to 4 bytes only). A warp
// stages its 32 output rows in shared memory and stores them as one
// contiguous run, as K1 does ("three_axis_staged", 30,720 B more at the
// flagship); where the rows do not fit beside the tables (K7 at the `fast`
// ladder: 229,680 B of tables) each lane stores four channels a vector into
// its own row ("three_axis_direct"). K3 rounds the product once from the
// rounded factors (mxgrid_pallas.py:295-298), K7 after each factor, as the
// reference forms it outside its kernel in the table dtype (736). The
// blocks split the flattened (object, point) range evenly, one block an SM,
// so that every SM of the card works in one wave.
//
// Forward, three axes a block in channel slices (`unsnapped_fwd3` with
// kSplit, "channel_split"; fp32 at the flagship and `fast` ladders, where
// the three fp32 axes take 273,420 B and 452,400 B, above a block's
// 232,448): a block holds kc channels of all three axes (flagship: 24,
// 139,500 B; `fast`: 16, 118,320 B), so the product is formed in registers
// as above and no second pass reads the factors back.
//
// Forward, one axis a block (`unsnapped_fwd`, "per_axis"; where no channel
// slice fits, and a ladder level of one knot). Block (o, d) stages W_d
// alone (91,140 B fp32), writes the factors A_d and plane pair d; K3 then
// launches `cp_product`, which reads the factors back and forms out[:K] in
// fp32, rounded once; K7's caller forms the product in the table dtype.
//
// Backward, tensor cores (K4, K8 in bf16 and fp32 at the instantiated
// shapes; `unsnapped_bwd_tc`, the variants "tensor_core" and
// "tensor_core_split" that `mxgrid_cuda.unsnapped_variant` names).
// The function is dW_d[j, k] = sum_p hatcat_d[j, p] u_d[p, k] with
// u_d = g A_e A_f and hatcat_d the concatenated multi-level tent basis: per
// axis a [total_res x points] x [points x K] product, which the Pallas
// kernel too gives to its matrix unit. One axis a block stays (blockIdx.z =
// d): 3 x 465 x 48 fp32 sums (268 KB) do not fit an SM's registers, one
// axis does. In the block's accumulator every ladder level is padded to a
// multiple of 16 rows (flagship: 16, 32, 48, 80, 128, 192 = 496 rows = 31
// tiles; `fast`: 624 rows = 39 tiles), so that a 16-row tile lies in one
// level and carries one scale r_l - 1; the unpadded alternative (tiles
// across two levels, 30 and 37 tiles) saves 3-5 % of the products and costs
// every lane two scales and two row maps. Warps own two consecutive tiles
// each (16 warps at K = 48: 48 sum registers a thread; 20 warps at K = 64:
// 64; three or four tiles a warp measured no faster, and the 13 x 3 split
// of 39 tiles is held to 128 registers by its four warps on one scheduler
// and spills). A block walks its points in tiles of 64, as `folded_bwd_tc`
// does: the raw inputs (g: one contiguous run; afac rows of the two other
// axes; pair d's fpl and fli rows; the points) arrive by 16-byte cp.async
// into one of two stages, zero-filled past P; u_d is formed once a tile in
// bf16 in shared memory (144 B rows); each warp builds its `hat` fragments
// in registers from t = x_d (r_l - 1) (the dense tent's own fp32
// operations, so a knot outside [0, r_l - 1] is dropped and never clamped;
// a pad row's sum is never flushed), reads u_d with ldmatrix and runs
// mma.sync.m16n8k16. The fp32 sums stay in registers over the block's whole
// point range and are flushed once with one global atomicAdd per non-zero
// entry. With the plane level (K4: rw = 128, kp = 4 at the flagship,
// padded to the 8 columns of an mma tile, kp = 8 at `quality`) block d also
// owes pair d: the line gradient as one more row tile for each of the last
// 8 warps, the plane gradient as one 16-byte vector atomicAdd a corner and
// four channels. `quality`'s ladder (580 rows, 39 padded tiles, K = 64)
// takes 8 warps of 5 tiles (160 sums a thread of 246 registers, no spill;
// 20 warps of 2 tiles, as K8 at `fast` runs, are held to 96 registers and
// spilled 296 bytes, and measured 6 % slower): 2.0 ms at 10 objects x
// 131072 points against the scalar kernel's 28.5 (NVIDIA H100 80GB HBM3,
// 700 W, tools/time_encode.py --pairs K3q).
//
// In fp32 ("tensor_core_split") the same kernel stages fp32 inputs (68-float
// rows: 256 B + 16), forms `hat` and u in fp32 and splits each into a bf16
// hi and lo part (lo = bf16(x - hi), so hi + lo is within 2^-16 of x; the
// relu acts before the split), and sums hat_hi u_hi + hat_hi u_lo +
// hat_lo u_hi with three mma.sync a fragment (3xTF32 would run m16n8k8 at
// half the bf16 rate, and ldmatrix.b16 serves no 32-bit operand); u and the
// line operand take a lo plane beside the hi one. The tensor cores' own fp32
// accumulation does not round to nearest: with its sums kept over a block's
// whole range (2048 16-point steps at O = 10) `quality`'s K4 drifted 1.03e-4
// of the largest entry from the plain twin (1.7e-5 over 372 steps at O = 2),
// against fp32's tolerance of 1e-4. So the fp32 kernel adds its sums to the
// gradient every kFlushTiles tiles: 1.3e-5 to 1.5e-5 at O = 10, for 2-3 % of
// its time (starting each step's products from zero and adding them in
// fp32 instead cost 12-25 % in registers and spills). The flagship ladder
// runs 8 warps of 4 tiles (242 registers, no spill); K = 64 (`quality`'s
// K4, `fast`'s K8) 8 warps of 5 tiles, whose 160 sums and split operands
// spill 440-490 bytes: every warps x tiles split spills there, holding two
// tiles' `hat` fragments at a time spilled less and measured no faster, and
// two channel slices a block (80 sums a thread, no spill, each `hat` built
// twice) measured 5.49-5.54 ms against 3.85-3.88 at `quality`, O = 10.
// At 10 objects x 131072 points (NVIDIA H100 80GB HBM3, 700 W,
// tools/time_encode.py --dtype float32 --backward-variant, in turns): K4
// 2.77 ms (scalar 11.28), K8 2.18-2.19 (10.09), `quality`'s K4 4.03-4.06
// (28.87).
//
// The grid is floor(SMs / 3 O)
// blocks an object and axis: 120 of 132 SMs at O = 10. What it costs: g
// and the factors are read by three blocks (1.0 KB a point against 0.43 KB
// once). Measured on an NVIDIA H100 80GB HBM3 at 700 W, 10 objects x 131072
// points (tools/time_encode.py, tools/ablate_backward.py --kernel K4): K4
// 1.53-1.65 ms (the scalar kernel 11.3-11.4, and 16.5-16.6 at ray-like
// points, where the tensor-core kernel reads the same 1.53-1.62), K8
// 1.11-1.21 (scalar 10.0-10.1; 15.5-15.8); of K4's time the mma.sync and
// `hat` take 0.83-0.92 ms (`hat` alone 0.2-0.25), the loads 0.24-0.33 (L2
// does not hide all of the repeats), u and the plane atomics ~0.2 each.
//
// Backward, scalar (`unsnapped_bwd`): every spec the tensor-core tile does
// not cover. Block d accumulates dW_d (and the
// plane-line gradient of pair d) in shared memory with fp32 atomicAdd (a
// compare-and-swap loop, slower still where points share rows) and flushes
// them with one global atomicAdd per entry; the plane gradient takes global
// atomics. K8's fp32 accumulator takes 150,800 B at the `fast` ladder.
//
// Layouts (per object o, leading axis O on every array):
//   pts    [O, P, 3] f32          lines  [O, 3, total_res, K]  T
//   planes [O, 3, ru, rv, kp] T   plines [O, 3, rw, kp]   T   (rw = max(ru, rv))
//   out    [O, P, K + 3kp] T      afac   [O, 3, K, P]     T
//   fpl, fli [O, 3kp, P] T        g      [O, P, K + 3kp]  T
//   dlines [O, 3, total_res, K] f32  dplanes/dplines as planes/plines, f32
// (kp = 0 and no plane arrays for K7/K8; K8's g is [O, P, K].)
// T is float (dtype code 0) or __nv_bfloat16 (dtype code 1); arithmetic is
// fp32 in registers, values are rounded to T where they are stored.

#include "mxgrid_tc.cuh"

namespace {

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(kThreads) unsnapped_fwd(
    const float* __restrict__ pts, const T* __restrict__ lines,
    const T* __restrict__ planes, const T* __restrict__ plines,
    T* __restrict__ out, T* __restrict__ afac, T* __restrict__ fpl,
    T* __restrict__ fli, Ladder lad, int P, int K, int total_res, int ru,
    int rv, int kp, int rw, int axes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // W_d [total_res, ks]
  const int ks = odd_word_stride(K, sizeof(T));
  const int o = blockIdx.y, d = blockIdx.z;
  const int n_w = total_res * K;
  const T* w_g = lines + ((size_t)o * 3 + d) * n_w;
  for (int j = threadIdx.x; j < n_w; j += blockDim.x)
    w_s[(j / K) * ks + j % K] = w_g[j];
  __syncthreads();

  const int kpl = 3 * kp;
  const int kout = K + kpl;
  T* afac_d = afac + ((size_t)o * 3 + d) * K * P;
  const T* pl_o = planes + (size_t)o * 3 * ru * rv * kp;
  const T* li_o = plines + (size_t)o * 3 * rw * kp;
  T* fpl_o = fpl + (size_t)o * kpl * P;
  T* fli_o = fli + (size_t)o * kpl * P;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};

    // Per level: the two rows (as shared-memory offsets) and their weights.
    int r0[kMaxLevels], r1[kMaxLevels];
    float w0[kMaxLevels], w1[kMaxLevels];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      r0[l] = r1[l] = 0;
      w0[l] = w1[l] = 0.f;
      if (l < lad.n) {
        const Taps tp = tent_taps(x[d], lad.res[l]);
        r0[l] = (lad.off[l] + tp.j0) * ks;
        r1[l] = (lad.off[l] + tp.j1) * ks;
        w0[l] = tp.w0;
        w1[l] = tp.w1;
      }
    }
    for (int k = 0; k < K; ++k) {
      float a = 0.f;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l)
        if (l < lad.n)
          a += w0[l] * to_f(w_s[r0[l] + k]) + w1[l] * to_f(w_s[r1[l] + k]);
      afac_d[(size_t)k * P + p] = from_f<T>(a);
    }

    if constexpr (kPlanes)
      plane_pair_fwd<T>(x, d, axes, pl_o, li_o, fpl_o, fli_o,
                        out + op * kout + K + d * kp, P, p, ru, rv, kp, rw);
  }
}

// out[o, p, k] = A_0 A_1 A_2 for k < K, from the stored factors.
template <typename T>
__global__ void __launch_bounds__(kThreads) cp_product(
    const T* __restrict__ afac, T* __restrict__ out, int P, int K, int kout) {
  const int o = blockIdx.y;
  const T* a_o = afac + (size_t)o * 3 * K * P;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    T* out_p = out + ((size_t)o * P + p) * kout;
    for (int k = 0; k < K; ++k) {
      const float prod = to_f(a_o[(size_t)k * P + p]) *
                         to_f(a_o[((size_t)K + k) * P + p]) *
                         to_f(a_o[((size_t)2 * K + k) * P + p]);
      out_p[k] = from_f<T>(prod);
    }
  }
}

// Forward, all three axes a block (`unsnapped_fwd3`; the variants
// "three_axis_staged" and "three_axis_direct" of
// mxgrid_cuda.unsnapped_forward_variant). The block's range of the
// flattened (object, point) index is cut where the object changes; for each
// object it stages W_0, W_1, W_2 at the odd-word stride ([3 total_res, ks],
// axis d from row d total_res), one row a warp and 4 bytes a lane. A lane
// takes one point: its 2 x L taps per axis (tent_taps, so a knot outside
// [0, r_l - 1] is dropped, never clamped), kept as one row j and two
// weights of rows j and j + 1 (`Pair`: 3 registers a level, not 4), then,
// four channels a step (load4: two 32-bit shared loads in bf16), the three
// factors a_d = sum_l w0 W_d[j0] + w1 W_d[j1] in fp32 (the per-axis
// kernel's order of operations), each rounded to T and stored to afac
// (consecutive lanes, consecutive points: coalesced), and the product of
// the rounded factors: with planes (K3) in fp32, rounded once, as the
// Pallas kernel forms it (mxgrid_pallas.py:295-298); without (K7) rounded
// to T after each factor, as the reference forms it outside its kernel
// (mxgrid_pallas.py:736). With kStage the warp's 32 output rows (plane
// features included) are collected in shared memory and stored as one
// contiguous run of 16-byte vectors; without, each lane stores four
// channels a vector into its own row. One block of 16 warps an SM (the bf16
// flagship tables take 139,500 B, the staged rows 61,440 B more), and as
// many blocks as the card has SMs, each a range of `span` points (a
// multiple of 32): every SM works, and no block is left for a second wave.
// kLv is the ladder's level count where it is 6 (the shipped presets),
// else kMaxLevels with a guard.
//
// With kSplit ("channel_split": fp32 at the flagship and `fast` ladders,
// whose three axes do not fit a block) the channels are cut into K / kc
// slices of kc, one slice a block row (blockIdx.y): the block stages
// columns [c0, c0 + kc) of the three axes' rows (fp32 flagship, kc = 24:
// 3 x 465 x 25 x 4 = 139,500 B, and 49,152 B of staged rows), forms their
// factors and their product in registers (the product is per channel, so
// the slices are exact), and stores each warp's 32 rows of kc channels as
// 16-byte vectors, row by row. Plane pair i goes to slice i % (K / kc),
// which writes its features into the output row directly. Every slice
// computes the point's taps again: (K / kc - 1) x 3 x L tent evaluations
// more a point, in place of the per-axis design's second launch, which
// read 3 K factors back and wrote the product.
constexpr int kFwd3Threads = 512;

// The two taps of one level as the rows j, j + 1 and their weights: the
// value is a * W[j] + b * W[j + 1]. A tap that tent_taps drops has weight 0;
// where only knot 0 is in reach, j = 0 and a carries its weight; where only
// knot r - 1 is, j = r - 2 and b carries it; both rows stay in the level
// (r >= 2), and a term of weight 0 adds an exact 0.
struct Pair {
  int row;  // shared-memory offset of row j
  float a, b;
};

__device__ __forceinline__ Pair tap_pair(float x, int r, int row0, int ks) {
  const Taps tp = tent_taps(x, r);
  Pair q{row0 * ks, 0.f, 0.f};
  if (tp.w0 != 0.f && tp.j0 == r - 1) {  // knot r - 1 alone
    q.row = (row0 + r - 2) * ks;
    q.b = tp.w0;
  } else if (tp.w0 != 0.f) {
    q.row = (row0 + tp.j0) * ks;
    q.a = tp.w0;
    q.b = tp.w1;
  } else if (tp.w1 != 0.f) {  // knot 0 alone (t in (-1, 0))
    q.a = tp.w1;
  }
  return q;
}

template <typename T, bool kPlanes, bool kStage, int kLv, bool kSplit = false>
__global__ void __launch_bounds__(kFwd3Threads, 1) unsnapped_fwd3(
    const float* __restrict__ pts, const T* __restrict__ lines,
    const T* __restrict__ planes, const T* __restrict__ plines,
    T* __restrict__ out, T* __restrict__ afac, T* __restrict__ fpl,
    T* __restrict__ fli, Ladder lad, int O, int P, int K, int total_res, int ru,
    int rv, int kp, int rw, int axes, int span, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // W [3 * total_res, ks], columns [c0, c0 + kc)
  const int c0 = kSplit ? (int)blockIdx.y * kc : 0;  // kc == K without kSplit
  const int ks = odd_word_stride(kc, sizeof(T));
  const int kpl = 3 * kp;
  const int kout = K + kpl;
  const int rs = kSplit ? kc : kout;  // length of a staged row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // this warp's 32 staged output rows [32, rs]
  T* st = reinterpret_cast<T*>(smem_raw + align16((size_t)3 * total_res * ks * sizeof(T))) +
          (size_t)warp * 32 * rs;
  // four channels a step where the rows keep a vector store aligned
  const int k_vec = (kc % 4 == 0 && (kStage ? rs : kout) % 4 == 0) ? kc : 0;
  const int n_rows = 3 * total_res;
  const long long n_all = (long long)O * P;
  const long long q_stop = (long long)(blockIdx.x + 1) * span;
  const long long q_end = q_stop < n_all ? q_stop : n_all;

  for (long long s0 = (long long)blockIdx.x * span; s0 < q_end;) {
    const int o = (int)(s0 / P);
    const long long o_end = (long long)(o + 1) * P;
    const long long s1 = q_end < o_end ? q_end : o_end;
    __syncthreads();  // the previous object's table is no longer read
    const T* w_g = lines + (size_t)o * n_rows * K + c0;
    if ((K * sizeof(T)) % 4 == 0 && (kc * sizeof(T)) % 4 == 0 && (c0 * sizeof(T)) % 4 == 0) {
      // 4-byte words, a row a warp
      const int kw = kc * sizeof(T) / 4, gw = K * sizeof(T) / 4, ksw = ks * sizeof(T) / 4;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(w_g);
      uint32_t* dst = reinterpret_cast<uint32_t*>(w_s);
      for (int r = warp; r < n_rows; r += n_warps)
        for (int c = lane; c < kw; c += 32) dst[r * ksw + c] = src[r * gw + c];
    } else {
      for (int j = threadIdx.x; j < n_rows * kc; j += blockDim.x)
        w_s[(j / kc) * ks + j % kc] = w_g[(size_t)(j / kc) * K + j % kc];
    }
    __syncthreads();
    T* afac_o = afac + (size_t)o * 3 * K * P + (size_t)c0 * P;  // channel c0 of axis 0
    const T* pl_o = planes + (size_t)o * 3 * ru * rv * kp;
    const T* li_o = plines + (size_t)o * 3 * rw * kp;
    T* fpl_o = fpl + (size_t)o * kpl * P;
    T* fli_o = fli + (size_t)o * kpl * P;

    for (long long qw = s0 + warp * 32; qw < s1; qw += n_warps * 32) {
      const long long q = qw + lane;
      if (q < s1) {
        const int p = (int)(q - (long long)o * P);
        const float x[3] = {pts[q * 3 + 0], pts[q * 3 + 1], pts[q * 3 + 2]};
        T* row = kStage ? st + lane * rs : out + q * kout + c0;

        // per axis and level: row j's offset and the weights of rows j, j + 1
        Pair tp[3][kLv];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
#pragma unroll
          for (int l = 0; l < kLv; ++l) {
            tp[d][l] = Pair{0, 0.f, 0.f};
            if (kLv != kMaxLevels || l < lad.n)
              tp[d][l] = tap_pair(x[d], lad.res[l], d * total_res + lad.off[l], ks);
          }
        }
        int k = 0;
        for (; k < k_vec; k += 4) {
          float prod[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int l = 0; l < kLv; ++l) {
              if (kLv != kMaxLevels || l < lad.n) {
                float v0[4], v1[4];
                load4(w_s + tp[d][l].row + k, v0);
                load4(w_s + tp[d][l].row + ks + k, v1);
#pragma unroll
                for (int c = 0; c < 4; ++c) a[c] += tp[d][l].a * v0[c] + tp[d][l].b * v1[c];
              }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const T a_t = from_f<T>(a[c]);
              afac_o[((size_t)d * K + k + c) * P + p] = a_t;
              prod[c] = kPlanes ? prod[c] * to_f(a_t) : to_f(from_f<T>(prod[c] * to_f(a_t)));
            }
          }
          store4(row + k, prod);
        }
        for (; k < kc; ++k) {
          float prod = 1.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            float a = 0.f;
#pragma unroll
            for (int l = 0; l < kLv; ++l)
              if (kLv != kMaxLevels || l < lad.n)
                a += tp[d][l].a * to_f(w_s[tp[d][l].row + k]) +
                     tp[d][l].b * to_f(w_s[tp[d][l].row + ks + k]);
            const T a_t = from_f<T>(a);
            afac_o[((size_t)d * K + k) * P + p] = a_t;
            prod = kPlanes ? prod * to_f(a_t) : to_f(from_f<T>(prod * to_f(a_t)));
          }
          row[k] = from_f<T>(prod);
        }

        if constexpr (kPlanes && kSplit) {  // pair i in slice i % (K / kc), into out directly
          for (int i = blockIdx.y; i < 3; i += gridDim.y)
            plane_pair_fwd<T>(x, i, axes, pl_o, li_o, fpl_o, fli_o, out + q * kout + K + i * kp,
                              P, p, ru, rv, kp, rw);
        } else if constexpr (kPlanes) {
          for (int i = 0; i < 3; ++i)
            plane_pair_fwd<T>(x, i, axes, pl_o, li_o, fpl_o, fli_o, row + K + i * kp, P, p,
                              ru, rv, kp, rw);
        }
      }

      if constexpr (kStage && kSplit) {
        // the warp's rows: kc channels of 32 output rows, a row's run after another
        __syncwarp();
        const int n_rows = s1 - qw < 32 ? (int)(s1 - qw) : 32;
        T* dst = out + qw * kout + c0;
        const int n_vec = kc * sizeof(T) / 16;  // 16-byte vectors a row
        if ((kc * sizeof(T)) % 16 == 0 && (kout * sizeof(T)) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
          for (int v = lane; v < n_rows * n_vec; v += 32) {
            const int r = v / n_vec, c = v - r * n_vec;
            reinterpret_cast<uint4*>(dst + (size_t)r * kout)[c] =
                reinterpret_cast<const uint4*>(st + r * kc)[c];
          }
        } else {
          for (int e = lane; e < n_rows * kc; e += 32)
            dst[(size_t)(e / kc) * kout + e % kc] = st[e];
        }
        __syncwarp();
      } else if constexpr (kStage) {
        // the warp's rows are one contiguous run of the output
        __syncwarp();
        const int n_rows = s1 - qw < 32 ? (int)(s1 - qw) : 32;
        T* dst = out + qw * kout;
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
    s0 = s1;
  }
}

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(kThreads) unsnapped_bwd(
    const float* __restrict__ pts, const T* __restrict__ afac,
    const T* __restrict__ fpl, const T* __restrict__ fli,
    const T* __restrict__ g, float* __restrict__ dlines,
    float* __restrict__ dplanes, float* __restrict__ dplines, Ladder lad,
    int P, int K, int total_res, int ru, int rv, int kp, int rw, int axes) {
  extern __shared__ __align__(16) float s_acc[];
  const int ks = odd_word_stride(K, 4), ls = odd_word_stride(kp, 4);
  float* dw_s = s_acc;                    // dW_d [total_res, ks]
  float* dl_s = s_acc + total_res * ks;   // dL_d [rw, ls]
  for (int j = threadIdx.x; j < total_res * ks + rw * ls; j += blockDim.x)
    s_acc[j] = 0.f;
  __syncthreads();

  const int o = blockIdx.y, d = blockIdx.z;
  const int e = d == 0 ? 1 : 0, f = d == 2 ? 1 : 2;  // the other two axes
  const int kpl = 3 * kp;
  const int kout = K + kpl;
  const T* afac_o = afac + (size_t)o * 3 * K * P;
  const T* fpl_o = fpl + (size_t)o * kpl * P;
  const T* fli_o = fli + (size_t)o * kpl * P;
  float* dp_d = dplanes + ((size_t)o * 3 + d) * ru * rv * kp;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const size_t op = (size_t)o * P + p;
    const float x[3] = {pts[op * 3 + 0], pts[op * 3 + 1], pts[op * 3 + 2]};
    const T* g_p = g + op * kout;

    int r0[kMaxLevels], r1[kMaxLevels];
    float w0[kMaxLevels], w1[kMaxLevels];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      r0[l] = r1[l] = 0;
      w0[l] = w1[l] = 0.f;
      if (l < lad.n) {
        const Taps tp = tent_taps(x[d], lad.res[l]);
        r0[l] = (lad.off[l] + tp.j0) * ks;
        r1[l] = (lad.off[l] + tp.j1) * ks;
        w0[l] = tp.w0;
        w1[l] = tp.w1;
      }
    }
    // dW_d[row, k] += hat_d[row] * g[k] * A_e[k] * A_f[k]
    for (int k = 0; k < K; ++k) {
      const float gk = to_f(g_p[k]);
      const float ae = to_f(afac_o[((size_t)e * K + k) * P + p]);
      const float af = to_f(afac_o[((size_t)f * K + k) * P + p]);
      const float u = gk * ae * af;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l)
        if (l < lad.n) {
          add_if(&dw_s[r0[l] + k], w0[l], u);
          add_if(&dw_s[r1[l] + k], w1[l], u);
        }
    }

    if constexpr (kPlanes)
      plane_pair_bwd<T>(x, d, axes, g_p + K + d * kp, fpl_o, fli_o, dl_s, ls,
                        dp_d, P, p, ru, rv, kp, rw);
  }

  __syncthreads();
  float* dw_g = dlines + ((size_t)o * 3 + d) * total_res * K;
  for (int j = threadIdx.x; j < total_res * K; j += blockDim.x) {
    const float v = dw_s[(j / K) * ks + j % K];
    if (v != 0.f) atomicAdd(&dw_g[j], v);
  }
  if constexpr (kPlanes) {
    float* dl_g = dplines + ((size_t)o * 3 + d) * rw * kp;
    for (int j = threadIdx.x; j < rw * kp; j += blockDim.x) {
      const float v = dl_s[(j / kp) * ls + j % kp];
      if (v != 0.f) atomicAdd(&dl_g[j], v);
    }
  }
}

// --------------------------------------------------------------------------
// Backward, tensor cores (bf16, and fp32 split into bf16 hi and lo parts)
// --------------------------------------------------------------------------

// The fp32 sums are added to the gradient every kFlushTiles tiles
// (mxgrid_tc.cuh).

// One 16-row tile of the block's accumulator. Every ladder level is padded
// to a multiple of 16 rows there (flagship: 16, 32, 48, 80, 128, 192 = 496
// rows = 31 tiles for 465 ladder rows), so a tile lies in one level and
// carries one scale; `mxgrid_cuda.padded_row_map` is the same map in Python.
struct TileRows {
  float scale;  // r_l - 1 of the tile's level
  int j0;       // the tile's first knot within its level
  int row;      // ... and within the ladder (off_l + j0)
  int n;        // ladder rows it holds (16, fewer at a level's end, 0: unused)
};

__host__ __device__ __forceinline__ int padded_tiles(const Ladder& lad) {
  int tiles = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l < lad.n) tiles += (lad.res[l] + 15) >> 4;
  return tiles;
}

__device__ __forceinline__ TileRows tile_rows(const Ladder& lad, int tile) {
  TileRows tr{0.f, -64, 0, 0};  // a slot past the ladder: hat = 0, nothing flushed
  int first = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l < lad.n) {
      const int nt = (lad.res[l] + 15) >> 4;
      if (tile >= first && tile < first + nt) {
        const int j0 = (tile - first) * 16;
        const int left = lad.res[l] - j0;
        tr.scale = (float)(lad.res[l] - 1);
        tr.j0 = j0;
        tr.row = lad.off[l] + j0;
        tr.n = left < 16 ? left : 16;
      }
      first += nt;
    }
  return tr;
}

// Shared-memory bytes of unsnapped_bwd_tc<T, ., ., NT, kPlanes, KP>: two
// input stages in T (g; afac of the two other axes; pair d's fpl + fli;
// points), then u_d and the line operand in bf16 (a hi and a lo plane each
// where T is fp32), x_d and t_w. A staged row of 64 points is padded by 16
// bytes (72 bf16, 68 fp32), so that 8 rows of a 16-byte column fall into 8
// bank groups.
template <typename T, int NT, bool kPlanes, int KP>
struct UtcSmem {
  static constexpr int kSplit = sizeof(T) == 4;
  static constexpr int K = NT * 8;
  static constexpr int kout = K + (kPlanes ? 3 * KP : 0);
  static constexpr int row = kTile + 16 / (int)sizeof(T);  // elements of a staged row
  static constexpr int g_bytes = kTile * kout * sizeof(T);
  static constexpr int a_bytes = 2 * K * row * sizeof(T);
  static constexpr int f_bytes = kPlanes ? 2 * KP * row * sizeof(T) : 0;
  static constexpr int x_bytes = kTile * 3 * 4;
  static constexpr int stage = g_bytes + a_bytes + f_bytes + x_bytes;
  static constexpr int u_bytes = (1 + kSplit) * K * kRow * 2;
  static constexpr int v_bytes = kPlanes ? (1 + kSplit) * 8 * kRow * 2 : 0;
  static constexpr int total = 2 * stage + u_bytes + v_bytes + 2 * kTile * 4;
};

// Adds a warp's sums to the gradients with global atomics and restarts them
// from zero: lane holds rows grp, grp + 8 and columns 2q, 2q + 1 of each
// tile (pad rows skipped) and, where dl_g is set, of its line-gradient tile
// (dl_g: the lane's first entry there).
template <int KP, int MT, int NT>
__device__ __forceinline__ void flush_sums(float (&acc)[MT][NT][4], float (&lacc)[4],
                                           const TileRows (&tr)[MT], float* dw_g, float* dl_g,
                                           int grp, int q) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = grp + (c >> 1) * 8;
        const float v = acc[m][n][c];
        if (r < tr[m].n && v != 0.f)
          atomicAdd(dw_g + (size_t)(tr[m].row + r) * (NT * 8) + n * 8 + 2 * q + (c & 1), v);
        acc[m][n][c] = 0.f;
      }
  if (dl_g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (lacc[c] != 0.f) atomicAdd(dl_g + (c >> 1) * 8 * KP + (c & 1), lacc[c]);
      lacc[c] = 0.f;
    }
  }
}

// K4 / K8 on the tensor cores. Block (., o, d) owns axis d of object o:
// dW_d = hatcat_d^T u_d over its points, u_d = g A_e A_f, as a
// [padded rows x points] x [points x K] product. kWarps warps own MT
// consecutive 16-row tiles each (kWarps * MT >= the ladder's padded tiles);
// the fp32 sums stay in registers over the block's whole point range and are
// flushed once with global atomics, pad rows skipped (in fp32, every
// kFlushTiles tiles). With planes (KP
// channels, 4 or 8), block d also owes pair d: the line gradient as one more
// row tile for each of the last 8 warps, the plane gradient as 16-byte
// vector atomics, one (point, 4-channel chunk) a thread. T = bf16 rounds
// `hat` and u to bf16 ("tensor_core"); T = float splits each into a bf16 hi
// and lo part and sums hat_hi u_hi + hat_hi u_lo + hat_lo u_hi
// ("tensor_core_split"; the dropped lo x lo and the split's remainders are
// about 2^-16 of a product).
template <typename T, int kWarps, int MT, int NT, bool kPlanes, int KP = 4>
__global__ void __launch_bounds__(kWarps * 32, 1) unsnapped_bwd_tc(
    const float* __restrict__ pts, const T* __restrict__ afac,
    const T* __restrict__ fpl, const T* __restrict__ fli,
    const T* __restrict__ g, float* __restrict__ dlines,
    float* __restrict__ dplanes, float* __restrict__ dplines, Ladder lad,
    int P, int total_res, int ru, int rv, int axes, int vec) {
  using S = UtcSmem<T, NT, kPlanes, KP>;
  constexpr bool kSplit = S::kSplit;
  constexpr int K = S::K, kout = S::kout, kThr = kWarps * 32, kRowIn = S::row;
  constexpr int kpl = 3 * KP, kLineTiles = kTcRw / 16, kChunks = KP / 4;
  constexpr int kRowChunks = kTile * sizeof(T) / 16, kPerChunk = 16 / sizeof(T);
  static_assert(!kPlanes || kWarps >= kLineTiles, "one line tile a warp");
  static_assert(!kPlanes || (KP % 4 == 0 && KP <= 8), "4-channel chunks; 8 line columns");
  static_assert(kThr >= (1 + kChunks) * kTile,
                "threads 0-63 stage x_d, the next 64 a chunk pair d's plane work");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* u_s = reinterpret_cast<bf16*>(smem_raw + 2 * S::stage);               // [K, kRow] (hi, lo)
  bf16* v_s = reinterpret_cast<bf16*>(smem_raw + 2 * S::stage + S::u_bytes);  // [8, kRow] (hi, lo)
  bf16* ul_s = u_s + K * kRow;  // the lo planes (read only where kSplit)
  bf16* vl_s = v_s + 8 * kRow;
  float* xd_s = reinterpret_cast<float*>(smem_raw + 2 * S::stage + S::u_bytes + S::v_bytes);
  float* tw_s = xd_s + kTile;  // [64] each

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, q = lane & 3;
  const int o = blockIdx.y, d = blockIdx.z;
  const int e = d == 0 ? 1 : 0, f = d == 2 ? 1 : 2;  // the other two axes
  const int lt = kWarps - 1 - warp;  // this warp's tile of the line gradient
  const T* afac_o = afac + (size_t)o * 3 * K * P;
  const T* g_o = g + (size_t)o * P * kout;
  const float* pts_o = pts + (size_t)o * P * 3;
  const T* fpl_d = kPlanes ? fpl + ((size_t)o * kpl + d * KP) * P : nullptr;
  const T* fli_d = kPlanes ? fli + ((size_t)o * kpl + d * KP) * P : nullptr;

  TileRows tr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) tr[m] = tile_rows(lad, warp * MT + m);

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;
  float lacc[4] = {0.f, 0.f, 0.f, 0.f};

  if constexpr (kPlanes && KP < 8) {  // channel rows KP-7 of the line operand stay zero
    for (int j = tid; j < (1 + kSplit) * 8 * kRow; j += kThr) v_s[j] = __float2bfloat16(0.f);
  }

  // Raw inputs of one tile into a stage; points past P arrive as zeros, so
  // that they add nothing (u = 0) and no stale shared memory reaches a sum.
  auto load_tile = [&](int tile, int s) {
    unsigned char* base = smem_raw + s * S::stage;
    T* sg = reinterpret_cast<T*>(base);
    T* sa = reinterpret_cast<T*>(base + S::g_bytes);
    T* sf = reinterpret_cast<T*>(base + S::g_bytes + S::a_bytes);
    float* sx = reinterpret_cast<float*>(base + S::g_bytes + S::a_bytes + S::f_bytes);
    const int p0 = tile * kTile;
    const int nv = P - p0 < kTile ? P - p0 : kTile;
    if (vec) {  // P % 8 == 0 and 16-byte aligned bases: whole 16-byte chunks
      const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(g_o + (size_t)p0 * kout);
      for (int c = tid; c < S::g_bytes / 16; c += kThr) {
        const bool ok = c * 16 < nv * kout * (int)sizeof(T);
        cp_async16(reinterpret_cast<unsigned char*>(sg) + c * 16, ok ? gsrc + c * 16 : gsrc, ok);
      }
      for (int c = tid; c < 2 * K * kRowChunks; c += kThr) {  // rows of A_e, then of A_f
        const int r = c / kRowChunks, cc = (c % kRowChunks) * kPerChunk;
        const bool ok = cc < nv;
        const T* src = afac_o + ((size_t)(r < K ? e : f) * K + (r < K ? r : r - K)) * P;
        cp_async16(sa + r * kRowIn + cc, src + (ok ? p0 + cc : 0), ok);
      }
      if constexpr (kPlanes) {
        for (int c = tid; c < 2 * KP * kRowChunks; c += kThr) {  // pair d's fpl, then fli
          const int r = c / kRowChunks, cc = (c % kRowChunks) * kPerChunk;
          const bool ok = cc < nv;
          const T* src = r < KP ? fpl_d + (size_t)r * P : fli_d + (size_t)(r - KP) * P;
          cp_async16(sf + r * kRowIn + cc, src + (ok ? p0 + cc : 0), ok);
        }
      }
      const unsigned char* xsrc = reinterpret_cast<const unsigned char*>(pts_o + (size_t)p0 * 3);
      for (int c = tid; c < S::x_bytes / 16; c += kThr) {
        const bool ok = c * 16 < nv * 12;
        cp_async16(reinterpret_cast<unsigned char*>(sx) + c * 16, ok ? xsrc + c * 16 : xsrc, ok);
      }
    } else {  // any P, any alignment: element by element
      const T zero = from_f<T>(0.f);
      for (int i = tid; i < kTile * kout; i += kThr)
        sg[i] = i < nv * kout ? g_o[(size_t)p0 * kout + i] : zero;
      for (int i = tid; i < 2 * K * kTile; i += kThr) {
        const int r = i >> 6, pp = i & 63;
        const T* src = afac_o + ((size_t)(r < K ? e : f) * K + (r < K ? r : r - K)) * P;
        sa[r * kRowIn + pp] = pp < nv ? src[p0 + pp] : zero;
      }
      if constexpr (kPlanes) {
        for (int i = tid; i < 2 * KP * kTile; i += kThr) {
          const int r = i >> 6, pp = i & 63;
          const T* src = r < KP ? fpl_d + (size_t)r * P : fli_d + (size_t)(r - KP) * P;
          sf[r * kRowIn + pp] = pp < nv ? src[p0 + pp] : zero;
        }
      }
      for (int i = tid; i < kTile * 3; i += kThr)
        sx[i] = i < nv * 3 ? pts_o[(size_t)p0 * 3 + i] : 0.f;
    }
    cp_async_commit();
  };

  float* dw_g = dlines + ((size_t)o * 3 + d) * total_res * K;
  float* dl_g = kPlanes && lt < kLineTiles && 2 * q < KP  // columns past KP are zero pads
                    ? dplines + ((size_t)o * 3 + d) * kTcRw * KP + (lt * 16 + grp) * KP + 2 * q
                    : nullptr;

  const int n_tiles = (P + kTile - 1) / kTile;
  int s = 0, since_flush = 0;
  if ((int)blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, s ^= 1) {
    if (tile + (int)gridDim.x < n_tiles) load_tile(tile + gridDim.x, s ^ 1);
    else cp_async_commit();  // an empty group keeps the count below uniform
    cp_async_wait<1>();      // this tile's stage has landed
    __syncthreads();         // ... for every thread; the last tile's products are done

    unsigned char* base = smem_raw + s * S::stage;
    const T* sg = reinterpret_cast<const T*>(base);
    const T* sa = reinterpret_cast<const T*>(base + S::g_bytes);
    const T* sf = reinterpret_cast<const T*>(base + S::g_bytes + S::a_bytes);
    const float* sx = reinterpret_cast<const float*>(base + S::g_bytes + S::a_bytes + S::f_bytes);

    // ---- build: x_d, then (planes) pair d's line operand and plane
    // scatter, one (chunk of 4 channels, point) a thread, point fastest
    if (tid < kTile) {
      xd_s[tid] = sx[tid * 3 + d];
    } else if constexpr (kPlanes) {
      if (tid < (1 + kChunks) * kTile) {
        const int pp = tid & 63, c0 = kChunks == 1 ? 0 : ((tid >> 6) - 1) * 4;
        const float x[3] = {sx[pp * 3 + 0], sx[pp * 3 + 1], sx[pp * 3 + 2]};
        float gi[4];
        load4(sg + pp * kout + K + d * KP + c0, gi);
        float gl[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float f_pl = to_f(sf[(c0 + c) * kRowIn + pp]);
          const float f_li = to_f(sf[(KP + c0 + c) * kRowIn + pp]);
          const float v = gi[c] * f_pl;  // the dL operand
          const bf16 v_hi = __float2bfloat16(v);
          v_s[(c0 + c) * kRow + pp] = v_hi;
          if constexpr (kSplit)
            vl_s[(c0 + c) * kRow + pp] = __float2bfloat16(v - __bfloat162float(v_hi));
          gl[c] = gi[c] * f_li;
        }
        if (c0 == 0) tw_s[pp] = __fmul_rn(x[pair_axis(axes, d, 2)], (float)(kTcRw - 1));
        if (tile * kTile + pp < P) {
          // dP_d[a, b, c0..c0+3] += hat_u[a] hat_v[b] g_d f_li
          const Taps tu = tent_taps(x[pair_axis(axes, d, 0)], ru);
          const Taps tv = tent_taps(x[pair_axis(axes, d, 1)], rv);
          float* p_i = dplanes + ((size_t)o * 3 + d) * ru * rv * KP + c0;
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
    for (int ws = warp; ws < K; ws += kWarps) {
      const int ch = (ws >> 3) * 8 + (lane & 7);
      const int p2 = ((ws & 7) * 4 + (lane >> 3)) * 2;
      float2 ae, af;
      if constexpr (kSplit) {
        ae = *reinterpret_cast<const float2*>(sa + ch * kRowIn + p2);
        af = *reinterpret_cast<const float2*>(sa + (K + ch) * kRowIn + p2);
      } else {
        ae = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sa + ch * kRowIn + p2));
        af = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sa + (K + ch) * kRowIn + p2));
      }
      const float u0 = to_f(sg[p2 * kout + ch]) * ae.x * af.x;
      const float u1 = to_f(sg[(p2 + 1) * kout + ch]) * ae.y * af.y;
      if constexpr (kSplit) {
        split_bf16x2(u0, u1, reinterpret_cast<uint32_t*>(u_s + ch * kRow + p2),
                     reinterpret_cast<uint32_t*>(ul_s + ch * kRow + p2));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(u_s + ch * kRow + p2) = __floats2bfloat162_rn(u0, u1);
      }
    }
    __syncthreads();

    // ---- products: dW_d[tile rows, :] += hat[rows, 64 points] u_d[64 points, :]
#pragma unroll
    for (int k16 = 0; k16 < kTile; k16 += 16) {
      const float2 x_lo = *reinterpret_cast<const float2*>(xd_s + k16 + 2 * q);
      const float2 x_hi = *reinterpret_cast<const float2*>(xd_s + k16 + 8 + 2 * q);
      uint32_t a[MT][4], al[kSplit ? MT : 1][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // t = x (r_l - 1), rounded and never fused, as the dense tent forms it
        const float sc = tr[m].scale;
        const float j0 = (float)(tr[m].j0 + grp);
        const float2 t_lo = make_float2(__fmul_rn(x_lo.x, sc), __fmul_rn(x_lo.y, sc));
        const float2 t_hi = make_float2(__fmul_rn(x_hi.x, sc), __fmul_rn(x_hi.y, sc));
        if constexpr (kSplit) hat_fragment_split(j0, t_lo, t_hi, a[m], al[m]);
        else hat_fragment(j0, t_lo, t_hi, a[m]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // four 8 x 8 blocks of u_d: channels 16 np + (0-7, 0-7, 8-15, 8-15),
        // points k16 + (0-7, 8-15, 0-7, 8-15); lane l gives row l % 8 of
        // block l / 8
        const int blk = lane >> 3;
        const int off = ((2 * np + (blk >> 1)) * 8 + (lane & 7)) * kRow + k16 + (blk & 1) * 8;
        uint32_t b[4], bl[4];
        ldmatrix_x4(u_s + off, b);
        if constexpr (kSplit) ldmatrix_x4(ul_s + off, bl);
#pragma unroll
        for (int m = 0; m < MT; ++m) {  // no branch: an unused slot multiplies zeros
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
      if constexpr (kPlanes) {
        if (lt < kLineTiles) {
          // dL_d[rows, 0-7] += hat_w[rows, points] (g_d f_pl)[points, 0-7]
          const float2 w_lo = *reinterpret_cast<const float2*>(tw_s + k16 + 2 * q);
          const float2 w_hi = *reinterpret_cast<const float2*>(tw_s + k16 + 8 + 2 * q);
          const int off = grp * kRow + k16 + 2 * q;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(v_s + off);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(v_s + off + 8);
          uint32_t aw[4];
          if constexpr (kSplit) {
            uint32_t awl[4];
            hat_fragment_split((float)(lt * 16 + grp), w_lo, w_hi, aw, awl);
            mma16816(lacc, aw, b0, b1);
            mma16816(lacc, aw, *reinterpret_cast<const uint32_t*>(vl_s + off),
                     *reinterpret_cast<const uint32_t*>(vl_s + off + 8));
            mma16816(lacc, awl, b0, b1);
          } else {
            hat_fragment((float)(lt * 16 + grp), w_lo, w_hi, aw);
            mma16816(lacc, aw, b0, b1);
          }
        }
      }
    }
    if (kSplit && ++since_flush == kFlushTiles) {
      since_flush = 0;
      flush_sums<KP>(acc, lacc, tr, dw_g, dl_g, grp, q);
    }
  }
  cp_async_wait<0>();
  flush_sums<KP>(acc, lacc, tr, dw_g, dl_g, grp, q);
}

// The per-axis forward (variant "per_axis"): the factors (and plane pair d
// in block d); with planes the caller then launches `cp_product`.
template <typename T, bool kPlanes>
int launch_fwd(const void* pts, const void* lines, const void* planes,
               const void* plines, void* out, void* afac, void* fpl, void* fli,
               const Ladder& lad, int O, int P, int K, int total_res, int ru,
               int rv, int kp, int rw, int axes, cudaStream_t stream) {
  const size_t smem = (size_t)total_res * odd_word_stride(K, sizeof(T)) * sizeof(T);
  dim3 grid;
  cudaError_t err = plan(unsnapped_fwd<T, kPlanes>, smem, O, P, 3, &grid);
  if (err != cudaSuccess) return (int)err;
  unsnapped_fwd<T, kPlanes><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)lines, (const T*)planes, (const T*)plines,
      (T*)out, (T*)afac, (T*)fpl, (T*)fli, lad, P, K, total_res, ru, rv, kp,
      rw, axes);
  return (int)cudaGetLastError();
}

// The three-axis forward: one wave of blocks over the flattened points; with
// kSplit, K / kc such waves side by side (blockIdx.y: the channel slice).
template <typename T, bool kPlanes, bool kStage, int kLv, bool kSplit>
int launch_fwd3(const void* pts, const void* lines, const void* planes,
                const void* plines, void* out, void* afac, void* fpl, void* fli,
                const Ladder& lad, int O, int P, int K, int total_res, int ru,
                int rv, int kp, int rw, int axes, int kc, cudaStream_t stream) {
  for (int l = 0; l < lad.n; ++l)
    if (lad.res[l] < 2) return (int)cudaErrorInvalidValue;  // tap_pair needs r >= 2
  if (!kSplit) kc = K;
  if (kc < 1 || K % kc != 0) return (int)cudaErrorInvalidValue;
  const int n_slices = K / kc;
  size_t smem = (size_t)3 * total_res * odd_word_stride(kc, sizeof(T)) * sizeof(T);
  if (kStage)
    smem = align16(smem) +
           (size_t)(kFwd3Threads / 32) * 32 * (kSplit ? kc : K + 3 * kp) * sizeof(T);
  const long long n_all = (long long)O * P;
  dim3 grid;
  // one object and z slice: the blocks the card holds at once, capped by
  // one block a kFwd3Threads points, for each channel slice
  cudaError_t err = plan(unsnapped_fwd3<T, kPlanes, kStage, kLv, kSplit>, smem, 1,
                         n_all > (1LL << 30) ? (1 << 30) : (int)n_all, n_slices, &grid,
                         kFwd3Threads, kFwd3Threads);
  if (err != cudaSuccess) return (int)err;
  long long span = (n_all + grid.x - 1) / grid.x;
  span = (span + 31) / 32 * 32;
  const int blocks = (int)((n_all + span - 1) / span);
  unsnapped_fwd3<T, kPlanes, kStage, kLv, kSplit>
      <<<dim3(blocks, n_slices), kFwd3Threads, smem, stream>>>(
      (const float*)pts, (const T*)lines, (const T*)planes, (const T*)plines,
      (T*)out, (T*)afac, (T*)fpl, (T*)fli, lad, O, P, K, total_res, ru, rv, kp, rw,
      axes, (int)span, kc);
  return (int)cudaGetLastError();
}

template <typename T, bool kPlanes, bool kStage, bool kSplit = false>
int launch_fwd3_levels(const void* pts, const void* lines, const void* planes,
                       const void* plines, void* out, void* afac, void* fpl, void* fli,
                       const Ladder& lad, int O, int P, int K, int total_res, int ru,
                       int rv, int kp, int rw, int axes, int kc, cudaStream_t stream) {
  if (lad.n == 6)
    return launch_fwd3<T, kPlanes, kStage, 6, kSplit>(pts, lines, planes, plines, out, afac,
                                                       fpl, fli, lad, O, P, K, total_res, ru,
                                                       rv, kp, rw, axes, kc, stream);
  return launch_fwd3<T, kPlanes, kStage, kMaxLevels, kSplit>(
      pts, lines, planes, plines, out, afac, fpl, fli, lad, O, P, K, total_res, ru, rv, kp,
      rw, axes, kc, stream);
}

// variant 0: "per_axis", 1: "three_axis_direct", 2: "three_axis_staged",
// 3: "channel_split" (slices of kc channels, staged)
template <bool kPlanes>
int dispatch_fwd(int dtype, int variant, const void* pts, const void* lines,
                 const void* planes, const void* plines, void* out, void* afac,
                 void* fpl, void* fli, const Ladder& lad, int O, int P, int K,
                 int total_res, int ru, int rv, int kp, int rw, int axes, int kc,
                 cudaStream_t s) {
#define ROMAP_ARGS pts, lines, planes, plines, out, afac, fpl, fli, lad, O, P, K, \
                   total_res, ru, rv, kp, rw, axes
  if (dtype == 0 && variant == 0) return launch_fwd<float, kPlanes>(ROMAP_ARGS, s);
  if (dtype == 1 && variant == 0) return launch_fwd<__nv_bfloat16, kPlanes>(ROMAP_ARGS, s);
  if (dtype == 0 && variant == 1)
    return launch_fwd3_levels<float, kPlanes, false>(ROMAP_ARGS, kc, s);
  if (dtype == 1 && variant == 1)
    return launch_fwd3_levels<__nv_bfloat16, kPlanes, false>(ROMAP_ARGS, kc, s);
  if (dtype == 0 && variant == 2)
    return launch_fwd3_levels<float, kPlanes, true>(ROMAP_ARGS, kc, s);
  if (dtype == 1 && variant == 2)
    return launch_fwd3_levels<__nv_bfloat16, kPlanes, true>(ROMAP_ARGS, kc, s);
  if (dtype == 0 && variant == 3)
    return launch_fwd3_levels<float, kPlanes, true, true>(ROMAP_ARGS, kc, s);
  if (dtype == 1 && variant == 3)
    return launch_fwd3_levels<__nv_bfloat16, kPlanes, true, true>(ROMAP_ARGS, kc, s);
#undef ROMAP_ARGS
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kPlanes>
int launch_bwd(const void* pts, const void* afac, const void* fpl,
               const void* fli, const void* g, void* dlines, void* dplanes,
               void* dplines, const Ladder& lad, int O, int P, int K,
               int total_res, int ru, int rv, int kp, int rw, int axes,
               cudaStream_t stream) {
  const size_t smem = ((size_t)total_res * odd_word_stride(K, 4) +
                       (size_t)rw * odd_word_stride(kp, 4)) * sizeof(float);
  dim3 grid;
  cudaError_t err = plan(unsnapped_bwd<T, kPlanes>, smem, O, P, 3, &grid);
  if (err != cudaSuccess) return (int)err;
  unsnapped_bwd<T, kPlanes><<<grid, kThreads, smem, stream>>>(
      (const float*)pts, (const T*)afac, (const T*)fpl, (const T*)fli,
      (const T*)g, (float*)dlines, (float*)dplanes, (float*)dplines, lad, P, K,
      total_res, ru, rv, kp, rw, axes);
  return (int)cudaGetLastError();
}

template <typename T, int kWarps, int MT, int NT, bool kPlanes, int KP = 4>
int launch_bwd_tc(const void* pts, const void* afac, const void* fpl,
                  const void* fli, const void* g, void* dlines, void* dplanes,
                  void* dplines, const Ladder& lad, int O, int P, int total_res,
                  int ru, int rv, int axes, cudaStream_t stream) {
  if (padded_tiles(lad) > kWarps * MT) return (int)cudaErrorInvalidValue;
  const size_t smem = UtcSmem<T, NT, kPlanes, KP>::total;
  dim3 grid;
  cudaError_t err = plan(unsnapped_bwd_tc<T, kWarps, MT, NT, kPlanes, KP>, smem, O, P, 3,
                         &grid, kWarps * 32, kTile);
  if (err != cudaSuccess) return (int)err;
  const int vec = P % 8 == 0 && aligned16(pts) && aligned16(afac) && aligned16(g) &&
                  aligned16(fpl) && aligned16(fli);
  unsnapped_bwd_tc<T, kWarps, MT, NT, kPlanes, KP><<<grid, kWarps * 32, smem, stream>>>(
      (const float*)pts, (const T*)afac, (const T*)fpl, (const T*)fli, (const T*)g,
      (float*)dlines, (float*)dplanes, (float*)dplines, lad, P, total_res, ru, rv, axes, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = launched); the launches are
// asynchronous on `stream`. `res` and `off` are host arrays of `n_levels`
// ints (the ladder's resolutions and row offsets), at most 8 levels.

// K3. `variant` is the caller's choice from the spec and dtype
// (mxgrid_cuda.py: `unsnapped_forward_variant`): 0 per_axis (the factors
// and planes only: the caller launches romap_mx_cp_product for out[:K]),
// 1 three_axis_direct, 2 three_axis_staged, 3 channel_split in slices of
// `kc` channels (K a multiple of it; read by variant 3 alone) (out written
// whole). A variant whose tables do not fit a block's shared memory
// returns an error.
int romap_mx_unsnapped_fwd(int dtype, int variant, const void* pts, const void* lines,
                           const void* planes, const void* plines, void* out,
                           void* afac, void* fpl, void* fli, const int* res,
                           const int* off, int n_levels, int O, int P, int K,
                           int total_res, int ru, int rv, int kp, int rw,
                           int axes, int kc, void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  return dispatch_fwd<true>(dtype, variant, pts, lines, planes, plines, out, afac, fpl,
                            fli, lad, O, P, K, total_res, ru, rv, kp, rw, axes, kc,
                            (cudaStream_t)stream);
}

// K3's product pass after its per-axis variant: out[o, p, :K] = A_0 A_1 A_2
// from afac [O, 3, K, P], in fp32, rounded once; out has kout columns.
int romap_mx_cp_product(int dtype, const void* afac, void* out, int O, int P, int K,
                        int kout, void* stream) {
  dim3 grid;
  cudaError_t err;
  if (dtype == 0) {
    if ((err = plan(cp_product<float>, 0, O, P, 1, &grid)) != cudaSuccess) return (int)err;
    cp_product<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)afac, (float*)out, P, K, kout);
  } else if (dtype == 1) {
    if ((err = plan(cp_product<__nv_bfloat16>, 0, O, P, 1, &grid)) != cudaSuccess)
      return (int)err;
    cp_product<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)afac, (__nv_bfloat16*)out, P, K, kout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4. dlines, dplanes and dplines must be zero-filled by the caller.
// `variant` is the caller's choice from the spec and dtype (mxgrid_cuda.py:
// `unsnapped_variant`: 0 scalar, 1 tensor cores in bf16, 2 tensor cores on
// fp32 split into bf16 hi and lo parts); a combination that is not
// instantiated returns cudaErrorInvalidValue. The tensor-core variants take
// rw = 128: at K = 48 with kp = 4 and a ladder of at most 32 padded 16-row
// tiles (the flagship's 465 rows pad to 31), and at K = 64 with kp = 8 and
// at most 40 (`quality`'s 580 rows pad to 39).
int romap_mx_unsnapped_bwd(int dtype, int variant, const void* pts, const void* afac,
                           const void* fpl, const void* fli, const void* g,
                           void* dlines, void* dplanes, void* dplines,
                           const int* res, const int* off, int n_levels, int O,
                           int P, int K, int total_res, int ru, int rv, int kp,
                           int rw, int axes, void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
#define ROMAP_ARGS pts, afac, fpl, fli, g, dlines, dplanes, dplines, lad, O, P, total_res, \
                   ru, rv, axes, s
  if (variant == 1) {
    if (dtype == 1 && K == 48 && kp == 4 && rw == kTcRw)
      return launch_bwd_tc<bf16, 16, 2, 6, true, 4>(ROMAP_ARGS);
    if (dtype == 1 && K == 64 && kp == 8 && rw == kTcRw)
      return launch_bwd_tc<bf16, 8, 5, 8, true, 8>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 2) {
    if (dtype == 0 && K == 48 && kp == 4 && rw == kTcRw)
      return launch_bwd_tc<float, 8, 4, 6, true, 4>(ROMAP_ARGS);
    if (dtype == 0 && K == 64 && kp == 8 && rw == kTcRw)
      return launch_bwd_tc<float, 8, 5, 8, true, 8>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#undef ROMAP_ARGS
  if (variant == 0 && dtype == 0)
    return launch_bwd<float, true>(pts, afac, fpl, fli, g, dlines, dplanes,
                                   dplines, lad, O, P, K, total_res, ru, rv,
                                   kp, rw, axes, s);
  if (variant == 0 && dtype == 1)
    return launch_bwd<__nv_bfloat16, true>(pts, afac, fpl, fli, g, dlines,
                                           dplanes, dplines, lad, O, P, K,
                                           total_res, ru, rv, kp, rw, axes, s);
  return (int)cudaErrorInvalidValue;
}

// K7: afac [O, 3, K, P] from the raw ladder lines alone; the three-axis
// variants (1, 2, 3) also write out [O, P, K] = (A_0 A_1) A_2 rounded to the
// table dtype after each factor (with per_axis, 0, the caller forms it);
// `kc` as for K3.
int romap_mx_unsnapped_cp_fwd(int dtype, int variant, const void* pts, const void* lines,
                              void* out, void* afac, const int* res, const int* off,
                              int n_levels, int O, int P, int K, int total_res, int kc,
                              void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  return dispatch_fwd<false>(dtype, variant, pts, lines, nullptr, nullptr, out, afac,
                             nullptr, nullptr, lad, O, P, K, total_res, 0, 0, 0, 0, 0, kc,
                             (cudaStream_t)stream);
}

// K8: dlines [O, 3, total_res, K] f32 (zero-filled by the caller) from afac
// and the CP cotangent g [O, P, K]. The tensor-core variants (1: bf16, 2:
// fp32 split) take K = 48 with at most 32 padded tiles (the flagship
// ladder) and K = 64 with at most 40 (the `fast` ladder: 580 rows pad to
// 624 = 39 tiles).
int romap_mx_unsnapped_cp_bwd(int dtype, int variant, const void* pts,
                              const void* afac, const void* g, void* dlines,
                              const int* res, const int* off, int n_levels, int O,
                              int P, int K, int total_res, void* stream) {
  Ladder lad;
  const int bad = make_ladder(res, off, n_levels, &lad);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
#define ROMAP_ARGS pts, afac, nullptr, nullptr, g, dlines, nullptr, nullptr, lad, O, P, \
                   total_res, 0, 0, 0, s
  if (variant == 1) {
    if (dtype == 1 && K == 48)
      return launch_bwd_tc<bf16, 16, 2, 6, false>(ROMAP_ARGS);
    if (dtype == 1 && K == 64)
      return launch_bwd_tc<bf16, 20, 2, 8, false>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 2) {
    if (dtype == 0 && K == 48)
      return launch_bwd_tc<float, 8, 4, 6, false>(ROMAP_ARGS);
    if (dtype == 0 && K == 64)
      return launch_bwd_tc<float, 8, 5, 8, false>(ROMAP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#undef ROMAP_ARGS
  if (variant == 0 && dtype == 0)
    return launch_bwd<float, false>(pts, afac, nullptr, nullptr, g, dlines,
                                    nullptr, nullptr, lad, O, P, K, total_res,
                                    0, 0, 0, 0, 0, s);
  if (variant == 0 && dtype == 1)
    return launch_bwd<__nv_bfloat16, false>(pts, afac, nullptr, nullptr, g,
                                            dlines, nullptr, nullptr, lad, O,
                                            P, K, total_res, 0, 0, 0, 0, 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
