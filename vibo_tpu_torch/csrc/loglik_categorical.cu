// One-pass training log-likelihood on the int8 response code for the
// polytomous families: the graded response model (GRM) and the generalized
// partial credit model (GPCM), one kernel templated on the family's cell.
//
// Replaces the TPU Pallas kernels
//   GRM   vibo_tpu/ops/pallas_grm.py _fused_train_fwd_grm (:198), body
//         _fused_train_kernel_grm (:101), tables _grm_tables (:80)
//   GPCM  vibo_tpu/ops/pallas_gpcm.py _fused_train_fwd_gpcm (:148), body
//         _fused_train_kernel_gpcm (:69)
// Both take theta (B, K) through its strides, a (M, K), the family's
// per-item table kappa (M, C-1) (GRM: the ordered thresholds, GPCM: the
// cumulative step sums) and the int8 code (0 = missing, 1 + category), and
// emit the per-person ll (B,), dtheta (B, K) and, as one (K + C - 1, M)
// array, da^T and dkappa^T: the value and every gradient of sum(ll) in one pass
// over the code. Per cell, with the code c: m = min(c, 1), r = max(c - 1, 0)
// (clamped to C - 1), base = theta_i . a_j, then the family's cell gives
// (ll, dbase) and adds its dkappa terms:
//   dtheta_i += dbase a_j,  da_j += dbase theta_i
//
// GRM (pallas_grm.py:14-30): base clamped to +-30; lo = kappa_r, hi =
// kappa_{r+1} (sentinels -50 and +50 at the boundary categories); x = base -
// lo, y = base - hi, e_x = exp(-|x|), e_y = exp(-|y|);
//   ll = m (min(x, 0) - log1p(e_x) - max(y, 0) - log1p(e_y) + log D_r)
// with D_r = -expm1(min(kappa_r - kappa_{r+1}, -1e-6)) (boundary rows 1),
// staged once per item and category. The four sigmoids in product form
// (e/(1+e) or 1/(1+e) by sign, never 1 - sigmoid):
//   dbase = m (s(-x) - s(y))
//   dkappa_r -= m s(-x) / max(s(-y) D, 1e-30)        (r >= 1)
//   dkappa_{r+1} += m s(y) / max(s(x) D, 1e-30)      (r <= C - 2)
// dbase is not zeroed beyond the clamp (the Pallas kernel's contract).
//
// GPCM (pallas_gpcm.py:14-22): z_c = c base - kappa_c (z_0 = 0), mx the
// largest z, e_c = exp(z_c - mx), s = sum_c e_c;
//   ll = m (z_r - mx - log s),  dbase = m (r - sum_c c e_c / s),
//   dkappa_c += m (e_c / s - [r = c])
// At C <= 8 (the usual Likert range; bench.py's C = 5) the category count
// is a template argument (LinkGPCMFixed): each z is computed once, the C
// exponentials stay in registers, the item's table comes in one or two
// 16-byte shared loads a cell, and each lane sums its items' dkappa in
// registers over its warp's students and writes them once a tile beside da,
// with no read-modify-write in shared memory a cell. At 9 <= C <= 32 the
// run-time path (LinkGPCM) takes C exponentials twice a cell (value, then
// dkappa: nothing is kept between) and adds dkappa into the warp's own
// slice of the reduce buffer, as GRM does.
//
// What bounds it on an H100, at B = 10,240, M = 1,024, K = 4, C = 5: the
// int8 code is 10.5 MB (~3.1 us at 3.35 TB/s), the f32 operations about
// 6K + 16C + 16 a cell (~19 us at 67 TFLOP/s); the special-function (MUFU)
// results: GRM two exp and four reciprocals a cell, GPCM C exp, a log and a
// reciprocal (chip_smoke.py counts them in this library's SASS).
//
// The design: loglik_tile.cuh's tile mapping and item split (64 students a
// block on one split's run of 64-item tiles, a warp 4 students, a lane 2
// consecutive items; the grid's second dimension is the split), with the
// tile's a and the family's table staged in shared memory in the lane-major
// slot order p * 32 + lane, so that a lane's gather by its own category
// never conflicts; a cell reads its item's a (and the compile-time-C
// table) in 16-byte loads. The next tile's codes, a and (compile-time C)
// kappa are loaded a tile ahead. dtheta and ll accumulate per student in
// shared slots across the split's tiles, da in registers per item; the
// tile's per-item sums over the 16 warps (two barriers a tile) are written
// as the block's partial, and the second pass (loglik_tile.cuh
// sum_rows_kernel) sums the partials over student blocks and splits in a
// fixed order: no float atomics, deterministic. The run-time links' dkappa
// slots are zeroed by the thread that reduces them, so a tile needs no
// barrier for that. Registers bound the blocks an SM holds: two of 16 warps
// (64 registers, no spill) for GRM up to K = 4 and the compile-time GPCM
// while K + C <= 9, one otherwise (chip_smoke.py prints ptxas's registers
// and the occupancy); the shared memory is dynamic and sized by C (up to
// ~220 KB at K = 8, C = 32, opted in above 48 KB).
// K = 1..8 are instantiated; any K > 8 runs the wide variant (run-time C),
// a pass a chunk of 8 ability dims (loglik_tile.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "loglik_tile.cuh"

namespace vibo {

struct LinkGRM {
  static constexpr int CF = 0;             // C is a run-time value
  static constexpr int NDK = 1;            // (no dkappa registers)
  static constexpr float BIG = 50.f;       // boundary-category sentinel
  static constexpr float CLAMP = 30.f;     // base saturation
  static constexpr float GAP = -1e-6f;     // kappa_r - kappa_{r+1} clamp

  __host__ __device__ static constexpr int min_blocks(int K) {
    return K <= 4 ? 2 : 1;
  }
  // staged floats a tile: thresholds kx (C + 1 rows, with the sentinels),
  // D (C) and log D (C), in C + 1 staging steps an item
  __host__ __device__ static int tab_floats(int C) { return (3 * C + 1) * TMI; }
  __host__ __device__ static int stage_steps(int C) { return C + 1; }

  // Staging step `row` (0..C) of item gj (-1: padding, all thresholds 0):
  // kx[row], and for row < C also D[row] and log D[row].
  __device__ __forceinline__ static void stage(float* tab, int sl,
                                               const float* kap, int gj,
                                               int C, int row) {
    auto kv = [&](int t) {  // threshold kappa_t, t in 1..C-1
      return gj >= 0 ? kap[static_cast<size_t>(gj) * (C - 1) + t - 1] : 0.f;
    };
    tab[row * TMI + sl] = row == 0 ? -BIG : row == C ? BIG : kv(row);
    if (row < C) {
      float d = 1.f, ld = 0.f;
      if (row >= 1 && row <= C - 2) {
        d = -expm1f(fminf(kv(row) - kv(row + 1), GAP));
        ld = logf(d);
      }
      tab[(C + 1 + row) * TMI + sl] = d;
      tab[(2 * C + 1 + row) * TMI + sl] = ld;
    }
  }

  // One cell: returns ll, sets dbase, adds the dkappa terms at
  // dkap[t * TMI] (threshold kappa_{t+1}); tab points at the item's slot.
  __device__ __forceinline__ static float cell(float dot, const float* tab,
                                               float mk, int r, int C,
                                               float* dkap, float& dbase) {
    const float base = fminf(fmaxf(dot, -CLAMP), CLAMP);
    const float x = base - tab[r * TMI];
    const float y = base - tab[(r + 1) * TMI];
    const float dd = tab[(C + 1 + r) * TMI];
    const float ld = tab[(2 * C + 1 + r) * TMI];
    const float ex = expf(-fabsf(x)), ey = expf(-fabsf(y));
    const float ll = mk * (fminf(x, 0.f) - log1pf(ex) - fmaxf(y, 0.f) -
                           log1pf(ey) + ld);
    const float invx = 1.f / (1.f + ex), invy = 1.f / (1.f + ey);
    const float sx = x >= 0.f ? invx : ex * invx;     // sigmoid(x)
    const float smx = x >= 0.f ? ex * invx : invx;    // sigmoid(-x)
    const float sy = y >= 0.f ? invy : ey * invy;     // sigmoid(y)
    const float smy = y >= 0.f ? ey * invy : invy;    // sigmoid(-y)
    dbase = mk * (smx - sy);
    if (mk != 0.f) {
      const float gx = mk * smx / fmaxf(smy * dd, 1e-30f);
      const float gy = mk * sy / fmaxf(sx * dd, 1e-30f);
      if (r >= 1) dkap[(r - 1) * TMI] -= gx;
      if (r <= C - 2) dkap[r * TMI] += gy;
    }
    return ll;
  }
};

// GPCM at a run-time C (9..32; any C in the wide variant).
struct LinkGPCM {
  static constexpr int CF = 0;
  static constexpr int NDK = 1;

  __host__ __device__ static constexpr int min_blocks(int) { return 1; }
  // staged rows a tile: kappa_0 = 0, kappa_1..C-1
  __host__ __device__ static int tab_floats(int C) { return C * TMI; }
  __host__ __device__ static int stage_steps(int C) { return C; }

  __device__ __forceinline__ static void stage(float* tab, int sl,
                                               const float* kap, int gj,
                                               int C, int row) {
    tab[row * TMI + sl] =
        row == 0 || gj < 0
            ? 0.f
            : kap[static_cast<size_t>(gj) * (C - 1) + row - 1];
  }

  __device__ __forceinline__ static float cell(float base, const float* tab,
                                               float mk, int r, int C,
                                               float* dkap, float& dbase) {
    float mx = 0.f, zr = 0.f;
#pragma unroll 1
    for (int c = 1; c < C; ++c) {
      const float z = static_cast<float>(c) * base - tab[c * TMI];
      mx = fmaxf(mx, z);
      zr = c == r ? z : zr;
    }
    float s = 0.f, ec = 0.f;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const float ev = expf(static_cast<float>(c) * base - tab[c * TMI] - mx);
      s += ev;
      ec += static_cast<float>(c) * ev;
    }
    const float inv = 1.f / s;
    dbase = mk * (static_cast<float>(r) - ec * inv);
    if (mk != 0.f) {
#pragma unroll 1
      for (int c = 1; c < C; ++c) {
        const float ev =
            expf(static_cast<float>(c) * base - tab[c * TMI] - mx);
        dkap[(c - 1) * TMI] += mk * (ev * inv - (c == r ? 1.f : 0.f));
      }
    }
    return mk * (zr - mx - logf(s));
  }
};

// GPCM at a compile-time C = CC (3..8): the table as CP floats a slot
// (kappa_1..CC-1, zero-padded to a multiple of 4), dkappa in registers.
template <int CC>
struct LinkGPCMFixed {
  static constexpr int CF = CC;
  static constexpr int NDK = CC - 1;
  static constexpr int CP = (CC - 1 + 3) / 4 * 4;

  __host__ __device__ static constexpr int min_blocks(int K) {
    return K + CC <= 9 ? 2 : 1;  // past it, 64 registers spill
  }
  __host__ __device__ static int tab_floats(int) { return CP * TMI; }

  // The tile's table (TMI x (CC - 1), prefetched by prefetch1 from kappa +
  // m0 * (CC - 1)) into CP floats a slot; the padding is never read into a
  // result.
  __device__ __forceinline__ static void store(float* tab, float v) {
    static_assert(TMI * (CC - 1) <= THREADS, "one kappa value a thread");
    const int i = threadIdx.x;
    if (i < TMI * (CC - 1))
      tab[slot_of(i / (CC - 1)) * CP + i % (CC - 1)] = v;
  }

  // tab points at the item's CP floats; dk: the item's dkappa sums.
  __device__ __forceinline__ static float cell(float base, const float* tab,
                                               float mk, int r,
                                               float (&dk)[NDK],
                                               float& dbase) {
    float kp[CP];
    load_consts<CP>(tab, kp);
    float z[CC];
    z[0] = 0.f;
    float mx = 0.f, zr = 0.f;
#pragma unroll
    for (int c = 1; c < CC; ++c) {
      z[c] = static_cast<float>(c) * base - kp[c - 1];
      mx = fmaxf(mx, z[c]);
      zr = c == r ? z[c] : zr;
    }
    float e[CC];
    float s = 0.f, ec = 0.f;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      e[c] = expf(z[c] - mx);
      s += e[c];
      ec += static_cast<float>(c) * e[c];
    }
    const float inv = 1.f / s;
    dbase = mk * (static_cast<float>(r) - ec * inv);
#pragma unroll
    for (int c = 1; c < CC; ++c)
      dk[c - 1] += mk * (e[c] * inv - (c == r ? 1.f : 0.f));
    return mk * (zr - mx - logf(s));
  }
};

// Slots a student's sums take in the shared accumulator (add_student): 32
// for the compile-time-C link, 16 for the run-time ones, whose reduce rows
// grow with C (K = 8, C = 32 fits the 227 KB a block may have only so).
template <class Link>
__host__ __device__ constexpr int acc_lanes() {
  return Link::CF > 0 ? 32 : 16;
}

template <class Link>
__host__ __device__ inline size_t smem_bytes(int K, int C) {
  return sizeof(float) *
         (static_cast<size_t>(TBS) * K + TMI * a_stride(K) +
          Link::tab_floats(C) +
          static_cast<size_t>(NWARP) * (K + C - 1) * TMI +
          static_cast<size_t>(TBS) * (K + 1) * acc_lanes<Link>());
}

}  // namespace vibo

namespace {

using vibo::IPT;
using vibo::NWARP;
using vibo::SPT;
using vibo::TBS;
using vibo::THREADS;
using vibo::TMI;

// WIDE: K = KC, one pass over the dims [k0, k0 + KC) of kt (loglik_tile.cuh);
// part keeps its (nblk, kt + C - 1, M) layout. Grid (student blocks, item
// splits); the split y covers the item tiles y * tps .. on.
template <class Link, int K, bool WIDE>
__global__ void __launch_bounds__(THREADS, Link::min_blocks(K))
loglik_categorical_kernel(const float* __restrict__ theta, long long th_sb,
                          long long th_sk, const float* __restrict__ a,
                          const float* __restrict__ kap,
                          const int8_t* __restrict__ pk,
                          float* __restrict__ part_dth,
                          float* __restrict__ part_llp,
                          float* __restrict__ part, int B, int M, int C_arg,
                          int tps, int kt_arg, int k0_arg) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool FIXED = Link::CF > 0;
  constexpr int LANES = vibo::acc_lanes<Link>();
  constexpr int KA = vibo::a_stride(K);
  const int C = FIXED ? Link::CF : C_arg;
  const int kt = WIDE ? kt_arg : K, k0 = WIDE ? k0_arg : 0;
  const bool first = k0 == 0;  // writes ll and dkappa
  const int NC = K + C - 1;  // reduced columns: da (K), dkappa (C - 1)
  const int NPC = kt + C - 1;  // the partial's columns
  float* tab_s = smem;                                 // the family's table
  float* th_s = tab_s + Link::tab_floats(C);           // TBS x K
  float* a_s = th_s + TBS * K;                         // KA floats a slot
  float* red_s = a_s + TMI * KA;                       // NWARP x NC x TMI
  float* acc_s = red_s + NWARP * NC * TMI;             // student sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS;
  const int split = blockIdx.y;
  const int t_end = min((split + 1) * tps, (M + TMI - 1) / TMI);
  const bool vec = (M % 2 == 0) && (reinterpret_cast<uintptr_t>(pk) % 2 == 0);
  const int j0 = lane * IPT;
  float* red_w = red_s + warp * NC * TMI;  // this warp's reduce rows
  float* acc_w = acc_s + warp * SPT * (K + 1) * LANES;
  const size_t blk = blockIdx.x;
  vibo::stage_theta<K>(th_s, theta, th_sb, th_sk, s0, B, k0, kt);
  if constexpr (!FIXED)  // dkappa slots start at 0; each reduce re-zeroes
    for (int i = tid; i < NWARP * NC * TMI; i += THREADS) red_s[i] = 0.f;
#pragma unroll
  for (int c = 0; c < SPT * (K + 1); ++c)
    if (lane < LANES) acc_w[c * LANES + lane] = 0.f;

  // tile t's codes (a word a student), a and (compile-time C) kappa, loaded
  // a tile ahead: the code streams from device memory and has the longest
  // latency
  uint32_t nxt[SPT];
  float pa = 0.f, pk_v = 0.f;
  auto prefetch = [&](int t) {
    const int m0 = t * TMI, n = min(TMI, M - m0);
#pragma unroll
    for (int q = 0; q < SPT; ++q)
      nxt[q] = vibo::load_code_pair(pk, s0 + warp * SPT + q, m0 + j0, B, M,
                                    vec);
    if constexpr (!WIDE) pa = vibo::prefetch1(a + static_cast<size_t>(m0) * K,
                                              n * K);
    if constexpr (FIXED)
      pk_v = vibo::prefetch1(kap + static_cast<size_t>(m0) * (C - 1),
                             n * (C - 1));
  };
  if (split * tps < t_end) prefetch(split * tps);

  for (int t = split * tps; t < t_end; ++t) {
    const int m0 = t * TMI;
    // the previous tile's cells are done (its second barrier): a_s and
    // tab_s are free; its reduce reads only red_s
    if constexpr (WIDE)
      vibo::stage_items<K>(a_s, a, m0, M, k0, kt);
    else
      vibo::store_items<K>(a_s, pa);
    if constexpr (FIXED) {
      Link::store(tab_s, pk_v);
    } else {
#pragma unroll 1
      for (int i = tid; i < Link::stage_steps(C) * TMI; i += THREADS) {
        const int row = i / TMI, j = i % TMI, gj = m0 + j;
        Link::stage(tab_s, vibo::slot_of(j), kap, gj < M ? gj : -1, C, row);
      }
    }
    uint32_t cur[SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) cur[q] = nxt[q];
    __syncthreads();  // staging visible; the previous reduce is done
    if (t + 1 < t_end) prefetch(t + 1);

    float da[IPT][K], dk[IPT][Link::NDK];
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
#pragma unroll
      for (int k = 0; k < K; ++k) da[p][k] = 0.f;
#pragma unroll
      for (int c = 0; c < Link::NDK; ++c) dk[p][c] = 0.f;
    }

#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int s = warp * SPT + q;
      float th[K], dq[K], lq = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        th[k] = th_s[s * K + k];
        dq[k] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float aj[K];
        vibo::load_consts<K>(a_s + (p * 32 + lane) * KA, aj);
        float dot = 0.f;
        if constexpr (WIDE) {
          const int gs = s0 + s, gj = m0 + j0 + p;
          if (gs < B && gj < M)
            dot = vibo::wide_dot(theta + gs * th_sb, th_sk,
                                 a + static_cast<size_t>(gj) * kt, kt);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) dot = fmaf(th[k], aj[k], dot);
        }
        const int code = vibo::code_at(cur[q], p);
        const float mk = fminf(static_cast<float>(code), 1.f);
        const int r = min(max(code - 1, 0), C - 1);
        const int sl = p * 32 + lane;
        float dbase;
        if constexpr (FIXED)
          lq += Link::cell(dot, tab_s + sl * Link::CP, mk, r, dk[p], dbase);
        else
          lq += Link::cell(dot, tab_s + sl, mk, r, C, red_w + K * TMI + sl,
                           dbase);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dq[k] = fmaf(dbase, aj[k], dq[k]);
          da[p][k] = fmaf(dbase, th[k], da[p][k]);
        }
      }
      vibo::add_student<K, LANES>(acc_w, q, dq, lq);
    }

#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      const int sl = p * 32 + lane;
#pragma unroll
      for (int k = 0; k < K; ++k) red_w[k * TMI + sl] = da[p][k];
      if constexpr (FIXED)
#pragma unroll
        for (int c = 0; c < Link::NDK; ++c)
          red_w[(K + c) * TMI + sl] = dk[p][c];
    }
    __syncthreads();  // every warp's sums visible; a_s and tab_s are free
    // (column, slot) pairs by the constant TMI (no division by the
    // run-time NC); slot sl is item (sl % 32) * IPT + sl / 32 of the tile
    for (int i = tid; i < TMI * NC; i += THREADS) {
      const int col = i / TMI, sl = i % TMI;
      const int gj = m0 + (sl % 32) * IPT + sl / 32;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        float* v = red_s + (w * NC + col) * TMI + sl;
        sum += *v;
        if constexpr (!FIXED)
          if (col >= K) *v = 0.f;  // the next tile adds into it
      }
      if (gj >= M) continue;
      // da column k0 + col of kt, or dkappa column kt + col - K (first pass)
      const int pc = col < K ? k0 + col : kt + col - K;
      if (col < K ? pc < kt : first) part[(blk * NPC + pc) * M + gj] = sum;
    }
  }

  __syncwarp();  // acc_w is this warp's own
  vibo::write_dtheta_ll<K, LANES>(acc_w, s0 + warp * SPT, B, part_dth,
                                  first ? part_llp : nullptr, k0, kt);
}

template <class Link, int K, bool WIDE = false>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(
      loglik_categorical_kernel<Link, K, WIDE>);
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch(const float* theta, long long th_sb, long long th_sk,
                   const float* a, const float* kap, const int8_t* pk,
                   float* part_dth, float* part_llp, float* part, int nblk,
                   int nsplit, int tps, int B, int M, int C,
                   cudaStream_t stream, int kt = K, int k0 = 0) {
  const size_t smem = vibo::smem_bytes<Link>(K, C);
  auto kernel = loglik_categorical_kernel<Link, K, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nblk, nsplit), THREADS, smem, stream>>>(
      theta, th_sb, th_sk, a, kap, pk, part_dth, part_llp, part, B, M, C, tps,
      kt, k0);
  return cudaGetLastError();
}

// The launch arguments every path passes through.
struct Args {
  const float* t;
  long long th_sb, th_sk;
  const float* av;
  const float* kv;
  const int8_t* p;
  float *pt, *pp, *part;
  int nblk, nsplit, tps, B, M, C;
  cudaStream_t stream;
};

// K = 1..8 of one link.
template <class Link>
cudaError_t launch_k(const Args& g, int K) {
  switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    return launch<Link, KK>(g.t, g.th_sb, g.th_sk, g.av, g.kv, g.p, g.pt,   \
                            g.pp, g.part, g.nblk, g.nsplit, g.tps, g.B, g.M, \
                            g.C, g.stream);
    VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
    VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
  }
  return cudaErrorInvalidValue;
}

// The K > 8 passes of a run-time-C link, one a chunk of KC dims.
template <class Link>
cudaError_t launch_wide(const Args& g, int K) {
  cudaError_t err = cudaSuccess;
  for (int k0 = 0; k0 < K && err == cudaSuccess; k0 += vibo::KC)
    err = launch<Link, vibo::KC, true>(g.t, g.th_sb, g.th_sk, g.av, g.kv, g.p,
                                       g.pt, g.pp, g.part, g.nblk, g.nsplit,
                                       g.tps, g.B, g.M, g.C, g.stream, K, k0);
  return err;
}

// The GPCM path of (K, C): the compile-time-C link at C <= 8 and K <= 8.
cudaError_t launch_gpcm(const Args& g, int K) {
  if (K > 8) return launch_wide<vibo::LinkGPCM>(g, K);
  switch (g.C) {
    case 3: return launch_k<vibo::LinkGPCMFixed<3>>(g, K);
    case 4: return launch_k<vibo::LinkGPCMFixed<4>>(g, K);
    case 5: return launch_k<vibo::LinkGPCMFixed<5>>(g, K);
    case 6: return launch_k<vibo::LinkGPCMFixed<6>>(g, K);
    case 7: return launch_k<vibo::LinkGPCMFixed<7>>(g, K);
    case 8: return launch_k<vibo::LinkGPCMFixed<8>>(g, K);
    default: return launch_k<vibo::LinkGPCM>(g, K);
  }
}

cudaError_t launch_grm(const Args& g, int K) {
  return K > 8 ? launch_wide<vibo::LinkGRM>(g, K)
               : launch_k<vibo::LinkGRM>(g, K);
}

int entry(bool gpcm, const void* theta, long long th_sb, long long th_sk,
          const void* a, const void* kap, const void* pk, void* dtheta,
          long long dt_sb, long long dt_sk, void* ll_person, void* part_dth,
          void* part_llp, void* part, void* grads, int B, int M, int K, int C,
          int nblk, int nsplit, int tps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!vibo::check_plan(B, M, nblk, nsplit, tps) || C < 3 || C > 32 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* pt = static_cast<float*>(part_dth);
  float* pp = static_cast<float*>(part_llp);
  float* pr = static_cast<float*>(part);
  if (nblk > 0) {
    const Args g{static_cast<const float*>(theta), th_sb, th_sk,
                 static_cast<const float*>(a), static_cast<const float*>(kap),
                 static_cast<const int8_t*>(pk), pt, pp, pr, nblk, nsplit, tps,
                 B, M, C, stream};
    const cudaError_t err = gpcm ? launch_gpcm(g, K) : launch_grm(g, K);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // second pass: [da^T | dkappa^T] over the student blocks; dtheta and
  // ll_person over the splits
  const vibo::SumSeg segs[] = {
      {pr, static_cast<float*>(grads), static_cast<long long>(M) * (K + C - 1),
       nblk, 1, 1, 0},
      {pt, static_cast<float*>(dtheta), static_cast<long long>(B) * K, nsplit,
       K, dt_sb, dt_sk},
      {pp, static_cast<float*>(ll_person), B, nsplit, 1, 1, 0}};
  return static_cast<int>(vibo::launch_sum_rows(segs, 3, stream));
}

// The kernel a (family, K, C) call launches first, and its shared memory.
const void* kernel_of(bool gpcm, int K, int C, size_t* smem) {
  const bool wide = K > 8;
  const int kk = wide ? vibo::KC : K;
  if (gpcm && !wide && C <= 8) {
    switch (C * 16 + K) {
#define VIBO_FIXED(CC, KK)                                              \
  case CC * 16 + KK:                                                    \
    *smem = vibo::smem_bytes<vibo::LinkGPCMFixed<CC>>(KK, CC);          \
    return kernel_ptr<vibo::LinkGPCMFixed<CC>, KK>();
#define VIBO_FIXED_C(CC)                                                \
  VIBO_FIXED(CC, 1) VIBO_FIXED(CC, 2) VIBO_FIXED(CC, 3) VIBO_FIXED(CC, 4) \
  VIBO_FIXED(CC, 5) VIBO_FIXED(CC, 6) VIBO_FIXED(CC, 7) VIBO_FIXED(CC, 8)
      VIBO_FIXED_C(3) VIBO_FIXED_C(4) VIBO_FIXED_C(5)
      VIBO_FIXED_C(6) VIBO_FIXED_C(7) VIBO_FIXED_C(8)
#undef VIBO_FIXED_C
#undef VIBO_FIXED
    }
    return nullptr;
  }
  *smem = gpcm ? vibo::smem_bytes<vibo::LinkGPCM>(kk, C)
               : vibo::smem_bytes<vibo::LinkGRM>(kk, C);
  if (wide)
    return gpcm ? kernel_ptr<vibo::LinkGPCM, vibo::KC, true>()
                : kernel_ptr<vibo::LinkGRM, vibo::KC, true>();
  switch (K) {
#define VIBO_RT(KK)                                                    \
  case KK:                                                             \
    return gpcm ? kernel_ptr<vibo::LinkGPCM, KK>()                     \
                : kernel_ptr<vibo::LinkGRM, KK>();
    VIBO_RT(1) VIBO_RT(2) VIBO_RT(3) VIBO_RT(4)
    VIBO_RT(5) VIBO_RT(6) VIBO_RT(7) VIBO_RT(8)
#undef VIBO_RT
  }
  return nullptr;
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// theta/dtheta: f32 at theta[i*th_sb + k*th_sk]; a (M, K) and kappa
// (M, C-1) f32 contiguous (GRM: the ordered thresholds); pk (B, M) int8
// contiguous; ll_person (B,). The plan (nblk, nsplit, tps) of
// ops/one_pass.py split_plan, checked here (loglik_tile.cuh check_plan) so a
// mismatch is refused instead of overrunning the scratch: part_dth
// (nsplit, B, K), part_llp (nsplit, B), part (nblk, K + C - 1, M); output
// grads (K + C - 1, M) = [da^T | dkappa^T]. 3 <= C <= 32, K >= 1 (K > 8 in
// passes of 8 dims).
int loglik_grm_train(const void* theta, long long th_sb, long long th_sk,
                     const void* a, const void* kappa, const void* pk,
                     void* dtheta, long long dt_sb, long long dt_sk,
                     void* ll_person, void* part_dth, void* part_llp,
                     void* part, void* grads, int B, int M, int K, int C,
                     int nblk, int nsplit, int tps, void* stream_ptr) {
  return entry(false, theta, th_sb, th_sk, a, kappa, pk, dtheta, dt_sb, dt_sk,
               ll_person, part_dth, part_llp, part, grads, B, M, K, C, nblk,
               nsplit, tps, stream_ptr);
}

// As loglik_grm_train, with kappa the GPCM cumulative step sums.
int loglik_gpcm_train(const void* theta, long long th_sb, long long th_sk,
                      const void* a, const void* kappa, const void* pk,
                      void* dtheta, long long dt_sb, long long dt_sk,
                      void* ll_person, void* part_dth, void* part_llp,
                      void* part, void* grads, int B, int M, int K, int C,
                      int nblk, int nsplit, int tps, void* stream_ptr) {
  return entry(true, theta, th_sb, th_sk, a, kappa, pk, dtheta, dt_sb, dt_sk,
               ll_person, part_dth, part_llp, part, grads, B, M, K, C, nblk,
               nsplit, tps, stream_ptr);
}

// Registers, local (spill) bytes and blocks an SM of the kernel a (family,
// K, C) call launches first (family 0: GRM, 1: GPCM), into out[0..2].
int loglik_categorical_occupancy(int family, int K, int C, int* out) {
  size_t smem = 0;
  const void* fn = kernel_of(family == 1, K, C, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(err);
}

}  // extern "C"
