// One-pass training log-likelihood on the int8 response code, for the 2PL
// and the 3PL link (irt_links.cuh).
//
// Replaces the TPU Pallas kernels of vibo_tpu/ops/pallas_elbo.py:
//   2PL  _fused_train_fwd_t (:1244), body _fused_train_kernel_packed_t
//        (:1183): theta^T (K, B) -> scalar sum of ll, dtheta^T, da, db
//        _fused_train_fwd (:613), body _fused_train_kernel_packed (:569):
//        theta (B, K) -> per-person ll (B,), dtheta, da, db
//   3PL  _fused_train_fwd_3pl_t (:1374), body
//        _fused_train_kernel_3pl_packed_t (:1325), and _fused_train_fwd_3pl
//        (:741), body _fused_train_kernel_3pl_packed (:700): the same, plus
//        dg_hat (M,)
// One source serves both layouts: theta and dtheta are addressed through
// explicit (student, ability) strides. Per cell, with the code c
// (0 = missing, 1 = wrong, 2 = right): m = min(c, 1), r = max(c - 1, 0),
//   l = theta . a_j - b_j, (ll, dl[, dg]) from the link's cell
//   dtheta_i += dl a_j,  da_j += dl theta_i,  db_j -= dl  [, dg_j += dg]
//
// What bounds it on an H100, at B = 10,240, M = 1,024, K = 4: it must read
// the B*M int8 code once (10.5 MB, ~3.1 us at 3.35 TB/s) and do 6K+16 f32
// operations a cell (~6.3 us at 67 TFLOP/s) for 2PL, about 6K+45 for 3PL;
// the 2PL cell takes two special-function (MUFU) results (exp, and the
// reciprocal of 1 + e), the 3PL cell about twice as many (two exp, two
// reciprocals and a log's), which run on the SM's special-function unit at
// 16 a clock: chip_smoke.py counts them in this library's SASS and takes the
// largest of the three times (for 2PL the function's two, whatever the
// kernel issues).
//
// The mapping every kernel here shares: the tile mapping and item split of
// loglik_tile.cuh (a block owns 64 students and one split's run of 64-item
// tiles; a warp takes 4 students, a lane 2 consecutive items; the grid's
// second dimension is the split, sized so the flagship gets 640 blocks, two
// of 16 warps resident an SM up to K = 4). The block's theta is staged
// once; the next tile's codes and raw item data are loaded a tile ahead
// into registers, so the code's latency from device memory hides behind the
// cells. The per-item da/db(/dg) of a tile are summed over the block's 16
// warps in shared memory and written as the block's partial; each
// student's dtheta and ll are summed over the lanes by warp shuffles once
// at the end into the split's partial. The second pass (loglik_tile.cuh
// sum_rows_kernel) sums the partials over student blocks and splits in a
// fixed order, so every output is deterministic.
//
// 3PL (loglik_train_kernel): the tile's a and the link's per-item
// constants (b, log g, log(1-g) and g, computed once per item here and not
// once per cell) are staged in shared memory in the lane-major slot order
// and read by each cell in 16-byte loads, so they hold no registers
// between cells; dtheta and ll accumulate in lane-private shared slots,
// added once a tile; two barriers a tile (staging visible; per-warp sums
// visible). What bounds it is the register file and the cell's special
// functions: up to K = 4 it is held to 64 registers with no spill.
//
// 2PL (loglik_2pl_kernel, K = 1..8): the cell is small (about 37
// instructions at K = 4), so what a tile costs around it mattered most. The
// cell computes exp(-|l|), 1/(1 + e) and log1p(e) = log2(1 + e) ln 2 with
// the special-function unit's approximations (ex2, rcp, lg2: three MUFU
// and no division or log1p polynomial); a lane's 2 items' a and b are read
// into registers once a tile and reused over its 4 students; dtheta and ll
// stay in registers across the split's tiles; one barrier a tile, with the
// item staging and the reduce rows double buffered and tile t - 1's column
// sums run after tile t's barrier; interior tiles load their codes without
// bounds checks. At K = 4 it fills the 64 registers with no spill. What
// holds it back now is latency around the one barrier a tile, with 32
// warps an SM, and the MUFU pipe's three results a cell (an estimate from
// the code; no profiler counter says).
//
// K = 1..8 are instantiated; any K > 8 runs the wide variant of
// loglik_train_kernel, a pass a chunk of 8 ability dims (loglik_tile.cuh),
// for both links.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "irt_links.cuh"
#include "loglik_tile.cuh"

namespace {

using vibo::IPT;
using vibo::Link2PL;
using vibo::Link3PL;
using vibo::NWARP;
using vibo::SPT;
using vibo::TBS;
using vibo::THREADS;
using vibo::TMI;

// Shared memory of the (Link, K) kernel, in floats: the per-item constants
// (first, 16-byte aligned), theta, a, the reduce rows, the students'
// lane-private sums and the warps' ll.
template <class Link, int K>
constexpr int smem_floats() {
  return TMI * Link::NP + TBS * K + TMI * vibo::a_stride(K) +
         NWARP * (K + 1 + Link::NX) * TMI + TBS * (K + 1) * 32 + NWARP;
}

// WIDE: K = KC, one pass over the dims [k0, k0 + KC) of kt (loglik_tile.cuh).
// Grid (student blocks, item splits); the split y covers the item tiles
// y * tps .. min((y + 1) * tps, tiles) - 1.
template <class Link, int K, bool WIDE>
__global__ void __launch_bounds__(THREADS, vibo::min_blocks<K>())
loglik_train_kernel(const float* __restrict__ theta, long long th_sb,
                    long long th_sk, const float* __restrict__ a,
                    const float* __restrict__ b,
                    const float* __restrict__ gh,
                    const int8_t* __restrict__ pk,
                    float* __restrict__ part_dth, float* __restrict__ part_llp,
                    float* __restrict__ part_da, float* __restrict__ part_db,
                    float* __restrict__ part_dg, float* __restrict__ part_ll,
                    int B, int M, int tps, int kt_arg, int k0_arg) {
  constexpr int NP = Link::NP;
  const int kt = WIDE ? kt_arg : K, k0 = WIDE ? k0_arg : 0;
  const bool first = k0 == 0;  // writes ll, db and dg
  constexpr int NC = K + 1 + Link::NX;  // reduced columns: da, db[, dg]
  constexpr int KA = vibo::a_stride(K);
  extern __shared__ __align__(16) float smem[];
  float* p_s = smem;                          // NP constants a slot
  float* th_s = p_s + TMI * NP;               // TBS x K
  float* a_s = th_s + TBS * K;                // KA floats a slot
  float* red_s = a_s + TMI * KA;              // warp, column, slot
  float* acc_s = red_s + NWARP * NC * TMI;    // lane-private student sums
  float* ll_s = acc_s + TBS * (K + 1) * 32;   // a warp's ll

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS;
  const int split = blockIdx.y;
  const int t_end = min((split + 1) * tps, (M + TMI - 1) / TMI);
  const bool vec = (M % 2 == 0) && (reinterpret_cast<uintptr_t>(pk) % 2 == 0);
  const int j0 = lane * IPT;
  float* red_w = red_s + warp * NC * TMI;
  float* acc_w = acc_s + warp * SPT * (K + 1) * 32;
  const size_t blk = blockIdx.x;

  vibo::stage_theta<K>(th_s, theta, th_sb, th_sk, s0, B, k0, kt);
#pragma unroll
  for (int c = 0; c < SPT * (K + 1); ++c) acc_w[c * 32 + lane] = 0.f;

  // tile t's codes (a word a student) and raw item data, loaded a tile
  // ahead: the code streams from device memory and has the longest latency
  uint32_t nxt[SPT];
  float pa = 0.f, pb = 0.f, pg = 0.f;
  auto prefetch = [&](int t) {
    const int m0 = t * TMI, n = min(TMI, M - m0);
#pragma unroll
    for (int q = 0; q < SPT; ++q)
      nxt[q] = vibo::load_code_pair(pk, s0 + warp * SPT + q, m0 + j0, B, M,
                                    vec);
    if constexpr (!WIDE) pa = vibo::prefetch1(a + static_cast<size_t>(m0) * K,
                                              n * K);
    pb = vibo::prefetch1(b + m0, n);
    if constexpr (Link::NX > 0) pg = vibo::prefetch1(gh + m0, n);
  };
  if (split * tps < t_end) prefetch(split * tps);

  for (int t = split * tps; t < t_end; ++t) {
    const int m0 = t * TMI;
    // the previous tile's cells are done (its second barrier): a_s and p_s
    // are free; its reduce reads only red_s
    if constexpr (WIDE)
      vibo::stage_items<K>(a_s, a, m0, M, k0, kt);
    else
      vibo::store_items<K>(a_s, pa);
    if (tid < TMI) {
      float p[NP];
      Link::stage(pb, pg, p);
#pragma unroll
      for (int x = 0; x < NP; ++x) p_s[vibo::slot_of(tid) * NP + x] = p[x];
    }
    uint32_t cur[SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) cur[q] = nxt[q];
    __syncthreads();  // staging visible; the previous reduce is done
    if (t + 1 < t_end) prefetch(t + 1);

    float da[IPT][K], db[IPT], dx[IPT];
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      db[p] = 0.f;
      dx[p] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) da[p][k] = 0.f;
    }

#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int s = warp * SPT + q, gs = s0 + s;
      float th[K], dq[K], lq = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        th[k] = th_s[s * K + k];
        dq[k] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float pj[NP], aj[K];
        vibo::load_consts<NP>(p_s + (p * 32 + lane) * NP, pj);
        vibo::load_consts<K>(a_s + (p * 32 + lane) * KA, aj);
        float dot = 0.f;
        if constexpr (WIDE) {
          const int gj = m0 + j0 + p;
          if (gs < B && gj < M)
            dot = vibo::wide_dot(theta + gs * th_sb, th_sk,
                                 a + static_cast<size_t>(gj) * kt, kt);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) dot = fmaf(th[k], aj[k], dot);
        }
        const float l = dot - pj[0];
        const float c = static_cast<float>(vibo::code_at(cur[q], p));
        const float mk = fminf(c, 1.f), r = fmaxf(c - 1.f, 0.f);
        float dl, dxc;
        lq += Link::train(l, pj, mk, r, dl, dxc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dq[k] = fmaf(dl, aj[k], dq[k]);
          da[p][k] = fmaf(dl, th[k], da[p][k]);
        }
        db[p] -= dl;
        if constexpr (Link::NX > 0) dx[p] += dxc;
      }
      vibo::add_student<K>(acc_w, q, dq, lq);
    }

#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      const int sl = p * 32 + lane;
#pragma unroll
      for (int k = 0; k < K; ++k) red_w[k * TMI + sl] = da[p][k];
      red_w[K * TMI + sl] = db[p];
      if constexpr (Link::NX > 0) red_w[(K + 1) * TMI + sl] = dx[p];
    }
    __syncthreads();  // every warp's sums visible; a_s and p_s are free
    // (column, slot) pairs by the constant TMI; slot sl is item
    // (sl % 32) * IPT + sl / 32 of the tile
    for (int i = tid; i < TMI * NC; i += THREADS) {
      const int col = i / TMI, sl = i % TMI;
      const int gj = m0 + (sl % 32) * IPT + sl / 32;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red_s[(w * NC + col) * TMI + sl];
      if (col < K) {
        if (k0 + col < kt) part_da[(blk * M + gj) * kt + k0 + col] = sum;
      } else if (!first) {
        continue;
      } else if (col == K) {
        part_db[blk * M + gj] = sum;
      } else {
        part_dg[blk * M + gj] = sum;
      }
    }
  }

  // acc_w is this warp's own: its lanes' adds precede these reads
  __syncwarp();
  const float ll_warp = vibo::write_dtheta_ll<K>(
      acc_w, s0 + warp * SPT, B, part_dth, first ? part_llp : nullptr, k0,
      kt);
  if (!first) return;  // the whole block leaves: no barrier follows
  if (lane == 0) ll_s[warp] = ll_warp;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < NWARP; ++w) sum += ll_s[w];
    part_ll[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = sum;
  }
}

// ------------------------------------------------------- the 2PL kernel
//
// K = 1..8 of the 2PL link (the wide variant stays on loglik_train_kernel):
// the same grid, tile mapping and scratch as loglik_train_kernel, with the
// cheaper tile of the header comment.

// One 2PL training cell of the code c (0 missing, 1 wrong, 2 right) at the
// logit l: adds its ll to lq and returns dl. With e = exp(-|l|) in (0, 1]:
// sigmoid(l) and 1 - sigmoid(l) are 1/(1+e) and e/(1+e), and
// log1p(e) = log2(1 + e) ln 2, where 1 + e lies in [1, 2] and lg2.approx is
// within ~1e-7 absolute, so each term is as close as the precise functions
// would be to f32 (an ll sum's relative error ~2e-7, its gradient's ~1e-6).
// ll = -(log1p(e) + max(s, 0)), s = l wrong or -l right. A missing cell
// gives exactly 0 (selects, not products).
__device__ __forceinline__ float cell_2pl(float l, int c, float& lq) {
  using vibo::LN2;
  using vibo::LOG2E;
  const float e = vibo::ex2_approx(fabsf(l) * -LOG2E);
  const float ope = 1.f + e;
  const float big = vibo::rcp_approx(ope), small = e * big;
  const bool pos = l >= 0.f, right = c == 2;
  const float s = right ? -l : l;
  const float ll = -fmaf(vibo::lg2_approx(ope), LN2, fmaxf(s, 0.f));
  // right: 1 - sigmoid(l); wrong: -sigmoid(l)
  const float dl = right ? (pos ? small : big) : -(pos ? big : small);
  lq += c != 0 ? ll : 0.f;
  return c != 0 ? dl : 0.f;
}

// Shared memory of the 2PL kernel, in floats: two buffers of the tile's a
// (a_stride(K) a slot) and b, theta, two buffers of reduce rows, the warps'
// ll.
template <int K>
constexpr int smem_floats_2pl() {
  return 2 * TMI * (vibo::a_stride(K) + 1) + TBS * K +
         2 * NWARP * (K + 1) * TMI + NWARP;
}

// Grid, scratch and plan as loglik_train_kernel's (not WIDE).
template <int K>
__global__ void __launch_bounds__(THREADS, vibo::min_blocks<K>())
loglik_2pl_kernel(const float* __restrict__ theta, long long th_sb,
                  long long th_sk, const float* __restrict__ a,
                  const float* __restrict__ b,
                  const int8_t* __restrict__ pk,
                  float* __restrict__ part_dth, float* __restrict__ part_llp,
                  float* __restrict__ part_da, float* __restrict__ part_db,
                  float* __restrict__ part_ll, int B, int M, int tps) {
  constexpr int KA = vibo::a_stride(K), NC = K + 1;
  constexpr int ITEM_BUF = TMI * (KA + 1);  // a slots, then b
  constexpr int RED_BUF = NWARP * NC * TMI;
  extern __shared__ __align__(16) float smem[];
  float* item_s = smem;                       // 2 x ITEM_BUF
  float* th_s = item_s + 2 * ITEM_BUF;        // TBS x K
  float* red_s = th_s + TBS * K;              // 2 x RED_BUF
  float* ll_s = red_s + 2 * RED_BUF;          // a warp's ll

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS, s_warp = s0 + warp * SPT;
  const int split = blockIdx.y;
  const int t0 = split * tps, t_end = min(t0 + tps, (M + TMI - 1) / TMI);
  const bool vec = (M % 2 == 0) && (reinterpret_cast<uintptr_t>(pk) % 2 == 0);
  const int j0 = lane * IPT;
  const size_t blk = blockIdx.x;

  // the column sums over the 16 warps of one tile's reduce rows: the
  // block's partial da and db of the tile's items
  auto reduce = [&](int t) {
    const float* red = red_s + (t & 1) * RED_BUF;
    const int m0 = t * TMI;
    for (int i = tid; i < TMI * NC; i += THREADS) {
      const int col = i / TMI, sl = i % TMI;
      const int gj = m0 + (sl % 32) * IPT + sl / 32;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red[(w * NC + col) * TMI + sl];
      if (col < K)
        part_da[(blk * M + gj) * K + col] = sum;
      else
        part_db[blk * M + gj] = sum;
    }
  };

  // tile t's codes, two students a word (byte 2q + p of word q / 2 is
  // student q's item p), and its raw a and b, loaded a tile ahead
  uint32_t nxt[SPT / 2];
  float pa = 0.f, pb = 0.f;
  const bool full_rows = vec && s0 + TBS <= B;
  auto prefetch = [&](int t) {
    const int m0 = t * TMI, n = min(TMI, M - m0);
    if (full_rows && m0 + TMI <= M) {  // block-uniform: no bounds to check
      const uint16_t* w = reinterpret_cast<const uint16_t*>(
          pk + static_cast<size_t>(s_warp) * M + m0 + j0);
      const size_t row = M / 2;
#pragma unroll
      for (int h = 0; h < SPT / 2; ++h)
        nxt[h] = w[2 * h * row] |
                 static_cast<uint32_t>(w[(2 * h + 1) * row]) << 16;
    } else {
#pragma unroll
      for (int h = 0; h < SPT / 2; ++h)
        nxt[h] =
            vibo::load_code_pair(pk, s_warp + 2 * h, m0 + j0, B, M, vec) |
            vibo::load_code_pair(pk, s_warp + 2 * h + 1, m0 + j0, B, M, vec)
                << 16;
    }
    pa = vibo::prefetch1(a + static_cast<size_t>(m0) * K, n * K);
    pb = vibo::prefetch1(b + m0, n);
  };
  // the first tile's loads are in flight while theta is staged
  if (t0 < t_end) prefetch(t0);
  vibo::stage_theta<K>(th_s, theta, th_sb, th_sk, s0, B);

  float dth[SPT][K], lq[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    lq[q] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dth[q][k] = 0.f;
  }

#pragma unroll 1
  for (int t = t0; t < t_end; ++t) {
    // buffer t & 1 was last read by tile t - 2's cells, before the
    // previous barrier
    float* it = item_s + (t & 1) * ITEM_BUF;
    vibo::store_items<K>(it, pa);
    if (tid < TMI) it[TMI * KA + vibo::slot_of(tid)] = pb;
    uint32_t cur[SPT / 2];
#pragma unroll
    for (int h = 0; h < SPT / 2; ++h) cur[h] = nxt[h];
    __syncthreads();  // tile t's items visible; tile t - 1's rows written
    if (t + 1 < t_end) prefetch(t + 1);
    if (t > t0) reduce(t - 1);

    float aj[IPT][K], bj[IPT];
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      const int sl = p * 32 + lane;
#pragma unroll
      for (int k = 0; k < K; ++k) aj[p][k] = it[sl * KA + k];
      bj[p] = it[TMI * KA + sl];
    }
    float da[IPT][K], db[IPT];
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      db[p] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) da[p][k] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int s = warp * SPT + q;
      float th[K];
#pragma unroll
      for (int k = 0; k < K; ++k) th[k] = th_s[s * K + k];
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float l = -bj[p];
#pragma unroll
        for (int k = 0; k < K; ++k) l = fmaf(th[k], aj[p][k], l);
        const int c = (cur[q / 2] >> (16 * (q % 2) + 8 * p)) & 0xff;
        const float dl = cell_2pl(l, c, lq[q]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dth[q][k] = fmaf(dl, aj[p][k], dth[q][k]);
          da[p][k] = fmaf(dl, th[k], da[p][k]);
        }
        db[p] -= dl;
      }
    }
    // buffer t & 1 of the rows was last read by tile t - 2's reduce,
    // before this tile's barrier
    float* red_w = red_s + (t & 1) * RED_BUF + warp * NC * TMI;
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      const int sl = p * 32 + lane;
#pragma unroll
      for (int k = 0; k < K; ++k) red_w[k * TMI + sl] = da[p][k];
      red_w[K * TMI + sl] = db[p];
    }
  }
  if (t0 < t_end) {
    __syncthreads();  // the last tile's rows visible
    reduce(t_end - 1);
  }

  // each student's dtheta and ll summed over the lanes: the split's partial
  const size_t row0 = static_cast<size_t>(split) * B;
  float ll_warp = 0.f;
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int gs = s_warp + q;
#pragma unroll
    for (int c = 0; c <= K; ++c) {
      float v = c < K ? dth[q][c] : lq[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (c == K) ll_warp += v;  // every lane holds the sum
      if (lane != 0 || gs >= B) continue;
      if (c < K)
        part_dth[(row0 + gs) * K + c] = v;
      else if (part_llp != nullptr)
        part_llp[row0 + gs] = v;
    }
  }
  if (lane == 0) ll_s[warp] = ll_warp;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < NWARP; ++w) sum += ll_s[w];
    part_ll[static_cast<size_t>(split) * gridDim.x + blockIdx.x] = sum;
  }
}

template <int K>
cudaError_t launch_2pl(const float* theta, long long th_sb, long long th_sk,
                       const float* a, const float* b, const int8_t* pk,
                       float* part_dth, float* part_llp, float* part_da,
                       float* part_db, float* part_ll, int nblk, int nsplit,
                       int tps, int B, int M, cudaStream_t stream) {
  return vibo::launch_tiled(loglik_2pl_kernel<K>, dim3(nblk, nsplit),
                            sizeof(float) * smem_floats_2pl<K>(), stream,
                            theta, th_sb, th_sk, a, b, pk, part_dth,
                            part_llp, part_da, part_db, part_ll, B, M, tps);
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch_train(const float* theta, long long th_sb, long long th_sk,
                         const float* a, const float* b, const float* gh,
                         const int8_t* pk, float* part_dth, float* part_llp,
                         float* part_da, float* part_db, float* part_dg,
                         float* part_ll, int nblk, int nsplit, int tps, int B,
                         int M, cudaStream_t stream, int kt = K, int k0 = 0) {
  return vibo::launch_tiled(loglik_train_kernel<Link, K, WIDE>,
                            dim3(nblk, nsplit),
                            sizeof(float) * smem_floats<Link, K>(), stream,
                            theta, th_sb, th_sk, a, b, gh, pk, part_dth,
                            part_llp, part_da, part_db, part_dg, part_ll, B,
                            M, tps, kt, k0);
}

// The kernel of (Link, K) (K > 8: the wide variant) and its dynamic shared
// memory, for the occupancy query.
template <class Link>
const void* kernel_of(int K, size_t* smem) {
  switch (K) {
#define VIBO_CASE(KK)                                                 \
  case KK:                                                            \
    if constexpr (std::is_same_v<Link, Link2PL>) {                    \
      *smem = sizeof(float) * smem_floats_2pl<KK>();                  \
      return reinterpret_cast<const void*>(loglik_2pl_kernel<KK>);    \
    } else {                                                          \
      *smem = sizeof(float) * smem_floats<Link, KK>();                \
      return reinterpret_cast<const void*>(                           \
          loglik_train_kernel<Link, KK, false>);                      \
    }
    VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
    VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
  }
  *smem = sizeof(float) * smem_floats<Link, vibo::KC>();
  return reinterpret_cast<const void*>(
      loglik_train_kernel<Link, vibo::KC, true>);
}

// The C entry points' common body; gh, part_dg and dg are null for 2PL,
// part_llp and ll_person when only the scalar ll is wanted.
template <class Link>
int train_entry(const void* theta, long long th_sb, long long th_sk,
                const void* a, const void* b, const void* gh, const void* pk,
                void* dtheta, long long dt_sb, long long dt_sk,
                void* ll_person, void* part_dth, void* part_llp,
                void* part_da, void* part_db, void* part_dg, void* part_ll,
                void* da, void* db, void* dg, void* ll, int B, int M, int K,
                int nblk, int nsplit, int tps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!vibo::check_plan(B, M, nblk, nsplit, tps) || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(theta);
  const float* av = static_cast<const float*>(a);
  const float* bv = static_cast<const float*>(b);
  const float* gv = static_cast<const float*>(gh);
  const int8_t* p = static_cast<const int8_t*>(pk);
  float* pt = static_cast<float*>(part_dth);
  float* pp = static_cast<float*>(part_llp);
  float* pa = static_cast<float*>(part_da);
  float* pb = static_cast<float*>(part_db);
  float* pg = static_cast<float*>(part_dg);
  float* pl = static_cast<float*>(part_ll);
  if (nblk > 0) {
    cudaError_t err;
    switch (K) {
#define VIBO_CASE(KK)                                                         \
  case KK:                                                                    \
    if constexpr (std::is_same_v<Link, Link2PL>)                              \
      err = launch_2pl<KK>(t, th_sb, th_sk, av, bv, p, pt, pp, pa, pb, pl,    \
                           nblk, nsplit, tps, B, M, stream);                  \
    else                                                                      \
      err = launch_train<Link, KK>(t, th_sb, th_sk, av, bv, gv, p, pt, pp,    \
                                   pa, pb, pg, pl, nblk, nsplit, tps, B, M,   \
                                   stream);                                   \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
      default:  // K > 8: one wide pass a chunk of KC dims
        err = cudaSuccess;
        for (int k0 = 0; k0 < K && err == cudaSuccess; k0 += vibo::KC)
          err = launch_train<Link, vibo::KC, true>(
              t, th_sb, th_sk, av, bv, gv, p, pt, pp, pa, pb, pg, pl, nblk,
              nsplit, tps, B, M, stream, K, k0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // second pass: da, db[, dg] over the student blocks; dtheta[, ll_person]
  // over the splits; ll over every block
  const long long mk = static_cast<long long>(M) * K;
  const vibo::SumSeg segs[] = {
      {pa, static_cast<float*>(da), mk, nblk, 1, 1, 0},
      {pb, static_cast<float*>(db), M, nblk, 1, 1, 0},
      {pg, static_cast<float*>(dg), pg != nullptr ? M : 0, nblk, 1, 1, 0},
      {pt, static_cast<float*>(dtheta), static_cast<long long>(B) * K, nsplit,
       K, dt_sb, dt_sk},
      {pp, static_cast<float*>(ll_person), pp != nullptr ? B : 0, nsplit, 1,
       1, 0},
      {pl, static_cast<float*>(ll), 1, nblk * nsplit, 1, 1, 0}};
  return static_cast<int>(vibo::launch_sum_rows(segs, 6, stream));
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// theta/dtheta: f32 at theta[i*th_sb + k*th_sk]; a (M, K), b (M,) f32
// contiguous; pk (B, M) int8 contiguous; ll_person (B,) or null. The plan
// (nblk, nsplit, tps) of ops/one_pass.py split_plan, checked here
// (loglik_tile.cuh check_plan) so a mismatch is refused instead of
// overrunning the scratch: part_dth (nsplit, B, K), part_llp (nsplit, B)
// (null with ll_person), part_da (nblk, M, K), part_db (nblk, M), part_ll
// (nsplit, nblk); outputs da (M, K), db (M,), ll (1,).
int loglik_2pl_train(const void* theta, long long th_sb, long long th_sk,
                     const void* a, const void* b, const void* pk,
                     void* dtheta, long long dt_sb, long long dt_sk,
                     void* ll_person, void* part_dth, void* part_llp,
                     void* part_da, void* part_db, void* part_ll, void* da,
                     void* db, void* ll, int B, int M, int K, int nblk,
                     int nsplit, int tps, void* stream_ptr) {
  return train_entry<Link2PL>(theta, th_sb, th_sk, a, b, nullptr, pk, dtheta,
                              dt_sb, dt_sk, ll_person, part_dth, part_llp,
                              part_da, part_db, nullptr, part_ll, da, db,
                              nullptr, ll, B, M, K, nblk, nsplit, tps,
                              stream_ptr);
}

// As loglik_2pl_train, with the guess logits g_hat (M,) f32, the scratch
// part_dg (nblk, M) and the output dg (M,).
int loglik_3pl_train(const void* theta, long long th_sb, long long th_sk,
                     const void* a, const void* b, const void* g_hat,
                     const void* pk, void* dtheta, long long dt_sb,
                     long long dt_sk, void* ll_person, void* part_dth,
                     void* part_llp, void* part_da, void* part_db,
                     void* part_dg, void* part_ll, void* da, void* db,
                     void* dg, void* ll, int B, int M, int K, int nblk,
                     int nsplit, int tps, void* stream_ptr) {
  return train_entry<Link3PL>(theta, th_sb, th_sk, a, b, g_hat, pk, dtheta,
                              dt_sb, dt_sk, ll_person, part_dth, part_llp,
                              part_da, part_db, part_dg, part_ll, da, db, dg,
                              ll, B, M, K, nblk, nsplit, tps, stream_ptr);
}

// Registers, local (spill) bytes and blocks an SM of the (link, K) kernel
// (link 0: 2PL, 1: 3PL; K > 8: the wide variant), into out[0..2].
int loglik_train_occupancy(int link, int K, int* out) {
  size_t smem = 0;
  const void* fn = link == 0 ? kernel_of<Link2PL>(K, &smem)
                             : kernel_of<Link3PL>(K, &smem);
  return vibo::occupancy_of(fn, smem, out);
}

}  // extern "C"
