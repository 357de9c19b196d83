// General masked Bernoulli log-likelihood and its exact VJP for the 2PL and
// the 3PL link (irt_links.cuh), on dense f32 (resp, mask) or on the int8
// response code.
//
// Replaces the TPU Pallas kernels of vibo_tpu/ops/pallas_elbo.py:
//   2PL  _fwd_pallas (:247), body _fwd_kernel (:229): dense forward
//        _bwd_pallas (:319), bodies _bwd_dtheta_kernel (:278) and
//        _bwd_items_kernel (:296): dense VJP
//        _fwd_pallas_packed (:445), body _fwd_kernel_packed (:373): int8
//        forward
//        _bwd_pallas_packed (:468), bodies _bwd_dtheta_kernel_packed (:392)
//        and _bwd_items_kernel_packed (:410): int8 VJP
//   3PL  _fwd_pallas_3pl (:959), body _fwd_kernel_3pl (:865), and
//        _bwd_pallas_3pl (:985), bodies _bwd_dtheta_kernel_3pl (:883) and
//        _bwd_items_kernel_3pl (:904), each with a `packed` flag for the
//        reader: the same, plus dg_hat
// One source serves all: the kernels are templated on the link, on the cell
// reader (dense: m = mask, r = resp; int8 code c: m = min(c, 1),
// r = max(c - 1, 0)) and on K = 1..8, with a wide variant for any K > 8
// (loglik_tile.cuh: the forward in one pass, the backward a pass a chunk
// of 8 dims). Per cell:
//   l = theta_i . a_j - b_j,  ll_i += the link's cell value
//   dl = g_i * dll/dl,  dtheta_i += dl a_j,  da_j += dl theta_i,  db_j -= dl
//   [3PL: dg_j += g_i * dll/dg_hat]
// The VJP is exact for ANY per-person cotangent g (the contract that sets
// this op apart from the uniform-cotangent one-pass training kernel of
// loglik_train.cu).
//
// Leading sample axis: the last grid dimension runs the S samples of one
// call (the grid's z in both directions);
// theta, g, ll and dtheta carry the axis, a, b, g_hat and the data each
// carry it or are shared (sample stride 0). A shared a (or b, g_hat) gets
// the gradient summed over samples.
//
// What bounds it on an H100, at the minibatch shape B = 4,096, M = 1,024,
// K = 4: the dense reader moves 8 bytes a cell (33.6 MB, ~10 us at
// 3.35 TB/s) in both directions, so bytes bound the 2PL kernels; the int8
// forward reads 4.2 MB (~1.25 us), so there the special-function results of
// the cell (exp, log1p, reciprocals: chip_smoke.py counts them in this
// library's SASS, at 16 a clock an SM; for the 2PL forward the function's
// one a cell) or its f32 operations bound it. The 3PL cell takes about
// three times the special functions of the 2PL cell.
//
// Both directions share loglik_tile.cuh's mapping and item split, the
// design of the one-pass training kernels (loglik_train.cu): the grid is
// (student blocks of 64, item splits, samples), planned on the host by
// ops/one_pass.py split_plan so that the minibatch gets about four blocks
// an SM (two of 16 warps resident), and checked here. A warp takes 4
// students, a lane 2 consecutive items of a 64-item tile; the tile's a and
// the link's constants (b; for 3PL also log g, log(1-g) and g, computed
// once per item, not once per cell) are staged in the lane-major slot
// order (no bank conflict); the next tile's item data and cells are loaded
// ahead, interior tiles without bounds checks. The second pass
// (loglik_tile.cuh sum_rows_kernel: 32 columns a block, 8 row groups) sums
// the partials in a fixed order. No float atomics: every output is
// deterministic.
//
// Forward: nothing is summed over the warps, so one barrier a tile guards
// the double-buffered item staging. A lane reads its items' constants into
// registers once a tile for its 4 students; a student's next-tile cells
// (the dense (m, r) pairs or the int8 code word) are loaded into registers
// as soon as its cells of the current tile are done; each student's ll
// stays in registers across the split's tiles and is summed over the lanes
// by shuffles once, into the split's partial (nsplit, S, B), which the
// second pass sums over the splits. The 2PL cell takes exp and log1p from
// the special-function unit's approximations (irt_links.cuh). What holds
// it back now: the dense 2PL forward moves its bytes at about half the
// HBM rate, the int8 and 3PL forwards are held by the cell's instruction
// count (estimates from the code and the times, no profiler counter).
//
// VJP: ONE pass over the data (Pallas needs two, one per grid accumulation
// axis). The next tile's int8 codes are loaded into registers, its dense
// rows asked into L2; two barriers a tile. dtheta accumulates per student
// in lane-private shared slots and is written as the split's partial; the
// tile's da/db(/dg) are summed over the 16 warps and written as the
// block's partial. The second pass sums dtheta over the splits and each
// item gradient over the student blocks, and over the samples where the
// item array is shared.

#include <cuda_runtime.h>
#include <stdint.h>

#include "irt_links.cuh"
#include "loglik_tile.cuh"

namespace {

using vibo::Link2PL;
using vibo::Link3PL;

// The (m, r) of student gs at the lane's IPT = 2 items gj, gj + 1 from the
// dense (resp, mask) rows (zero outside [0, B) x [0, M)); vec: rows 8-byte
// aligned (M even), so each is one float2 load.
__device__ __forceinline__ void dense_pair(const float* __restrict__ resp,
                                           const float* __restrict__ mask,
                                           int gs, int gj, int B, int M,
                                           bool vec, float (&mk)[2],
                                           float (&r)[2]) {
  const size_t at = static_cast<size_t>(gs) * M + gj;
  if (gs < B && vec && gj + 2 <= M) {
    const float2 vr = *reinterpret_cast<const float2*>(resp + at);
    const float2 vm = *reinterpret_cast<const float2*>(mask + at);
    r[0] = vr.x; r[1] = vr.y; mk[0] = vm.x; mk[1] = vm.y;
    return;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const bool ok = gs < B && gj + p < M;
    r[p] = ok ? resp[at + p] : 0.f;
    mk[p] = ok ? mask[at + p] : 0.f;
  }
}

// True when the reader's rows allow its vector loads: 2 int8 codes or a
// float2 of resp and of mask (M even, base pointers aligned).
template <bool PACKED>
__device__ __forceinline__ bool rows_aligned(const float* resp,
                                             const float* mask,
                                             const int8_t* pk, int M) {
  if constexpr (PACKED)
    return M % 2 == 0 && reinterpret_cast<uintptr_t>(pk) % 2 == 0;
  return M % 2 == 0 && reinterpret_cast<uintptr_t>(resp) % 8 == 0 &&
         reinterpret_cast<uintptr_t>(mask) % 8 == 0;
}

// ------------------------------------------------------------ forward
//
// The VJP's mapping (loglik_tile.cuh: 16 warps, a warp 4 students, a lane
// 2 consecutive items of a 64-item tile; the grid (student blocks, item
// splits, samples)), with nothing to reduce over the warps: one barrier a
// tile, for the double-buffered item staging.

// Shared memory of the (Link, K) forward, in floats: two buffers of the
// tile's link constants (NP a slot, first: 16-byte aligned) and a
// (a_stride(K) a slot; none in the wide variant, whose logit reads a from
// global memory), then theta (TBS x K; none in the wide variant).
template <class Link, int K, bool WIDE>
__host__ __device__ constexpr int fwd_item_floats() {
  return vibo::TMI * (Link::NP + (WIDE ? 0 : vibo::a_stride(K)));
}

template <class Link, int K, bool WIDE>
constexpr int fwd_smem_floats() {
  return 2 * fwd_item_floats<Link, K, WIDE>() + (WIDE ? 0 : vibo::TBS * K);
}

// WIDE: K = KC, the logit over all kt dims by wide_dot (one pass).
// Block (x, y, z): the students x * TBS .. of sample z on the item tiles
// y * tps .. min((y + 1) * tps, tiles) - 1 (ops/one_pass.py split_plan);
// writes each student's ll over those items into part_ll (nsplit, S, B).
template <class Link, int K, bool PACKED, bool WIDE>
__global__ void __launch_bounds__(vibo::THREADS, vibo::min_blocks<K>())
masked_fwd_kernel(const float* __restrict__ theta, const float* __restrict__ a,
                  long long a_ss, const float* __restrict__ b, long long b_ss,
                  const float* __restrict__ gh, long long g_ss,
                  const float* __restrict__ resp,
                  const float* __restrict__ mask,
                  const int8_t* __restrict__ pk, long long d_ss,
                  float* __restrict__ part_ll, int B, int M, int tps,
                  int kt_arg) {
  using vibo::IPT;
  using vibo::SPT;
  using vibo::TBS;
  constexpr int TM = vibo::TMI;
  constexpr int NP = Link::NP;
  constexpr int KA = WIDE ? 0 : vibo::a_stride(K);
  constexpr int BUF = fwd_item_floats<Link, K, WIDE>();
  const int kt = WIDE ? kt_arg : K;
  extern __shared__ __align__(16) float smem[];
  float* th_s = smem + 2 * BUF;               // TBS x K

  const int S = gridDim.z;
  const size_t smp = blockIdx.z;
  theta += smp * B * kt;
  a += smp * a_ss;
  b += smp * b_ss;
  if constexpr (Link::NX > 0) gh += smp * g_ss;
  if constexpr (PACKED) {
    pk += smp * d_ss;
  } else {
    resp += smp * d_ss;
    mask += smp * d_ss;
  }
  part_ll += (static_cast<size_t>(blockIdx.y) * S + smp) * B;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS, s_warp = s0 + warp * SPT;
  const int split = blockIdx.y;
  const int t0 = split * tps, t_end = min(t0 + tps, (M + TM - 1) / TM);
  const bool vec = rows_aligned<PACKED>(resp, mask, pk, M);
  const int j0 = lane * IPT;

  // the cells of the next tile (int8: a code word a student; dense: the
  // (m, r) pairs), loaded a student at a time once the current tile's cells
  // of that student are done, and the next tile's raw item data
  uint32_t ncode[SPT];
  float nmk[SPT][IPT], nr[SPT][IPT];
  const bool full_rows = vec && s0 + TBS <= B;
  auto load_cells = [&](int q, int m0) {
    const size_t at = static_cast<size_t>(s_warp + q) * M + m0 + j0;
    if (full_rows && m0 + TM <= M) {  // block-uniform: no bounds to check
      if constexpr (PACKED) {
        ncode[q] = *reinterpret_cast<const uint16_t*>(pk + at);
      } else {
        const float2 vr = *reinterpret_cast<const float2*>(resp + at);
        const float2 vm = *reinterpret_cast<const float2*>(mask + at);
        nr[q][0] = vr.x; nr[q][1] = vr.y; nmk[q][0] = vm.x; nmk[q][1] = vm.y;
      }
    } else if constexpr (PACKED) {
      ncode[q] = vibo::load_code_pair(pk, s_warp + q, m0 + j0, B, M, vec);
    } else {
      dense_pair(resp, mask, s_warp + q, m0 + j0, B, M, vec, nmk[q], nr[q]);
    }
  };
  float pa = 0.f, pb = 0.f, pg = 0.f;
  auto load_items = [&](int t) {
    const int m0 = t * TM, n = min(TM, M - m0);
    if constexpr (!WIDE) pa = vibo::prefetch1(a + static_cast<size_t>(m0) * K,
                                              n * K);
    pb = vibo::prefetch1(b + m0, n);
    if constexpr (Link::NX > 0) pg = vibo::prefetch1(gh + m0, n);
  };
  if (t0 < t_end) {
    load_items(t0);
#pragma unroll
    for (int q = 0; q < SPT; ++q) load_cells(q, t0 * TM);
  }
  // staged while the first tile's loads are in flight
  if constexpr (!WIDE) vibo::stage_theta<K>(th_s, theta, kt, 1, s0, B);

  float llq[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) llq[q] = 0.f;

#pragma unroll 1
  for (int t = t0; t < t_end; ++t) {
    const int m0 = t * TM;
    // buffer t & 1 was last read by tile t - 2's cells, before the
    // previous barrier
    float* p_s = smem + (t & 1) * BUF;
    if constexpr (!WIDE) vibo::store_items<K>(p_s + TM * NP, pa);
    if (tid < TM) {
      float pp[NP];
      Link::stage(pb, pg, pp);
#pragma unroll
      for (int x = 0; x < NP; ++x) p_s[vibo::slot_of(tid) * NP + x] = pp[x];
    }
    __syncthreads();  // tile t's items (and theta) visible
    if (t + 1 < t_end) load_items(t + 1);

    // the lane's items' constants, once a tile for its 4 students
    float pj[IPT][NP], aj[IPT][K];
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      const int sl = p * 32 + lane;
#pragma unroll
      for (int x = 0; x < NP; ++x) pj[p][x] = p_s[sl * NP + x];
      if constexpr (!WIDE) {
#pragma unroll
        for (int k = 0; k < K; ++k) aj[p][k] = p_s[TM * NP + sl * KA + k];
      }
    }
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int gs = s_warp + q;
      float mk[IPT], r[IPT];
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        if constexpr (PACKED) {
          const float c = static_cast<float>(vibo::code_at(ncode[q], p));
          mk[p] = fminf(c, 1.f);
          r[p] = fmaxf(c - 1.f, 0.f);
        } else {
          mk[p] = nmk[q][p];
          r[p] = nr[q][p];
        }
      }
      float th[K];
      if constexpr (!WIDE) {
#pragma unroll
        for (int k = 0; k < K; ++k) th[k] = th_s[(warp * SPT + q) * K + k];
      }
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float dot = 0.f;
        if constexpr (WIDE) {
          const int gj = m0 + j0 + p;
          if (gs < B && gj < M)
            dot = vibo::wide_dot(theta + static_cast<size_t>(gs) * kt, 1,
                                 a + static_cast<size_t>(gj) * kt, kt);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) dot = fmaf(th[k], aj[p][k], dot);
        }
        llq[q] += Link::value(dot - pj[p][0], pj[p], mk[p], r[p]);
      }
      // this student's cells of the next tile, in flight over the other
      // students' cells, the staging and the barrier
      if (t + 1 < t_end) load_cells(q, m0 + TM);
    }
  }

  // each student's ll over the split's items, summed over the lanes
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    float v = llq[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && s_warp + q < B) part_ll[s_warp + q] = v;
  }
}

// ---------------------------------------------------------------- VJP
//
// The backward takes loglik_tile.cuh's mapping (vibo::NWARP = 16 warps, a
// warp SPT = 4 students, a lane IPT = 2 consecutive items, tiles of TMI =
// 64 items), with the grid (student blocks, item splits, samples).

// Shared memory of the (Link, K) backward, in floats: the per-item
// constants (first, 16-byte aligned), theta, the cotangent, a, the reduce
// rows and the students' lane-private dtheta sums.
template <class Link, int K>
constexpr int bwd_smem_floats() {
  return vibo::TMI * Link::NP + vibo::TBS * K + vibo::TBS +
         vibo::TMI * vibo::a_stride(K) +
         vibo::NWARP * (K + 1 + Link::NX) * vibo::TMI + vibo::TBS * K * 32;
}

// The dense rows of the warp's SPT students over tile m0 (2 x 256 bytes a
// student) asked into L2 a tile ahead: 16 lanes, one 128-byte line each;
// the cells' loads then wait on L2, not on device memory, and hold no
// registers between tiles.
__device__ __forceinline__ void dense_to_l2(const float* resp,
                                            const float* mask, int s_warp,
                                            int m0, int B, int M) {
  const int lane = threadIdx.x & 31;
  const int gs = s_warp + (lane >> 2), gj = m0 + (lane & 1) * 32;
  if (lane >= 16 || gs >= B || gj >= M) return;
  const float* row = ((lane >> 1) & 1 ? mask : resp) +
                     static_cast<size_t>(gs) * M + gj;
  asm volatile("prefetch.global.L2 [%0];" ::"l"(row));
}

// WIDE: K = KC, one pass over the dims [k0, k0 + KC) of kt (loglik_tile.cuh).
// Block (x, y, z): the students x * TBS .. of sample z on the item tiles
// y * tps .. min((y + 1) * tps, tiles) - 1 (ops/one_pass.py split_plan).
// Partials: part_dth (nsplit, S, B, kt); part_da (nblk, S, M, kt); part_db
// and part_dg (nblk, S, M).
template <class Link, int K, bool PACKED, bool WIDE>
__global__ void __launch_bounds__(vibo::THREADS, vibo::min_blocks<K>())
masked_bwd_kernel(const float* __restrict__ g, const float* __restrict__ theta,
                  const float* __restrict__ a, long long a_ss,
                  const float* __restrict__ b, long long b_ss,
                  const float* __restrict__ gh, long long g_ss,
                  const float* __restrict__ resp,
                  const float* __restrict__ mask,
                  const int8_t* __restrict__ pk, long long d_ss,
                  float* __restrict__ part_dth, float* __restrict__ part_da,
                  float* __restrict__ part_db, float* __restrict__ part_dg,
                  int B, int M, int tps, int kt_arg, int k0_arg) {
  using vibo::IPT;
  using vibo::NWARP;
  using vibo::SPT;
  using vibo::TBS;
  constexpr int TM = vibo::TMI, NT = vibo::THREADS;
  constexpr int NP = Link::NP;
  constexpr int NC = K + 1 + Link::NX;  // reduced columns: da, db[, dg]
  constexpr int KA = vibo::a_stride(K);
  const int kt = WIDE ? kt_arg : K, k0 = WIDE ? k0_arg : 0;
  const bool first = k0 == 0;  // writes db and dg
  extern __shared__ __align__(16) float smem[];
  float* p_s = smem;                          // NP constants a slot
  float* th_s = p_s + TM * NP;                // TBS x K
  float* g_s = th_s + TBS * K;                // the students' cotangents
  float* a_s = g_s + TBS;                     // KA floats a slot
  float* red_s = a_s + TM * KA;               // warp, column, slot
  float* acc_s = red_s + NWARP * NC * TM;     // lane-private dtheta sums

  const int S = gridDim.z;
  const size_t smp = blockIdx.z;
  g += smp * B;
  theta += smp * B * kt;
  a += smp * a_ss;
  b += smp * b_ss;
  if constexpr (Link::NX > 0) gh += smp * g_ss;
  if constexpr (PACKED) {
    pk += smp * d_ss;
  } else {
    resp += smp * d_ss;
    mask += smp * d_ss;
  }
  const size_t blk = static_cast<size_t>(blockIdx.x) * S + smp;
  part_da += blk * M * kt;
  part_db += blk * M;
  if constexpr (Link::NX > 0) part_dg += blk * M;
  part_dth += (static_cast<size_t>(blockIdx.y) * S + smp) * B * kt;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS, s_warp = s0 + warp * SPT;
  const int split = blockIdx.y;
  const int t_end = min((split + 1) * tps, (M + TM - 1) / TM);
  const bool vec = rows_aligned<PACKED>(resp, mask, pk, M);
  const int j0 = lane * IPT;
  float* red_w = red_s + warp * NC * TM;
  float* acc_w = acc_s + warp * SPT * K * 32;

  vibo::stage_theta<K>(th_s, theta, kt, 1, s0, B, k0, kt);
  for (int i = tid; i < TBS; i += NT) g_s[i] = s0 + i < B ? g[s0 + i] : 0.f;
#pragma unroll
  for (int c = 0; c < SPT * K; ++c) acc_w[c * 32 + lane] = 0.f;

  // tile t's raw item data and (int8) codes, loaded a tile ahead; the dense
  // rows are asked into L2 instead
  uint32_t nxt[SPT];
  float pa = 0.f, pb = 0.f, pg = 0.f;
  auto prefetch = [&](int t) {
    const int m0 = t * TM, n = min(TM, M - m0);
    if constexpr (PACKED) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
        nxt[q] = vibo::load_code_pair(pk, s_warp + q, m0 + j0, B, M, vec);
    } else {
      dense_to_l2(resp, mask, s_warp, m0, B, M);
    }
    if constexpr (!WIDE) pa = vibo::prefetch1(a + static_cast<size_t>(m0) * K,
                                              n * K);
    pb = vibo::prefetch1(b + m0, n);
    if constexpr (Link::NX > 0) pg = vibo::prefetch1(gh + m0, n);
  };
  if (split * tps < t_end) prefetch(split * tps);

  for (int t = split * tps; t < t_end; ++t) {
    const int m0 = t * TM;
    // the previous tile's cells are done (its second barrier): a_s and p_s
    // are free; its reduce reads only red_s
    if constexpr (WIDE)
      vibo::stage_items<K>(a_s, a, m0, M, k0, kt);
    else
      vibo::store_items<K>(a_s, pa);
    if (tid < TM) {
      float pp[NP];
      Link::stage(pb, pg, pp);
#pragma unroll
      for (int x = 0; x < NP; ++x) p_s[vibo::slot_of(tid) * NP + x] = pp[x];
    }
    uint32_t cur[SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) cur[q] = PACKED ? nxt[q] : 0u;
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
      const int sq = warp * SPT + q, gs = s0 + sq;
      float mk[IPT], r[IPT];
      if constexpr (PACKED) {
#pragma unroll
        for (int p = 0; p < IPT; ++p) {
          const float c = static_cast<float>(vibo::code_at(cur[q], p));
          mk[p] = fminf(c, 1.f);
          r[p] = fmaxf(c - 1.f, 0.f);
        }
      } else {
        dense_pair(resp, mask, gs, m0 + j0, B, M, vec, mk, r);
      }
      const float gq = g_s[sq];
      float th[K], dq[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        th[k] = th_s[sq * K + k];
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
            dot = vibo::wide_dot(theta + static_cast<size_t>(gs) * kt, 1,
                                 a + static_cast<size_t>(gj) * kt, kt);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) dot = fmaf(th[k], aj[k], dot);
        }
        float dxc;
        const float dl = gq * Link::grad(dot - pj[0], pj, mk[p], r[p], dxc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dq[k] = fmaf(dl, aj[k], dq[k]);
          da[p][k] = fmaf(dl, th[k], da[p][k]);
        }
        db[p] -= dl;
        if constexpr (Link::NX > 0) dx[p] = fmaf(gq, dxc, dx[p]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) acc_w[(q * K + k) * 32 + lane] += dq[k];
    }

#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      const int sl = p * 32 + lane;
#pragma unroll
      for (int k = 0; k < K; ++k) red_w[k * TM + sl] = da[p][k];
      red_w[K * TM + sl] = db[p];
      if constexpr (Link::NX > 0) red_w[(K + 1) * TM + sl] = dx[p];
    }
    __syncthreads();  // every warp's sums visible; a_s and p_s are free
    // (column, slot) pairs by the constant TMI; slot sl is item
    // (sl % 32) * IPT + sl / 32 of the tile
    for (int i = tid; i < TM * NC; i += NT) {
      const int col = i / TM, sl = i % TM;
      const int gj = m0 + (sl % 32) * IPT + sl / 32;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red_s[(w * NC + col) * TM + sl];
      if (col < K) {
        if (k0 + col < kt)
          part_da[static_cast<size_t>(gj) * kt + k0 + col] = sum;
      } else if (!first) {
        continue;
      } else if (col == K) {
        part_db[gj] = sum;
      } else {
        part_dg[gj] = sum;
      }
    }
  }

  // acc_w is this warp's own: its lanes' adds precede these reads
  __syncwarp();
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int gs = s_warp + q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = acc_w[(q * K + k) * 32 + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && gs < B && k0 + k < kt)
        part_dth[static_cast<size_t>(gs) * kt + k0 + k] = v;
    }
  }
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch_fwd(const float* theta, const float* a, long long a_ss,
                       const float* b, long long b_ss, const float* gh,
                       long long g_ss, const float* resp, const float* mask,
                       const int8_t* pk, long long d_ss, float* part_ll,
                       int S, int B, int M, int nblk, int nsplit, int tps,
                       cudaStream_t stream, int kt = K) {
  return vibo::launch_tiled(pk != nullptr
                                ? masked_fwd_kernel<Link, K, true, WIDE>
                                : masked_fwd_kernel<Link, K, false, WIDE>,
                            dim3(nblk, nsplit, S),
                            sizeof(float) * fwd_smem_floats<Link, K, WIDE>(),
                            stream, theta, a, a_ss, b, b_ss, gh, g_ss, resp,
                            mask, pk, d_ss, part_ll, B, M, tps, kt);
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch_bwd(const float* g, const float* theta, const float* a,
                       long long a_ss, const float* b, long long b_ss,
                       const float* gh, long long g_ss, const float* resp,
                       const float* mask, const int8_t* pk, long long d_ss,
                       float* part_dth, float* part_da, float* part_db,
                       float* part_dg, int S, int B, int M, int nblk,
                       int nsplit, int tps, cudaStream_t stream, int kt = K,
                       int k0 = 0) {
  return vibo::launch_tiled(pk != nullptr
                                ? masked_bwd_kernel<Link, K, true, WIDE>
                                : masked_bwd_kernel<Link, K, false, WIDE>,
                            dim3(nblk, nsplit, S),
                            sizeof(float) * bwd_smem_floats<Link, K>(),
                            stream, g, theta, a, a_ss, b, b_ss, gh, g_ss,
                            resp, mask, pk, d_ss, part_dth, part_da, part_db,
                            part_dg, B, M, tps, kt, k0);
}

bool bad_sizes(int S, int B, int M, int K) {
  return S < 1 || S > 65535 || B < 0 || M < 0 || K < 1;
}

// The forward entry points' common body; gh is null for 2PL.
template <class Link>
int fwd_entry(const void* theta, const void* a, long long a_ss,
              const void* b, long long b_ss, const void* gh, long long g_ss,
              const void* resp, const void* mask, const void* pk,
              long long d_ss, void* part_ll, void* ll, int S, int B, int M,
              int K, int nblk, int nsplit, int tps, void* stream_ptr) {
  if (bad_sizes(S, B, M, K) || !vibo::check_plan(B, M, nblk, nsplit, tps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* pl = static_cast<float*>(part_ll);
  if (nblk > 0) {
    const float* t = static_cast<const float*>(theta);
    const float* av = static_cast<const float*>(a);
    const float* bv = static_cast<const float*>(b);
    const float* gv = static_cast<const float*>(gh);
    const float* rv = static_cast<const float*>(resp);
    const float* mv = static_cast<const float*>(mask);
    const int8_t* p = static_cast<const int8_t*>(pk);
    cudaError_t err = cudaErrorInvalidValue;
    switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    err = launch_fwd<Link, KK>(t, av, a_ss, bv, b_ss, gv, g_ss, rv, mv, p,  \
                               d_ss, pl, S, B, M, nblk, nsplit, tps,        \
                               stream);                                     \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
      default:  // K > 8: the wide variant, one pass
        err = launch_fwd<Link, vibo::KC, true>(t, av, a_ss, bv, b_ss, gv,
                                               g_ss, rv, mv, p, d_ss, pl, S,
                                               B, M, nblk, nsplit, tps,
                                               stream, K);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // second pass: ll over the splits
  const vibo::SumSeg seg{pl, static_cast<float*>(ll),
                         static_cast<long long>(S) * B, nsplit, 1, 1, 0};
  return static_cast<int>(vibo::launch_sum_rows(&seg, 1, stream));
}

// The second pass's segment of one item gradient: the partials (nblk, S,
// n) summed over the student blocks, and over the samples too when the
// item array is shared (sample stride 0): rows in a fixed order either way.
vibo::SumSeg item_seg(const float* part, void* out, long long n, int nblk,
                      int S, bool shared) {
  return shared ? vibo::SumSeg{part, static_cast<float*>(out), n, nblk * S,
                               1, 1, 0}
                : vibo::SumSeg{part, static_cast<float*>(out), n * S, nblk,
                               1, 1, 0};
}

// The backward entry points' common body; gh, part_dg and dg are null for
// 2PL.
template <class Link>
int bwd_entry(const void* g, const void* theta, const void* a, long long a_ss,
              const void* b, long long b_ss, const void* gh, long long g_ss,
              const void* resp, const void* mask, const void* pk,
              long long d_ss, void* dtheta, void* part_dth, void* part_da,
              void* part_db, void* part_dg, void* da, void* db, void* dg,
              int S, int B, int M, int K, int nblk, int nsplit, int tps,
              void* stream_ptr) {
  if (bad_sizes(S, B, M, K) || !vibo::check_plan(B, M, nblk, nsplit, tps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* pt = static_cast<float*>(part_dth);
  float* pa = static_cast<float*>(part_da);
  float* pb = static_cast<float*>(part_db);
  float* pg = static_cast<float*>(part_dg);
  if (nblk > 0) {
    const float* gv = static_cast<const float*>(g);
    const float* t = static_cast<const float*>(theta);
    const float* av = static_cast<const float*>(a);
    const float* bv = static_cast<const float*>(b);
    const float* hv = static_cast<const float*>(gh);
    const float* rv = static_cast<const float*>(resp);
    const float* mv = static_cast<const float*>(mask);
    const int8_t* p = static_cast<const int8_t*>(pk);
    cudaError_t err = cudaErrorInvalidValue;
    switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    err = launch_bwd<Link, KK>(gv, t, av, a_ss, bv, b_ss, hv, g_ss, rv, mv, \
                               p, d_ss, pt, pa, pb, pg, S, B, M, nblk,      \
                               nsplit, tps, stream);                        \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
      default:  // K > 8: one wide pass a chunk of KC dims
        err = cudaSuccess;
        for (int k0 = 0; k0 < K && err == cudaSuccess; k0 += vibo::KC)
          err = launch_bwd<Link, vibo::KC, true>(
              gv, t, av, a_ss, bv, b_ss, hv, g_ss, rv, mv, p, d_ss, pt, pa,
              pb, pg, S, B, M, nblk, nsplit, tps, stream, K, k0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // second pass: dtheta over the splits; da, db[, dg] over the student
  // blocks (and the samples, where shared)
  const long long mk = static_cast<long long>(M) * K;
  const vibo::SumSeg segs[] = {
      {pt, static_cast<float*>(dtheta), static_cast<long long>(S) * B * K,
       nsplit, 1, 1, 0},
      item_seg(pa, da, mk, nblk, S, a_ss == 0),
      item_seg(pb, db, M, nblk, S, b_ss == 0),
      item_seg(pg, dg, pg != nullptr ? M : 0, nblk, S, g_ss == 0)};
  return static_cast<int>(vibo::launch_sum_rows(segs, 4, stream));
}

// The forward (FWD) or backward kernel of (Link, K, reader) (K > 8: the
// wide variant) and its dynamic shared memory, for the occupancy query.
template <class Link, bool PACKED, bool FWD>
const void* kernel_of(int K, size_t* smem) {
  switch (K) {
#define VIBO_CASE(KK)                                                     \
  case KK:                                                                \
    if constexpr (FWD) {                                                  \
      *smem = sizeof(float) * fwd_smem_floats<Link, KK, false>();         \
      return reinterpret_cast<const void*>(                               \
          masked_fwd_kernel<Link, KK, PACKED, false>);                    \
    }                                                                     \
    *smem = sizeof(float) * bwd_smem_floats<Link, KK>();                  \
    return reinterpret_cast<const void*>(                                 \
        masked_bwd_kernel<Link, KK, PACKED, false>);
    VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
    VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
  }
  if constexpr (FWD) {
    *smem = sizeof(float) * fwd_smem_floats<Link, vibo::KC, true>();
    return reinterpret_cast<const void*>(
        masked_fwd_kernel<Link, vibo::KC, PACKED, true>);
  }
  *smem = sizeof(float) * bwd_smem_floats<Link, vibo::KC>();
  return reinterpret_cast<const void*>(
      masked_bwd_kernel<Link, vibo::KC, PACKED, true>);
}

// Registers, local (spill) bytes and blocks an SM of the kernel of
// (link, K, reader) (link 0: 2PL, 1: 3PL; packed 0: dense, 1: int8), into
// out[0..2].
template <bool FWD>
int occupancy(int link, int K, int packed, int* out) {
  size_t smem = 0;
  const void* fn =
      link == 0 ? (packed ? kernel_of<Link2PL, true, FWD>(K, &smem)
                          : kernel_of<Link2PL, false, FWD>(K, &smem))
                : (packed ? kernel_of<Link3PL, true, FWD>(K, &smem)
                          : kernel_of<Link3PL, false, FWD>(K, &smem));
  return vibo::occupancy_of(fn, smem, out);
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// theta (S, B, K) f32 contiguous; a at a + s*a_ss, (M, K) contiguous, and b
// at b + s*b_ss, (M,) (a sample stride of 0 shares them over samples); the
// data at a sample stride d_ss (0 = shared): dense resp and mask (B, M) f32
// with pk null, or the int8 code pk (B, M) with resp and mask null. The
// plan (nblk, nsplit, tps) of ops/one_pass.py split_plan for (B, M, S),
// checked here (loglik_tile.cuh check_plan) so a mismatch is refused
// instead of overrunning the scratch part_ll (nsplit, S, B). Writes ll
// (S, B).
int masked_loglik_2pl_fwd(const void* theta, const void* a, long long a_ss,
                          const void* b, long long b_ss, const void* resp,
                          const void* mask, const void* pk, long long d_ss,
                          void* part_ll, void* ll, int S, int B, int M, int K,
                          int nblk, int nsplit, int tps, void* stream_ptr) {
  return fwd_entry<Link2PL>(theta, a, a_ss, b, b_ss, nullptr, 0, resp, mask,
                            pk, d_ss, part_ll, ll, S, B, M, K, nblk, nsplit,
                            tps, stream_ptr);
}

// As masked_loglik_2pl_fwd, with the guess logits g_hat at g_hat + s*g_ss,
// (M,) f32 (g_ss = 0: shared over samples).
int masked_loglik_3pl_fwd(const void* theta, const void* a, long long a_ss,
                          const void* b, long long b_ss, const void* g_hat,
                          long long g_ss, const void* resp, const void* mask,
                          const void* pk, long long d_ss, void* part_ll,
                          void* ll, int S, int B, int M, int K, int nblk,
                          int nsplit, int tps, void* stream_ptr) {
  return fwd_entry<Link3PL>(theta, a, a_ss, b, b_ss, g_hat, g_ss, resp, mask,
                            pk, d_ss, part_ll, ll, S, B, M, K, nblk, nsplit,
                            tps, stream_ptr);
}

// The VJP for the cotangent g (S, B): dtheta (S, B, K); da (Sa, M, K) and
// db (Sb, M), with Sa = 1 when a_ss == 0 (shared a) else S, likewise Sb.
// The plan (nblk, nsplit, tps) of ops/one_pass.py split_plan for (B, M, S),
// checked here (loglik_tile.cuh check_plan) so a mismatch is refused
// instead of overrunning the scratch: part_dth (nsplit, S, B, K), part_da
// (nblk, S, M, K) and part_db (nblk, S, M). Other arguments as the
// forward's.
int masked_loglik_2pl_bwd(const void* g, const void* theta, const void* a,
                          long long a_ss, const void* b, long long b_ss,
                          const void* resp, const void* mask, const void* pk,
                          long long d_ss, void* dtheta, void* part_dth,
                          void* part_da, void* part_db, void* da, void* db,
                          int S, int B, int M, int K, int nblk, int nsplit,
                          int tps, void* stream_ptr) {
  return bwd_entry<Link2PL>(g, theta, a, a_ss, b, b_ss, nullptr, 0, resp,
                            mask, pk, d_ss, dtheta, part_dth, part_da,
                            part_db, nullptr, da, db, nullptr, S, B, M, K,
                            nblk, nsplit, tps, stream_ptr);
}

// As masked_loglik_2pl_bwd, with g_hat as in masked_loglik_3pl_fwd, the
// scratch part_dg (nblk, S, M) and the output dg (Sg, M), Sg = 1 when
// g_ss == 0 else S.
int masked_loglik_3pl_bwd(const void* g, const void* theta, const void* a,
                          long long a_ss, const void* b, long long b_ss,
                          const void* g_hat, long long g_ss, const void* resp,
                          const void* mask, const void* pk, long long d_ss,
                          void* dtheta, void* part_dth, void* part_da,
                          void* part_db, void* part_dg, void* da, void* db,
                          void* dg, int S, int B, int M, int K, int nblk,
                          int nsplit, int tps, void* stream_ptr) {
  return bwd_entry<Link3PL>(g, theta, a, a_ss, b, b_ss, g_hat, g_ss, resp,
                            mask, pk, d_ss, dtheta, part_dth, part_da,
                            part_db, part_dg, da, db, dg, S, B, M, K, nblk,
                            nsplit, tps, stream_ptr);
}

// Registers, local (spill) bytes and blocks an SM of the forward or the
// backward kernel of (link, K, reader) (link 0: 2PL, 1: 3PL; packed 0:
// dense, 1: int8; K > 8: the wide variant), into out[0..2].
int masked_fwd_occupancy(int link, int K, int packed, int* out) {
  return occupancy<true>(link, K, packed, out);
}

int masked_bwd_occupancy(int link, int K, int packed, int* out) {
  return occupancy<false>(link, K, packed, out);
}

}  // extern "C"
