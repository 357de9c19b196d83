// The one-pass training log-likelihood kernel of the polytomous families,
// on the int8 response code, templated on the family's cell: the graded
// response model (loglik_grm.cu) and the generalized partial credit model
// (loglik_gpcm.cu), one library each, so that their instantiations build in
// parallel. Both take theta (B, K) through its strides, a (M, K), the
// family's per-item table kappa (M, C-1) (GRM: the ordered thresholds,
// GPCM: the cumulative step sums) and the int8 code (0 = missing, 1 +
// category), and emit the per-person ll (B,), dtheta (B, K) and, as one
// (K + C - 1, M) array, da^T and dkappa^T: the value and every gradient of
// sum(ll) in one pass over the code. Per cell, with the code c: m = min(c,
// 1), r = max(c - 1, 0) (clamped to C - 1), base = theta_i . a_j, then the
// family's cell gives (ll, dbase) and adds its dkappa terms:
//   dtheta_i += dbase a_j,  da_j += dbase theta_i
// A link is either run-time C (CF = 0: it stages its table a tile with
// stage_steps/stage and adds dkappa into its warp's reduce rows) or
// compile-time C (CF = C: dkappa in NDK registers a lane's item, written
// once a tile; SLOTS: the tile's table copied from a prologue's slots by
// copy_tile, else one prefetched value a thread placed by store).
//
// The design: loglik_tile.cuh's tile mapping and item split (64 students a
// block on one split's run of 64-item tiles, a warp 4 students, a lane 2
// consecutive items; the grid's second dimension is the split), with the
// tile's a and the family's table staged in shared memory in the lane-major
// slot order p * 32 + lane, so that a lane's gather by its own category
// never conflicts; a cell reads its item's a (and the compile-time-C table)
// in 16-byte loads. The next tile's codes, a and (compile-time C) kappa or
// GRM slots are loaded a tile ahead. dtheta and ll accumulate per student in
// shared slots across the split's tiles, da in registers per item; the
// tile's per-item sums over the 16 warps (two barriers a tile) are written
// as the block's partial, and the second pass (loglik_tile.cuh
// sum_rows_kernel) sums the partials over student blocks and splits in a
// fixed order: no float atomics, deterministic. The run-time links' dkappa
// slots are zeroed by the thread that reduces them, so a tile needs no
// barrier for that. Registers bound the blocks an SM holds: two of 16 warps
// (64 registers, no spill) for the run-time GRM up to K = 4, the
// compile-time GPCM while K + C <= 9 and the compile-time GRM while also
// K <= 4, one otherwise (chip_smoke.py prints ptxas's registers and the
// occupancy); the shared memory is dynamic and sized by C (up to ~220 KB
// at K = 8, C = 32, opted in above 48 KB).
// K = 1..8 are instantiated; any K > 8 runs the wide variant (run-time C),
// a pass a chunk of 8 ability dims (loglik_tile.cuh).


#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "loglik_tile.cuh"

namespace vibo {

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
  // latency. The compile-time GRM holds two students' code words a
  // register (its cell needs the registers) and copies the tile's slots
  // (kap: the prologue's table) into buffer t % 2.
  constexpr int PER = Link::SLOTS ? 2 : 1;  // students a code register
  uint32_t nxt[SPT / PER];
  float pa = 0.f, pk_v = 0.f;
  auto prefetch = [&](int t) {
    const int m0 = t * TMI, n = min(TMI, M - m0);
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const uint32_t w = vibo::load_code_pair(pk, s0 + warp * SPT + q,
                                              m0 + j0, B, M, vec);
      if (q % PER == 0)
        nxt[q / PER] = w;
      else
        nxt[q / PER] |= w << 16;
    }
    if constexpr (!WIDE) pa = vibo::prefetch1(a + static_cast<size_t>(m0) * K,
                                              n * K);
    if constexpr (Link::SLOTS)
      Link::copy_tile(tab_s + (t & 1) * Link::TAB,
                      kap + static_cast<size_t>(t) * Link::TAB);
    else if constexpr (FIXED)
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
    if constexpr (Link::SLOTS) {
      vibo::cp_async_wait_all();  // this thread's copies of tile t
    } else if constexpr (FIXED) {
      Link::store(tab_s, pk_v);
    } else {
#pragma unroll 1
      for (int i = tid; i < Link::stage_steps(C) * TMI; i += THREADS) {
        const int row = i / TMI, j = i % TMI, gj = m0 + j;
        Link::stage(tab_s, vibo::slot_of(j), kap, gj < M ? gj : -1, C, row);
      }
    }
    uint32_t cur[SPT / PER];
#pragma unroll
    for (int h = 0; h < SPT / PER; ++h) cur[h] = nxt[h];
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
        const int code = vibo::code_at(cur[q / PER], 2 * (q % PER) + p);
        const float mk = fminf(static_cast<float>(code), 1.f);
        const int r = min(max(code - 1, 0), C - 1);
        const int sl = p * 32 + lane;
        float dbase;
        if constexpr (Link::SLOTS)
          lq += Link::cell(dot, tab_s + (t & 1) * Link::TAB + 4 * sl, mk, r,
                           dk[p], dbase);
        else if constexpr (FIXED)
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
  return vibo::launch_tiled(loglik_categorical_kernel<Link, K, WIDE>,
                            dim3(nblk, nsplit), vibo::smem_bytes<Link>(K, C),
                            stream, theta, th_sb, th_sk, a, kap, pk,
                            part_dth, part_llp, part, B, M, C, tps, kt, k0);
}

// The launch arguments every path passes through.
struct Args {
  const float* t;
  long long th_sb, th_sk;
  const float* av;
  const float* kv;
  float* tab;  // the compile-time GRM's slots (scratch)
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

template <cudaError_t (*LAUNCH)(const Args&, int)>
int entry(const void* theta, long long th_sb, long long th_sk, const void* a,
          const void* kap, void* tab, const void* pk, void* dtheta,
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
                 static_cast<float*>(tab), static_cast<const int8_t*>(pk), pt,
                 pp, pr, nblk, nsplit, tps, B, M, C, stream};
    const cudaError_t err = LAUNCH(g, K);
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

// The kernel a call of the compile-time-C link Fixed at (K, C) launches
// first (3 <= C <= 8, K <= 8), and its shared memory.
template <template <int> class Fixed>
const void* fixed_kernel_of(int K, int C, size_t* smem) {
  switch (C * 16 + K) {
#define VIBO_FIXED(CC, KK)                                              \
  case CC * 16 + KK:                                                    \
    *smem = vibo::smem_bytes<Fixed<CC>>(KK, CC);                        \
    return kernel_ptr<Fixed<CC>, KK>();
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

// The kernel a call of the run-time-C link at (K, C) launches first (K > 8:
// the wide variant), and its shared memory.
template <class Link>
const void* runtime_kernel_of(int K, int C, size_t* smem) {
  *smem = vibo::smem_bytes<Link>(K > 8 ? vibo::KC : K, C);
  if (K > 8) return kernel_ptr<Link, vibo::KC, true>();
  switch (K) {
#define VIBO_RT(KK) \
  case KK:          \
    return kernel_ptr<Link, KK>();
    VIBO_RT(1) VIBO_RT(2) VIBO_RT(3) VIBO_RT(4)
    VIBO_RT(5) VIBO_RT(6) VIBO_RT(7) VIBO_RT(8)
#undef VIBO_RT
  }
  return nullptr;
}

}  // namespace
