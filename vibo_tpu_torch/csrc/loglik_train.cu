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
// largest of the three times.
//
// The design: the tile mapping and item split of loglik_tile.cuh (a block
// owns 64 students and one split's run of 64-item tiles; a warp takes 4
// students, a lane 2 consecutive items; the grid's second dimension is the
// split, sized so the flagship gets 640 blocks). The tile's a and the
// link's per-item constants (b; for 3PL also log g, log(1-g) and g,
// computed once per item here and not once per cell) are staged in shared
// memory in the lane-major slot order and read by each cell in 16-byte
// loads, so they hold no registers between cells; the next tile's codes, a
// and b (and g_hat) are loaded a tile ahead. The block's theta is staged
// once. dtheta (and the per-person ll) accumulate per student in
// lane-private shared slots across the split's tiles and are summed over
// the lanes by warp shuffles once at the end into the split's partial. The
// per-item da/db(/dg) of a tile are summed over the block's 16 warps in
// shared memory (two barriers a tile) and written as the block's partial,
// with the block's sum of ll. The second pass (loglik_tile.cuh
// sum_rows_kernel) sums the partials over student blocks and splits in a
// fixed order, so every output is deterministic. What bounds it now is the
// register file and the cell's special functions: up to K = 4 the kernel is
// held to 64 registers with no spill, two blocks of 16 warps an SM
// (chip_smoke.py prints ptxas's registers and the blocks an SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// K = 1..8 are instantiated; any K > 8 runs the wide variant, a pass a
// chunk of 8 ability dims (loglik_tile.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

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

// Blocks an SM each instantiation is built for: two of 16 warps (64
// registers a thread) up to K = 4, one above.
template <int K>
constexpr int min_blocks() {
  return K <= 4 ? 2 : 1;
}

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
__global__ void __launch_bounds__(THREADS, min_blocks<K>())
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

template <class Link, int K, bool WIDE = false>
cudaError_t launch_train(const float* theta, long long th_sb, long long th_sk,
                         const float* a, const float* b, const float* gh,
                         const int8_t* pk, float* part_dth, float* part_llp,
                         float* part_da, float* part_db, float* part_dg,
                         float* part_ll, int nblk, int nsplit, int tps, int B,
                         int M, cudaStream_t stream, int kt = K, int k0 = 0) {
  const size_t smem = sizeof(float) * smem_floats<Link, K>();
  auto kernel = loglik_train_kernel<Link, K, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nblk, nsplit), THREADS, smem, stream>>>(
          theta, th_sb, th_sk, a, b, gh, pk, part_dth, part_llp, part_da,
          part_db, part_dg, part_ll, B, M, tps, kt, k0);
  return cudaGetLastError();
}

// The kernel of (Link, K) (K > 8: the wide variant) and its dynamic shared
// memory, for the occupancy query.
template <class Link>
const void* kernel_of(int K, size_t* smem) {
  switch (K) {
#define VIBO_CASE(KK)                                                 \
  case KK:                                                            \
    *smem = sizeof(float) * smem_floats<Link, KK>();                  \
    return reinterpret_cast<const void*>(                             \
        loglik_train_kernel<Link, KK, false>);
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
    err = launch_train<Link, KK>(t, th_sb, th_sk, av, bv, gv, p, pt, pp, pa,  \
                                 pb, pg, pl, nblk, nsplit, tps, B, M, stream); \
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
