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
// The simple design: the tile mapping of loglik_tile.cuh (a block owns 64
// students and loops over all items in tiles of 128, a warp takes 8
// students, a lane 4 consecutive items), with the tile's a (128 x K) and the
// link's per-item constants (b; for 3PL also log g, log(1-g) and g, computed
// once per item here and not once per cell) staged in shared memory. The
// block's theta is staged in shared memory once (3PL at K = 8 fills the 48
// KB of static shared memory exactly: the warps' ll sums reuse red_s after
// the tile loop). dtheta (and the per-person ll) accumulate per student in
// registers across all item tiles and are summed over the lanes by warp
// shuffles once at the end: no atomics. The per-item
// da/db(/dg) of a tile are summed over the block's 8 warps in shared memory
// and written as the block's partial to scratch, with the block's sum of ll;
// a second kernel sums the partials over blocks in a fixed order, so every
// output is deterministic.
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

// WIDE: K = KC, one pass over the dims [k0, k0 + KC) of kt (loglik_tile.cuh).
template <class Link, int K, bool WIDE>
__global__ void __launch_bounds__(THREADS)
loglik_train_kernel(const float* __restrict__ theta, long long th_sb,
                    long long th_sk, const float* __restrict__ a,
                    const float* __restrict__ b,
                    const float* __restrict__ gh,
                    const int8_t* __restrict__ pk,
                    float* __restrict__ dtheta, long long dt_sb,
                    long long dt_sk, float* __restrict__ ll_person,
                    float* __restrict__ part_da, float* __restrict__ part_db,
                    float* __restrict__ part_dg, float* __restrict__ part_ll,
                    int B, int M, int kt_arg, int k0_arg) {
  constexpr int NP = Link::NP;
  const int kt = WIDE ? kt_arg : K, k0 = WIDE ? k0_arg : 0;
  const bool first = k0 == 0;  // writes ll, db and dg
  constexpr int NC = K + 1 + Link::NX;  // reduced columns: da, db[, dg]
  __shared__ float th_s[TBS][K];
  __shared__ float a_s[TMI][K];
  __shared__ float p_s[NP][TMI];
  __shared__ float red_s[NWARP][TMI][NC];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS;
  const bool vec = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(pk) % 4 == 0);

  vibo::stage_theta<K>(&th_s[0][0], theta, th_sb, th_sk, s0, B, k0, kt);

  float dth[SPT][K];
  float llp[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    llp[q] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dth[q][k] = 0.f;
  }

  const int j0 = lane * IPT;
  for (int m0 = 0; m0 < M; m0 += TMI) {
    for (int i = tid; i < TMI * K; i += THREADS) {
      int j = i / K, k = i % K, gj = m0 + j;
      a_s[j][k] = gj < M && k0 + k < kt
                      ? a[static_cast<size_t>(gj) * kt + k0 + k] : 0.f;
    }
    for (int j = tid; j < TMI; j += THREADS) {
      const int gj = m0 + j;
      float ghj = 0.f;
      if constexpr (Link::NX > 0) ghj = gj < M ? gh[gj] : 0.f;
      float p[NP];
      Link::stage(gj < M ? b[gj] : 0.f, ghj, p);
#pragma unroll
      for (int x = 0; x < NP; ++x) p_s[x][j] = p[x];
    }
    __syncthreads();

    float aj[IPT][K], pj[IPT][NP], da[IPT][K], db[IPT], dx[IPT];
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      db[p] = 0.f;
      dx[p] = 0.f;
#pragma unroll
      for (int x = 0; x < NP; ++x) pj[p][x] = p_s[x][j0 + p];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        aj[p][k] = a_s[j0 + p][k];
        da[p][k] = 0.f;
      }
    }

#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int s = warp * SPT + q, gs = s0 + s;
      int8_t code[IPT];
      vibo::load_codes(pk, gs, m0 + j0, B, M, vec, code);
      float th[K];
#pragma unroll
      for (int k = 0; k < K; ++k) th[k] = th_s[s][k];
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float dot = 0.f;
        if constexpr (WIDE) {
          const int gj = m0 + j0 + p;
          if (gs < B && gj < M)
            dot = vibo::wide_dot(theta + gs * th_sb, th_sk,
                                 a + static_cast<size_t>(gj) * kt, kt);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) dot = fmaf(th[k], aj[p][k], dot);
        }
        const float l = dot - pj[p][0];
        const float c = static_cast<float>(code[p]);
        const float mk = fminf(c, 1.f), r = fmaxf(c - 1.f, 0.f);
        float dl, dxc;
        llp[q] += Link::train(l, pj[p], mk, r, dl, dxc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dth[q][k] = fmaf(dl, aj[p][k], dth[q][k]);
          da[p][k] = fmaf(dl, th[k], da[p][k]);
        }
        db[p] -= dl;
        if constexpr (Link::NX > 0) dx[p] += dxc;
      }
    }

#pragma unroll
    for (int p = 0; p < IPT; ++p) {
#pragma unroll
      for (int k = 0; k < K; ++k) red_s[warp][j0 + p][k] = da[p][k];
      red_s[warp][j0 + p][K] = db[p];
      if constexpr (Link::NX > 0) red_s[warp][j0 + p][K + 1] = dx[p];
    }
    __syncthreads();
    const size_t blk = blockIdx.x;
    for (int i = tid; i < TMI * NC; i += THREADS) {
      int j = i / NC, c = i % NC, gj = m0 + j;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red_s[w][j][c];
      if (c < K) {
        if (k0 + c < kt) part_da[(blk * M + gj) * kt + k0 + c] = sum;
      } else if (!first) {
        continue;
      } else if (c == K) {
        part_db[blk * M + gj] = sum;
      } else {
        part_dg[blk * M + gj] = sum;
      }
    }
    __syncthreads();  // a_s, p_s and red_s are rewritten by the next tile
  }

  const float ll_warp = vibo::write_dtheta_ll<K>(
      dth, llp, s0 + warp * SPT, B, dtheta, dt_sb, dt_sk,
      first ? ll_person : nullptr, k0, kt);
  if (!first) return;  // the whole block leaves: no barrier follows
  // red_s is free: the tile loop's last barrier follows its last read
  float* ll_s = &red_s[0][0][0];
  if (lane == 0) ll_s[warp] = ll_warp;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < NWARP; ++w) sum += ll_s[w];
    part_ll[blockIdx.x] = sum;
  }
}

// Sums the per-block partials in block order: da (M*K), db (M), dg (M, when
// part_dg is not null), ll (1).
__global__ void loglik_train_reduce_kernel(const float* __restrict__ part_da,
                                           const float* __restrict__ part_db,
                                           const float* __restrict__ part_dg,
                                           const float* __restrict__ part_ll,
                                           float* __restrict__ da,
                                           float* __restrict__ db,
                                           float* __restrict__ dg,
                                           float* __restrict__ ll, int nblk,
                                           int M, int K) {
  const size_t n_da = static_cast<size_t>(M) * K;
  const size_t n_dg = part_dg != nullptr ? M : 0;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float sum = 0.f;
  if (i < n_da) {
    for (int k = 0; k < nblk; ++k) sum += part_da[k * n_da + i];
    da[i] = sum;
  } else if (i < n_da + M) {
    const size_t j = i - n_da;
    for (int k = 0; k < nblk; ++k) sum += part_db[static_cast<size_t>(k) * M + j];
    db[j] = sum;
  } else if (i < n_da + M + n_dg) {
    const size_t j = i - n_da - M;
    for (int k = 0; k < nblk; ++k) sum += part_dg[static_cast<size_t>(k) * M + j];
    dg[j] = sum;
  } else if (i == n_da + M + n_dg) {
    for (int k = 0; k < nblk; ++k) sum += part_ll[k];
    ll[0] = sum;
  }
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch_train(const float* theta, long long th_sb, long long th_sk,
                         const float* a, const float* b, const float* gh,
                         const int8_t* pk, float* dtheta, long long dt_sb,
                         long long dt_sk, float* ll_person, float* part_da,
                         float* part_db, float* part_dg, float* part_ll,
                         int nblk, int B, int M, cudaStream_t stream,
                         int kt = K, int k0 = 0) {
  loglik_train_kernel<Link, K, WIDE><<<nblk, THREADS, 0, stream>>>(
      theta, th_sb, th_sk, a, b, gh, pk, dtheta, dt_sb, dt_sk, ll_person,
      part_da, part_db, part_dg, part_ll, B, M, kt, k0);
  return cudaGetLastError();
}

// The C entry points' common body; gh, part_dg and dg are null for 2PL.
template <class Link>
int train_entry(const void* theta, long long th_sb, long long th_sk,
                const void* a, const void* b, const void* gh, const void* pk,
                void* dtheta, long long dt_sb, long long dt_sk,
                void* ll_person, void* part_da, void* part_db, void* part_dg,
                void* part_ll, void* da, void* db, void* dg, void* ll, int B,
                int M, int K, int scratch_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nblk = (B + TBS - 1) / TBS;
  if (scratch_blocks != nblk) return static_cast<int>(cudaErrorInvalidValue);
  if (nblk > 0) {
    const float* t = static_cast<const float*>(theta);
    const float* av = static_cast<const float*>(a);
    const float* bv = static_cast<const float*>(b);
    const float* gv = static_cast<const float*>(gh);
    const int8_t* p = static_cast<const int8_t*>(pk);
    float* dt = static_cast<float*>(dtheta);
    float* lp = static_cast<float*>(ll_person);
    float* pa = static_cast<float*>(part_da);
    float* pb = static_cast<float*>(part_db);
    float* pg = static_cast<float*>(part_dg);
    float* pl = static_cast<float*>(part_ll);
    cudaError_t err;
    switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    err = launch_train<Link, KK>(t, th_sb, th_sk, av, bv, gv, p, dt, dt_sb, \
                                 dt_sk, lp, pa, pb, pg, pl, nblk, B, M,     \
                                 stream);                                   \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
      default:  // K > 8: one wide pass a chunk of KC dims
        err = K < 1 ? cudaErrorInvalidValue : cudaSuccess;
        for (int k0 = 0; k0 < K && err == cudaSuccess; k0 += vibo::KC)
          err = launch_train<Link, vibo::KC, true>(
              t, th_sb, th_sk, av, bv, gv, p, dt, dt_sb, dt_sk, lp, pa, pb, pg,
              pl, nblk, B, M, stream, K, k0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n_out = static_cast<size_t>(M) * K + M +
                       (part_dg != nullptr ? M : 0) + 1;
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((n_out + threads - 1) / threads);
  loglik_train_reduce_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const float*>(part_da), static_cast<const float*>(part_db),
      static_cast<const float*>(part_dg), static_cast<const float*>(part_ll),
      static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dg), static_cast<float*>(ll), nblk, M, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// theta/dtheta: f32 at theta[i*th_sb + k*th_sk]; a (M, K), b (M,) f32
// contiguous; pk (B, M) int8 contiguous; ll_person (B,) or null; scratch
// part_da (nblk, M, K), part_db (nblk, M), part_ll (nblk,) with
// nblk = ceil(B / 64), which the caller passes so a mismatch is refused
// instead of overrunning the scratch; outputs da (M, K), db (M,), ll (1,).
int loglik_2pl_train(const void* theta, long long th_sb, long long th_sk,
                     const void* a, const void* b, const void* pk,
                     void* dtheta, long long dt_sb, long long dt_sk,
                     void* ll_person, void* part_da, void* part_db,
                     void* part_ll, void* da, void* db, void* ll, int B, int M,
                     int K, int scratch_blocks, void* stream_ptr) {
  return train_entry<Link2PL>(theta, th_sb, th_sk, a, b, nullptr, pk, dtheta,
                              dt_sb, dt_sk, ll_person, part_da, part_db,
                              nullptr, part_ll, da, db, nullptr, ll, B, M, K,
                              scratch_blocks, stream_ptr);
}

// As loglik_2pl_train, with the guess logits g_hat (M,) f32, the scratch
// part_dg (nblk, M) and the output dg (M,).
int loglik_3pl_train(const void* theta, long long th_sb, long long th_sk,
                     const void* a, const void* b, const void* g_hat,
                     const void* pk, void* dtheta, long long dt_sb,
                     long long dt_sk, void* ll_person, void* part_da,
                     void* part_db, void* part_dg, void* part_ll, void* da,
                     void* db, void* dg, void* ll, int B, int M, int K,
                     int scratch_blocks, void* stream_ptr) {
  return train_entry<Link3PL>(theta, th_sb, th_sk, a, b, g_hat, pk, dtheta,
                              dt_sb, dt_sk, ll_person, part_da, part_db,
                              part_dg, part_ll, da, db, dg, ll, B, M, K,
                              scratch_blocks, stream_ptr);
}

}  // extern "C"
