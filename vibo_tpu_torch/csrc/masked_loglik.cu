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
// Leading sample axis: grid dimension y runs the S samples of one call;
// theta, g, ll and dtheta carry the axis, a, b, g_hat and the data each
// carry it or are shared (sample stride 0). A shared a (or b, g_hat) gets
// the gradient summed over samples.
//
// What bounds it on an H100, at the minibatch shape B = 4,096, M = 1,024,
// K = 4: the dense reader moves 8 bytes a cell (33.6 MB, ~10 us at
// 3.35 TB/s) in both directions, so bytes bound the 2PL kernels; the int8
// forward reads 4.2 MB (~1.25 us), so there the special-function results of
// the cell (exp, log1p, reciprocals: chip_smoke.py counts them in this
// library's SASS, at 16 a clock an SM) or its f32 operations bound it. The
// 3PL cell takes about three times the special functions of the 2PL cell.
//
// The simple design. Forward: a block of 8 warps owns 16 students (2 per
// warp) and walks all items in tiles of 128, with the tile's a and the
// link's per-item constants (b; for 3PL also log g, log(1-g) and g,
// computed once per item, not once per cell) staged in shared memory; a
// lane reads 4 neighbouring items of a row (one float4 of resp and one of
// mask, or 4 bytes of code; a scalar tail for ragged M or unaligned rows)
// and a warp-shuffle sum gives the per-person ll. A block owns whole rows,
// so no cross-block reduction is needed. Backward: ONE pass over the data
// (Pallas needs two, one per grid accumulation axis): a block owns 32
// students (4 per warp), keeps their dtheta in registers, sums the tile's
// da/db(/dg) over its warps in shared memory and writes them as the block's
// partial; a second kernel sums the partials in block order. No float
// atomics: every output is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "irt_links.cuh"
#include "loglik_tile.cuh"  // KC, wide_dot: the K > 8 variant

namespace {

using vibo::Link2PL;
using vibo::Link3PL;

constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int TMI = 128;                  // items per tile
constexpr int IPT = TMI / 32;             // neighbouring items per lane
constexpr int FWD_SPW = 2;                // forward: students per warp
constexpr int FWD_TBS = NWARP * FWD_SPW;  // forward: students per block
constexpr int BWD_SPW = 4;                // backward: students per warp
constexpr int BWD_TBS = NWARP * BWD_SPW;  // backward: students per block

// The 4 cells (m, r) of row `row` at items gj..gj+3 (zero outside [0, M)).
template <bool PACKED>
__device__ __forceinline__ void read_cells(const float* __restrict__ resp,
                                           const float* __restrict__ mask,
                                           const int8_t* __restrict__ pk,
                                           size_t row, int gj, int M,
                                           bool in_row, bool vec,
                                           float (&mk)[IPT], float (&r)[IPT]) {
  if constexpr (PACKED) {
    int8_t c[IPT];
    const int8_t* p = pk + row + gj;
    if (in_row && vec && gj + IPT <= M) {
      const char4 v = *reinterpret_cast<const char4*>(p);
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < IPT; ++q)
        c[q] = (in_row && gj + q < M) ? p[q] : int8_t(0);
    }
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const float f = static_cast<float>(c[q]);
      mk[q] = fminf(f, 1.f);
      r[q] = fmaxf(f - 1.f, 0.f);
    }
  } else {
    const float* pr = resp + row + gj;
    const float* pm = mask + row + gj;
    if (in_row && vec && gj + IPT <= M) {
      const float4 vr = *reinterpret_cast<const float4*>(pr);
      const float4 vm = *reinterpret_cast<const float4*>(pm);
      r[0] = vr.x; r[1] = vr.y; r[2] = vr.z; r[3] = vr.w;
      mk[0] = vm.x; mk[1] = vm.y; mk[2] = vm.z; mk[3] = vm.w;
    } else {
#pragma unroll
      for (int q = 0; q < IPT; ++q) {
        const bool ok = in_row && gj + q < M;
        r[q] = ok ? pr[q] : 0.f;
        mk[q] = ok ? pm[q] : 0.f;
      }
    }
  }
}

// True when every row of the data starts on a vector boundary.
template <bool PACKED>
__device__ __forceinline__ bool rows_aligned(const float* resp,
                                             const float* mask,
                                             const int8_t* pk, int M,
                                             long long d_ss) {
  if constexpr (PACKED)
    return M % 4 == 0 && d_ss % 4 == 0 &&
           reinterpret_cast<uintptr_t>(pk) % 4 == 0;
  return M % 4 == 0 && d_ss % 4 == 0 &&
         reinterpret_cast<uintptr_t>(resp) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(mask) % 16 == 0;
}

// Stages the tile's a (TMI x K; the wide variant the dims k0 .. k0 + K - 1
// of kt, zero past kt) and the link's per-item constants.
template <class Link, int K>
__device__ __forceinline__ void stage_items(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            const float* __restrict__ gh,
                                            int m0, int M, float (*a_s)[K],
                                            float (*p_s)[TMI], int k0 = 0,
                                            int kt = K) {
  for (int i = threadIdx.x; i < TMI * K; i += THREADS) {
    const int j = i / K, k = i % K, gj = m0 + j;
    a_s[j][k] = gj < M && k0 + k < kt
                    ? a[static_cast<size_t>(gj) * kt + k0 + k] : 0.f;
  }
  for (int j = threadIdx.x; j < TMI; j += THREADS) {
    const int gj = m0 + j;
    float ghj = 0.f;
    if constexpr (Link::NX > 0) ghj = gj < M ? gh[gj] : 0.f;
    float p[Link::NP];
    Link::stage(gj < M ? b[gj] : 0.f, ghj, p);
#pragma unroll
    for (int x = 0; x < Link::NP; ++x) p_s[x][j] = p[x];
  }
}

// WIDE: K = KC, the logit over all kt dims by wide_dot (one pass).
template <class Link, int K, bool PACKED, bool WIDE>
__global__ void __launch_bounds__(THREADS)
masked_fwd_kernel(const float* __restrict__ theta, const float* __restrict__ a,
                  long long a_ss, const float* __restrict__ b, long long b_ss,
                  const float* __restrict__ gh, long long g_ss,
                  const float* __restrict__ resp,
                  const float* __restrict__ mask,
                  const int8_t* __restrict__ pk, long long d_ss,
                  float* __restrict__ ll, int B, int M, int kt_arg) {
  constexpr int NP = Link::NP;
  const int kt = WIDE ? kt_arg : K;
  __shared__ float a_s[TMI][K];
  __shared__ float p_s[NP][TMI];
  const size_t s = blockIdx.y;
  theta += s * B * kt;
  a += s * a_ss;
  b += s * b_ss;
  if constexpr (Link::NX > 0) gh += s * g_ss;
  ll += s * B;
  if constexpr (PACKED) {
    pk += s * d_ss;
  } else {
    resp += s * d_ss;
    mask += s * d_ss;
  }
  const bool vec = rows_aligned<PACKED>(resp, mask, pk, M, d_ss);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * FWD_TBS + warp * FWD_SPW;
  float th[FWD_SPW][K], acc[FWD_SPW];
#pragma unroll
  for (int q = 0; q < FWD_SPW; ++q) {
    acc[q] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      th[q][k] = s0 + q < B && k < kt
                     ? theta[static_cast<size_t>(s0 + q) * kt + k] : 0.f;
  }

  const int j0 = lane * IPT;
  for (int m0 = 0; m0 < M; m0 += TMI) {
    stage_items<Link, K>(a, b, gh, m0, M, a_s, p_s, 0, kt);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < FWD_SPW; ++q) {
      const int gs = s0 + q;
      float mk[IPT], r[IPT];
      read_cells<PACKED>(resp, mask, pk, static_cast<size_t>(gs) * M,
                         m0 + j0, M, gs < B, vec, mk, r);
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float pp[NP];
#pragma unroll
        for (int x = 0; x < NP; ++x) pp[x] = p_s[x][j0 + p];
        float dot = 0.f;
        if constexpr (WIDE) {
          const int gj = m0 + j0 + p;
          if (gs < B && gj < M)
            dot = vibo::wide_dot(theta + static_cast<size_t>(gs) * kt, 1,
                                 a + static_cast<size_t>(gj) * kt, kt);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k)
            dot = fmaf(th[q][k], a_s[j0 + p][k], dot);
        }
        acc[q] += Link::value(dot - pp[0], pp, mk[p], r[p]);
      }
    }
    __syncthreads();  // a_s, p_s are rewritten by the next tile
  }

#pragma unroll
  for (int q = 0; q < FWD_SPW; ++q) {
    float v = acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && s0 + q < B) ll[s0 + q] = v;
  }
}

// WIDE: K = KC, one pass over the dims [k0, k0 + KC) of kt (loglik_tile.cuh).
template <class Link, int K, bool PACKED, bool WIDE>
__global__ void __launch_bounds__(THREADS)
masked_bwd_kernel(const float* __restrict__ g, const float* __restrict__ theta,
                  const float* __restrict__ a, long long a_ss,
                  const float* __restrict__ b, long long b_ss,
                  const float* __restrict__ gh, long long g_ss,
                  const float* __restrict__ resp,
                  const float* __restrict__ mask,
                  const int8_t* __restrict__ pk, long long d_ss,
                  float* __restrict__ dtheta, float* __restrict__ part_da,
                  float* __restrict__ part_db, float* __restrict__ part_dg,
                  int B, int M, int kt_arg, int k0_arg) {
  constexpr int NP = Link::NP;
  constexpr int NC = K + 1 + Link::NX;  // reduced columns: da, db[, dg]
  const int kt = WIDE ? kt_arg : K, k0 = WIDE ? k0_arg : 0;
  const bool first = k0 == 0;  // writes db and dg
  __shared__ float a_s[TMI][K];
  __shared__ float p_s[NP][TMI];
  __shared__ float red_s[NWARP][TMI][NC];
  const size_t s = blockIdx.y;
  g += s * B;
  theta += s * B * kt;
  dtheta += s * B * kt;
  a += s * a_ss;
  b += s * b_ss;
  if constexpr (PACKED) {
    pk += s * d_ss;
  } else {
    resp += s * d_ss;
    mask += s * d_ss;
  }
  const size_t blk = s * gridDim.x + blockIdx.x;   // partial's index
  part_da += blk * M * kt;
  part_db += blk * M;
  if constexpr (Link::NX > 0) {
    gh += s * g_ss;
    part_dg += blk * M;
  }
  const bool vec = rows_aligned<PACKED>(resp, mask, pk, M, d_ss);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * BWD_TBS + warp * BWD_SPW;
  float th[BWD_SPW][K], dth[BWD_SPW][K], gi[BWD_SPW];
#pragma unroll
  for (int q = 0; q < BWD_SPW; ++q) {
    const bool ok = s0 + q < B;
    gi[q] = ok ? g[s0 + q] : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      th[q][k] = ok && k0 + k < kt
                     ? theta[static_cast<size_t>(s0 + q) * kt + k0 + k] : 0.f;
      dth[q][k] = 0.f;
    }
  }

  const int j0 = lane * IPT;
  for (int m0 = 0; m0 < M; m0 += TMI) {
    stage_items<Link, K>(a, b, gh, m0, M, a_s, p_s, k0, kt);
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
    for (int q = 0; q < BWD_SPW; ++q) {
      const int gs = s0 + q;
      float mk[IPT], r[IPT];
      read_cells<PACKED>(resp, mask, pk, static_cast<size_t>(gs) * M,
                         m0 + j0, M, gs < B, vec, mk, r);
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
          for (int k = 0; k < K; ++k) dot = fmaf(th[q][k], aj[p][k], dot);
        }
        float dxc;
        const float dl =
            gi[q] * Link::grad(dot - pj[p][0], pj[p], mk[p], r[p], dxc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dth[q][k] = fmaf(dl, aj[p][k], dth[q][k]);
          da[p][k] = fmaf(dl, th[q][k], da[p][k]);
        }
        db[p] -= dl;
        if constexpr (Link::NX > 0) dx[p] += gi[q] * dxc;
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
    for (int i = threadIdx.x; i < TMI * NC; i += THREADS) {
      const int j = i / NC, c = i % NC, gj = m0 + j;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red_s[w][j][c];
      if (c < K) {
        if (k0 + c < kt) part_da[static_cast<size_t>(gj) * kt + k0 + c] = sum;
      } else if (!first) {
        continue;
      } else if (c == K) {
        part_db[gj] = sum;
      } else {
        part_dg[gj] = sum;
      }
    }
    __syncthreads();  // a_s, p_s and red_s are rewritten by the next tile
  }

#pragma unroll
  for (int q = 0; q < BWD_SPW; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = dth[q][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && s0 + q < B && k0 + k < kt)
        dtheta[static_cast<size_t>(s0 + q) * kt + k0 + k] = v;
    }
  }
}

// Sums the partials in block order: da (Sa, M, K), db (Sb, M) and, when
// part_dg is not null, dg (Sg, M), where a shared a (Sa = 1) sums the
// partials of all S samples, and a per-sample a (Sa = S) those of its own
// sample (likewise b and g_hat).
__global__ void masked_reduce_kernel(const float* __restrict__ part_da,
                                     const float* __restrict__ part_db,
                                     const float* __restrict__ part_dg,
                                     float* __restrict__ da,
                                     float* __restrict__ db,
                                     float* __restrict__ dg, int S, int nblk,
                                     int M, int K, int a_shared, int b_shared,
                                     int g_shared) {
  const size_t n_da = static_cast<size_t>(a_shared ? 1 : S) * M * K;
  const size_t n_db = static_cast<size_t>(b_shared ? 1 : S) * M;
  const size_t n_dg =
      part_dg != nullptr ? static_cast<size_t>(g_shared ? 1 : S) * M : 0;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float* part;
  float* out;
  size_t width, so, col;
  int shared;
  if (i < n_da) {
    width = static_cast<size_t>(M) * K;
    so = i / width; col = i % width; part = part_da; shared = a_shared;
    out = da + i;
  } else if (i < n_da + n_db) {
    width = M;
    so = (i - n_da) / width; col = (i - n_da) % width; part = part_db;
    shared = b_shared; out = db + (i - n_da);
  } else if (i < n_da + n_db + n_dg) {
    width = M;
    so = (i - n_da - n_db) / width; col = (i - n_da - n_db) % width;
    part = part_dg; shared = g_shared; out = dg + (i - n_da - n_db);
  } else {
    return;
  }
  const size_t lo = shared ? 0 : so, hi = shared ? S : so + 1;
  float sum = 0.f;
  for (size_t t = lo; t < hi; ++t)
    for (int k = 0; k < nblk; ++k)
      sum += part[(t * nblk + k) * width + col];
  *out = sum;
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch_fwd(const float* theta, const float* a, long long a_ss,
                       const float* b, long long b_ss, const float* gh,
                       long long g_ss, const float* resp, const float* mask,
                       const int8_t* pk, long long d_ss, float* ll, int S,
                       int B, int M, cudaStream_t stream, int kt = K) {
  const dim3 grid((B + FWD_TBS - 1) / FWD_TBS, S);
  if (pk != nullptr)
    masked_fwd_kernel<Link, K, true, WIDE><<<grid, THREADS, 0, stream>>>(
        theta, a, a_ss, b, b_ss, gh, g_ss, resp, mask, pk, d_ss, ll, B, M,
        kt);
  else
    masked_fwd_kernel<Link, K, false, WIDE><<<grid, THREADS, 0, stream>>>(
        theta, a, a_ss, b, b_ss, gh, g_ss, resp, mask, pk, d_ss, ll, B, M,
        kt);
  return cudaGetLastError();
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch_bwd(const float* g, const float* theta, const float* a,
                       long long a_ss, const float* b, long long b_ss,
                       const float* gh, long long g_ss, const float* resp,
                       const float* mask, const int8_t* pk, long long d_ss,
                       float* dtheta, float* part_da, float* part_db,
                       float* part_dg, int S, int B, int M, int nblk,
                       cudaStream_t stream, int kt = K, int k0 = 0) {
  const dim3 grid(nblk, S);
  if (pk != nullptr)
    masked_bwd_kernel<Link, K, true, WIDE><<<grid, THREADS, 0, stream>>>(
        g, theta, a, a_ss, b, b_ss, gh, g_ss, resp, mask, pk, d_ss, dtheta,
        part_da, part_db, part_dg, B, M, kt, k0);
  else
    masked_bwd_kernel<Link, K, false, WIDE><<<grid, THREADS, 0, stream>>>(
        g, theta, a, a_ss, b, b_ss, gh, g_ss, resp, mask, pk, d_ss, dtheta,
        part_da, part_db, part_dg, B, M, kt, k0);
  return cudaGetLastError();
}

bool bad_sizes(int S, int B, int M, int K) {
  return S < 1 || S > 65535 || B < 0 || M < 0 || K < 1;
}

// The forward entry points' common body; gh is null for 2PL.
template <class Link>
int fwd_entry(const void* theta, const void* a, long long a_ss,
              const void* b, long long b_ss, const void* gh, long long g_ss,
              const void* resp, const void* mask, const void* pk,
              long long d_ss, void* ll, int S, int B, int M, int K,
              void* stream_ptr) {
  if (bad_sizes(S, B, M, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* t = static_cast<const float*>(theta);
  const float* av = static_cast<const float*>(a);
  const float* bv = static_cast<const float*>(b);
  const float* gv = static_cast<const float*>(gh);
  const float* rv = static_cast<const float*>(resp);
  const float* mv = static_cast<const float*>(mask);
  const int8_t* p = static_cast<const int8_t*>(pk);
  float* out = static_cast<float*>(ll);
  cudaError_t err = cudaErrorInvalidValue;
  switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    err = launch_fwd<Link, KK>(t, av, a_ss, bv, b_ss, gv, g_ss, rv, mv, p,  \
                               d_ss, out, S, B, M, stream);                 \
    break;
    VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
    VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
    default:  // K > 8: the wide variant, one pass
      err = launch_fwd<Link, vibo::KC, true>(t, av, a_ss, bv, b_ss, gv, g_ss,
                                             rv, mv, p, d_ss, out, S, B, M,
                                             stream, K);
  }
  return static_cast<int>(err);
}

// The backward entry points' common body; gh, part_dg and dg are null for
// 2PL.
template <class Link>
int bwd_entry(const void* g, const void* theta, const void* a, long long a_ss,
              const void* b, long long b_ss, const void* gh, long long g_ss,
              const void* resp, const void* mask, const void* pk,
              long long d_ss, void* dtheta, void* part_da, void* part_db,
              void* part_dg, void* da, void* db, void* dg, int S, int B,
              int M, int K, int scratch_blocks, void* stream_ptr) {
  if (bad_sizes(S, B, M, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (B + BWD_TBS - 1) / BWD_TBS;
  if (scratch_blocks != nblk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nblk > 0) {
    const float* gv = static_cast<const float*>(g);
    const float* t = static_cast<const float*>(theta);
    const float* av = static_cast<const float*>(a);
    const float* bv = static_cast<const float*>(b);
    const float* hv = static_cast<const float*>(gh);
    const float* rv = static_cast<const float*>(resp);
    const float* mv = static_cast<const float*>(mask);
    const int8_t* p = static_cast<const int8_t*>(pk);
    float* dt = static_cast<float*>(dtheta);
    float* pa = static_cast<float*>(part_da);
    float* pb = static_cast<float*>(part_db);
    float* pg = static_cast<float*>(part_dg);
    cudaError_t err = cudaErrorInvalidValue;
    switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    err = launch_bwd<Link, KK>(gv, t, av, a_ss, bv, b_ss, hv, g_ss, rv, mv, \
                               p, d_ss, dt, pa, pb, pg, S, B, M, nblk,      \
                               stream);                                     \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
      default:  // K > 8: one wide pass a chunk of KC dims
        err = cudaSuccess;
        for (int k0 = 0; k0 < K && err == cudaSuccess; k0 += vibo::KC)
          err = launch_bwd<Link, vibo::KC, true>(gv, t, av, a_ss, bv, b_ss, hv,
                                                 g_ss, rv, mv, p, d_ss, dt, pa,
                                                 pb, pg, S, B, M, nblk, stream,
                                                 K, k0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int a_shared = a_ss == 0, b_shared = b_ss == 0, g_shared = g_ss == 0;
  const size_t n_out =
      static_cast<size_t>(a_shared ? 1 : S) * M * K +
      static_cast<size_t>(b_shared ? 1 : S) * M +
      (part_dg != nullptr ? static_cast<size_t>(g_shared ? 1 : S) * M : 0);
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((n_out + threads - 1) / threads);
  masked_reduce_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const float*>(part_da), static_cast<const float*>(part_db),
      static_cast<const float*>(part_dg), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dg), S, nblk, M, K,
      a_shared, b_shared, g_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// theta (S, B, K) f32 contiguous; a at a + s*a_ss, (M, K) contiguous, and b
// at b + s*b_ss, (M,) (a sample stride of 0 shares them over samples); the
// data at a sample stride d_ss (0 = shared): dense resp and mask (B, M) f32
// with pk null, or the int8 code pk (B, M) with resp and mask null.
// Writes ll (S, B).
int masked_loglik_2pl_fwd(const void* theta, const void* a, long long a_ss,
                          const void* b, long long b_ss, const void* resp,
                          const void* mask, const void* pk, long long d_ss,
                          void* ll, int S, int B, int M, int K,
                          void* stream_ptr) {
  return fwd_entry<Link2PL>(theta, a, a_ss, b, b_ss, nullptr, 0, resp, mask,
                            pk, d_ss, ll, S, B, M, K, stream_ptr);
}

// As masked_loglik_2pl_fwd, with the guess logits g_hat at g_hat + s*g_ss,
// (M,) f32 (g_ss = 0: shared over samples).
int masked_loglik_3pl_fwd(const void* theta, const void* a, long long a_ss,
                          const void* b, long long b_ss, const void* g_hat,
                          long long g_ss, const void* resp, const void* mask,
                          const void* pk, long long d_ss, void* ll, int S,
                          int B, int M, int K, void* stream_ptr) {
  return fwd_entry<Link3PL>(theta, a, a_ss, b, b_ss, g_hat, g_ss, resp, mask,
                            pk, d_ss, ll, S, B, M, K, stream_ptr);
}

// The VJP for the cotangent g (S, B): dtheta (S, B, K); da (Sa, M, K) and
// db (Sb, M), with Sa = 1 when a_ss == 0 (shared a) else S, likewise Sb.
// Scratch part_da (S * nblk, M, K) and part_db (S * nblk, M), with
// nblk = ceil(B / 32), which the caller passes so a mismatch is refused
// instead of overrunning the scratch. Other arguments as the forward's.
int masked_loglik_2pl_bwd(const void* g, const void* theta, const void* a,
                          long long a_ss, const void* b, long long b_ss,
                          const void* resp, const void* mask, const void* pk,
                          long long d_ss, void* dtheta, void* part_da,
                          void* part_db, void* da, void* db, int S, int B,
                          int M, int K, int scratch_blocks,
                          void* stream_ptr) {
  return bwd_entry<Link2PL>(g, theta, a, a_ss, b, b_ss, nullptr, 0, resp,
                            mask, pk, d_ss, dtheta, part_da, part_db, nullptr,
                            da, db, nullptr, S, B, M, K, scratch_blocks,
                            stream_ptr);
}

// As masked_loglik_2pl_bwd, with g_hat as in masked_loglik_3pl_fwd, the
// scratch part_dg (S * nblk, M) and the output dg (Sg, M), Sg = 1 when
// g_ss == 0 else S.
int masked_loglik_3pl_bwd(const void* g, const void* theta, const void* a,
                          long long a_ss, const void* b, long long b_ss,
                          const void* g_hat, long long g_ss, const void* resp,
                          const void* mask, const void* pk, long long d_ss,
                          void* dtheta, void* part_da, void* part_db,
                          void* part_dg, void* da, void* db, void* dg, int S,
                          int B, int M, int K, int scratch_blocks,
                          void* stream_ptr) {
  return bwd_entry<Link3PL>(g, theta, a, a_ss, b, b_ss, g_hat, g_ss, resp,
                            mask, pk, d_ss, dtheta, part_da, part_db, part_dg,
                            da, db, dg, S, B, M, K, scratch_blocks,
                            stream_ptr);
}

}  // extern "C"
