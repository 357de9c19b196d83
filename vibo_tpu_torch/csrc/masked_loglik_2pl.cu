// General masked 2PL Bernoulli log-likelihood and its exact VJP, on dense
// f32 (resp, mask) or on the int8 response code.
//
// Replaces the TPU Pallas kernels of vibo_tpu/ops/pallas_elbo.py:
//   _fwd_pallas (:247), body _fwd_kernel (:229): dense forward
//   _bwd_pallas (:319), bodies _bwd_dtheta_kernel (:278) and
//       _bwd_items_kernel (:296): dense VJP
//   _fwd_pallas_packed (:445), body _fwd_kernel_packed (:373): int8 forward
//   _bwd_pallas_packed (:468), bodies _bwd_dtheta_kernel_packed (:392) and
//       _bwd_items_kernel_packed (:410): int8 VJP
// One source serves both inputs: the kernels are templated on the cell
// reader (dense: m = mask, r = resp; int8 code c: m = min(c, 1),
// r = max(c - 1, 0)) and on K = 1..8. Per cell, the Pallas bodies' math:
//   l = theta_i . a_j - b_j,  e = exp(-|l|)
//   ll_i += m * ((r*l - max(l, 0)) - log1p(e))        (= m*(r*l - softplus(l)))
//   dl = g_i * m * (r - sigmoid(l)),  sigmoid(l) = l >= 0 ? 1/(1+e) : e/(1+e)
//   dtheta_i += dl a_j,  da_j += dl theta_i,  db_j -= dl
// The VJP is exact for ANY per-person cotangent g (the contract that sets
// this op apart from the uniform-cotangent one-pass training kernel of
// loglik_2pl.cu).
//
// Leading sample axis: grid dimension y runs the S samples of one call;
// theta, g, ll and dtheta carry the axis, a, b and the data each carry it or
// are shared (sample stride 0). A shared a (or b) gets the gradient summed
// over samples.
//
// What bounds it on an H100, at the minibatch shape B = 4,096, M = 1,024,
// K = 4: the dense reader moves 8 bytes a cell (33.6 MB, ~10 us at
// 3.35 TB/s) in both directions, so bytes bound it; the int8 forward reads
// 4.2 MB (~1.25 us), and the int8 backward does 6K+10 f32 operations a cell
// (~2.1 us at 67 TFLOP/s), so operations bound it.
//
// The simple design. Forward: a block of 8 warps owns 16 students (2 per
// warp) and walks all items in tiles of 128, with the tile's a and b staged
// in shared memory; a lane reads 4 neighbouring items of a row (one float4 of
// resp and one of mask, or 4 bytes of code; a scalar tail for ragged M or
// unaligned rows) and a warp-shuffle sum gives the per-person ll. A block
// owns whole rows, so no cross-block reduction is needed. Backward: ONE pass
// over the data (Pallas needs two, one per grid accumulation axis): a block
// owns 32 students (4 per warp), keeps their dtheta in registers, sums the
// tile's da/db over its warps in shared memory and writes them as the
// block's partial; a second kernel sums the partials in block order. No
// float atomics: every output is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int K>
__device__ __forceinline__ void stage_items(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            int m0, int M, float (*a_s)[K],
                                            float* b_s) {
  for (int i = threadIdx.x; i < TMI * K; i += THREADS) {
    const int j = i / K, k = i % K, gj = m0 + j;
    a_s[j][k] = gj < M ? a[static_cast<size_t>(gj) * K + k] : 0.f;
  }
  for (int j = threadIdx.x; j < TMI; j += THREADS)
    b_s[j] = m0 + j < M ? b[m0 + j] : 0.f;
}

template <int K, bool PACKED>
__global__ void __launch_bounds__(THREADS)
masked_fwd_kernel(const float* __restrict__ theta, const float* __restrict__ a,
                  long long a_ss, const float* __restrict__ b, long long b_ss,
                  const float* __restrict__ resp,
                  const float* __restrict__ mask,
                  const int8_t* __restrict__ pk, long long d_ss,
                  float* __restrict__ ll, int B, int M) {
  __shared__ float a_s[TMI][K];
  __shared__ float b_s[TMI];
  const size_t s = blockIdx.y;
  theta += s * B * K;
  a += s * a_ss;
  b += s * b_ss;
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
      th[q][k] = s0 + q < B ? theta[static_cast<size_t>(s0 + q) * K + k] : 0.f;
  }

  const int j0 = lane * IPT;
  for (int m0 = 0; m0 < M; m0 += TMI) {
    stage_items<K>(a, b, m0, M, a_s, b_s);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < FWD_SPW; ++q) {
      const int gs = s0 + q;
      float mk[IPT], r[IPT];
      read_cells<PACKED>(resp, mask, pk, static_cast<size_t>(gs) * M,
                         m0 + j0, M, gs < B, vec, mk, r);
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) dot = fmaf(th[q][k], a_s[j0 + p][k], dot);
        const float l = dot - b_s[j0 + p];
        const float e = expf(-fabsf(l));
        acc[q] += mk[p] * ((r[p] * l - fmaxf(l, 0.f)) - log1pf(e));
      }
    }
    __syncthreads();  // a_s, b_s are rewritten by the next tile
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

template <int K, bool PACKED>
__global__ void __launch_bounds__(THREADS)
masked_bwd_kernel(const float* __restrict__ g, const float* __restrict__ theta,
                  const float* __restrict__ a, long long a_ss,
                  const float* __restrict__ b, long long b_ss,
                  const float* __restrict__ resp,
                  const float* __restrict__ mask,
                  const int8_t* __restrict__ pk, long long d_ss,
                  float* __restrict__ dtheta, float* __restrict__ part_da,
                  float* __restrict__ part_db, int B, int M) {
  __shared__ float a_s[TMI][K];
  __shared__ float b_s[TMI];
  __shared__ float red_s[NWARP][TMI][K + 1];
  const size_t s = blockIdx.y;
  g += s * B;
  theta += s * B * K;
  dtheta += s * B * K;
  a += s * a_ss;
  b += s * b_ss;
  if constexpr (PACKED) {
    pk += s * d_ss;
  } else {
    resp += s * d_ss;
    mask += s * d_ss;
  }
  const size_t blk = s * gridDim.x + blockIdx.x;   // partial's index
  part_da += blk * M * K;
  part_db += blk * M;
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
      th[q][k] = ok ? theta[static_cast<size_t>(s0 + q) * K + k] : 0.f;
      dth[q][k] = 0.f;
    }
  }

  const int j0 = lane * IPT;
  for (int m0 = 0; m0 < M; m0 += TMI) {
    stage_items<K>(a, b, m0, M, a_s, b_s);
    __syncthreads();
    float aj[IPT][K], bj[IPT], da[IPT][K], db[IPT];
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
      bj[p] = b_s[j0 + p];
      db[p] = 0.f;
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
#pragma unroll
        for (int k = 0; k < K; ++k) dot = fmaf(th[q][k], aj[p][k], dot);
        const float l = dot - bj[p];
        const float e = expf(-fabsf(l));
        const float inv = 1.f / (1.f + e);
        const float sg = l >= 0.f ? inv : e * inv;
        const float dl = gi[q] * (mk[p] * (r[p] - sg));
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dth[q][k] = fmaf(dl, aj[p][k], dth[q][k]);
          da[p][k] = fmaf(dl, th[q][k], da[p][k]);
        }
        db[p] -= dl;
      }
    }
#pragma unroll
    for (int p = 0; p < IPT; ++p) {
#pragma unroll
      for (int k = 0; k < K; ++k) red_s[warp][j0 + p][k] = da[p][k];
      red_s[warp][j0 + p][K] = db[p];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TMI * (K + 1); i += THREADS) {
      const int j = i / (K + 1), c = i % (K + 1), gj = m0 + j;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red_s[w][j][c];
      if (c < K)
        part_da[static_cast<size_t>(gj) * K + c] = sum;
      else
        part_db[gj] = sum;
    }
    __syncthreads();  // a_s, b_s and red_s are rewritten by the next tile
  }

#pragma unroll
  for (int q = 0; q < BWD_SPW; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = dth[q][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && s0 + q < B)
        dtheta[static_cast<size_t>(s0 + q) * K + k] = v;
    }
  }
}

// Sums the partials in block order: da (Sa, M, K) and db (Sb, M), where a
// shared a (Sa = 1) sums the partials of all S samples, and a per-sample a
// (Sa = S) those of its own sample (likewise b).
__global__ void masked_reduce_kernel(const float* __restrict__ part_da,
                                     const float* __restrict__ part_db,
                                     float* __restrict__ da,
                                     float* __restrict__ db, int S, int nblk,
                                     int M, int K, int a_shared,
                                     int b_shared) {
  const size_t n_da = static_cast<size_t>(a_shared ? 1 : S) * M * K;
  const size_t n_db = static_cast<size_t>(b_shared ? 1 : S) * M;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float* part;
  size_t width, so, col;
  int shared;
  if (i < n_da) {
    width = static_cast<size_t>(M) * K;
    so = i / width; col = i % width; part = part_da; shared = a_shared;
  } else if (i < n_da + n_db) {
    width = M;
    so = (i - n_da) / width; col = (i - n_da) % width; part = part_db;
    shared = b_shared;
  } else {
    return;
  }
  const size_t lo = shared ? 0 : so, hi = shared ? S : so + 1;
  float sum = 0.f;
  for (size_t t = lo; t < hi; ++t)
    for (int k = 0; k < nblk; ++k)
      sum += part[(t * nblk + k) * width + col];
  if (i < n_da) da[i] = sum; else db[i - n_da] = sum;
}

template <int K>
cudaError_t launch_fwd(const float* theta, const float* a, long long a_ss,
                       const float* b, long long b_ss, const float* resp,
                       const float* mask, const int8_t* pk, long long d_ss,
                       float* ll, int S, int B, int M, cudaStream_t stream) {
  const dim3 grid((B + FWD_TBS - 1) / FWD_TBS, S);
  if (pk != nullptr)
    masked_fwd_kernel<K, true><<<grid, THREADS, 0, stream>>>(
        theta, a, a_ss, b, b_ss, resp, mask, pk, d_ss, ll, B, M);
  else
    masked_fwd_kernel<K, false><<<grid, THREADS, 0, stream>>>(
        theta, a, a_ss, b, b_ss, resp, mask, pk, d_ss, ll, B, M);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_bwd(const float* g, const float* theta, const float* a,
                       long long a_ss, const float* b, long long b_ss,
                       const float* resp, const float* mask, const int8_t* pk,
                       long long d_ss, float* dtheta, float* part_da,
                       float* part_db, int S, int B, int M, int nblk,
                       cudaStream_t stream) {
  const dim3 grid(nblk, S);
  if (pk != nullptr)
    masked_bwd_kernel<K, true><<<grid, THREADS, 0, stream>>>(
        g, theta, a, a_ss, b, b_ss, resp, mask, pk, d_ss, dtheta, part_da,
        part_db, B, M);
  else
    masked_bwd_kernel<K, false><<<grid, THREADS, 0, stream>>>(
        g, theta, a, a_ss, b, b_ss, resp, mask, pk, d_ss, dtheta, part_da,
        part_db, B, M);
  return cudaGetLastError();
}

bool bad_sizes(int S, int B, int M, int K) {
  return S < 1 || S > 65535 || B < 0 || M < 0 || K < 1 || K > 8;
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
  if (bad_sizes(S, B, M, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* t = static_cast<const float*>(theta);
  const float* av = static_cast<const float*>(a);
  const float* bv = static_cast<const float*>(b);
  const float* rv = static_cast<const float*>(resp);
  const float* mv = static_cast<const float*>(mask);
  const int8_t* p = static_cast<const int8_t*>(pk);
  float* out = static_cast<float*>(ll);
  cudaError_t err = cudaErrorInvalidValue;
  switch (K) {
#define VIBO_CASE(KK)                                                     \
  case KK:                                                                \
    err = launch_fwd<KK>(t, av, a_ss, bv, b_ss, rv, mv, p, d_ss, out, S, \
                         B, M, stream);                                   \
    break;
    VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
    VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
  }
  return static_cast<int>(err);
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
  if (bad_sizes(S, B, M, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (B + BWD_TBS - 1) / BWD_TBS;
  if (scratch_blocks != nblk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nblk > 0) {
    const float* gv = static_cast<const float*>(g);
    const float* t = static_cast<const float*>(theta);
    const float* av = static_cast<const float*>(a);
    const float* bv = static_cast<const float*>(b);
    const float* rv = static_cast<const float*>(resp);
    const float* mv = static_cast<const float*>(mask);
    const int8_t* p = static_cast<const int8_t*>(pk);
    float* dt = static_cast<float*>(dtheta);
    float* pa = static_cast<float*>(part_da);
    float* pb = static_cast<float*>(part_db);
    cudaError_t err = cudaErrorInvalidValue;
    switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    err = launch_bwd<KK>(gv, t, av, a_ss, bv, b_ss, rv, mv, p, d_ss, dt,   \
                         pa, pb, S, B, M, nblk, stream);                    \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int a_shared = a_ss == 0, b_shared = b_ss == 0;
  const size_t n_out = static_cast<size_t>(a_shared ? 1 : S) * M * K +
                       static_cast<size_t>(b_shared ? 1 : S) * M;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((n_out + threads - 1) / threads);
  masked_reduce_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const float*>(part_da), static_cast<const float*>(part_db),
      static_cast<float*>(da), static_cast<float*>(db), S, nblk, M, K,
      a_shared, b_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
