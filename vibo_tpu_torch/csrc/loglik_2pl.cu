// One-pass 2PL training log-likelihood on the int8 response code.
//
// Replaces the TPU Pallas kernels of vibo_tpu/ops/pallas_elbo.py:
//   _fused_train_fwd_t (:1244), body _fused_train_kernel_packed_t (:1183):
//       theta^T (K, B) -> scalar sum of ll, dtheta^T, da, db
//   _fused_train_fwd (:613), body _fused_train_kernel_packed (:569):
//       theta (B, K) -> per-person ll (B,), dtheta, da, db
// One source serves both: theta and dtheta are addressed through explicit
// (student, ability) strides. Per cell, exactly the Pallas body:
//   l = theta . a_j - b_j,  e = exp(-|l|),  sp = log1p(e) + max(l, 0)
//   ll = -m * (r ? sp - l : sp),  s = sigmoid(l) from 1/(1+e),  dl = m*(r - s)
//   dtheta_i += dl a_j,  da_j += dl theta_i,  db_j -= dl
// with the code c (0 = missing, 1 = wrong, 2 = right): m = min(c, 1),
// r = max(c - 1, 0).
//
// What bounds it on an H100: it must read the B*M int8 code once (10.5 MB
// at B=10240, M=1024: ~3.1 us at 3.35 TB/s) and do 6K+16 f32 operations
// per cell (~6.3 us at 67 TFLOP/s for K=4) with one exp and one log1p, so
// operations bound it, close to the memory bound.
//
// The simple design: a block owns 64 students and loops over all items in
// tiles of 128, with the tile's a (128 x K) and b staged in shared memory.
// A warp takes 8 students, a lane 4 consecutive items, so a warp reads 128
// contiguous bytes of each student's row. dtheta (and the per-person ll)
// accumulate per student in registers across all item tiles and are summed
// over the lanes by warp shuffles once at the end: no atomics. The per-item
// da/db of a tile are summed over the block's 8 warps in shared memory and
// written as the block's partial to a (num_blocks, M, K+1) scratch buffer,
// with the block's sum of ll; a second kernel sums the partials over blocks
// in a fixed order, so every output is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TBS = 64;                 // students per block
constexpr int TMI = 128;                // items per tile
constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int SPT = TBS / NWARP;        // students per warp (and per thread)
constexpr int IPT = TMI / 32;           // consecutive items per lane

template <int K>
__global__ void __launch_bounds__(THREADS)
loglik_2pl_train_kernel(const float* __restrict__ theta, long long th_sb,
                        long long th_sk, const float* __restrict__ a,
                        const float* __restrict__ b,
                        const int8_t* __restrict__ pk,
                        float* __restrict__ dtheta, long long dt_sb,
                        long long dt_sk, float* __restrict__ ll_person,
                        float* __restrict__ part_da,
                        float* __restrict__ part_db,
                        float* __restrict__ part_ll, int B, int M) {
  __shared__ float th_s[TBS][K];
  __shared__ float a_s[TMI][K];
  __shared__ float b_s[TMI];
  __shared__ float red_s[NWARP][TMI][K + 1];
  __shared__ float ll_s[NWARP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS;
  const bool vec = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(pk) % 4 == 0);

  for (int i = tid; i < TBS * K; i += THREADS) {
    int s = i / K, k = i % K, gs = s0 + s;
    th_s[s][k] = gs < B ? theta[gs * th_sb + k * th_sk] : 0.f;
  }

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
      a_s[j][k] = gj < M ? a[static_cast<size_t>(gj) * K + k] : 0.f;
    }
    for (int j = tid; j < TMI; j += THREADS)
      b_s[j] = m0 + j < M ? b[m0 + j] : 0.f;
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
    for (int q = 0; q < SPT; ++q) {
      const int s = warp * SPT + q, gs = s0 + s;
      int8_t code[IPT];
      const int gj = m0 + j0;
      const int8_t* row = pk + static_cast<size_t>(gs) * M + gj;
      if (gs < B && vec && gj + IPT <= M) {
        char4 v = *reinterpret_cast<const char4*>(row);
        code[0] = v.x; code[1] = v.y; code[2] = v.z; code[3] = v.w;
      } else {
#pragma unroll
        for (int p = 0; p < IPT; ++p)
          code[p] = (gs < B && gj + p < M) ? row[p] : int8_t(0);
      }
      float th[K];
#pragma unroll
      for (int k = 0; k < K; ++k) th[k] = th_s[s][k];
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) dot = fmaf(th[k], aj[p][k], dot);
        const float l = dot - bj[p];
        const float c = static_cast<float>(code[p]);
        const float mk = fminf(c, 1.f), r = fmaxf(c - 1.f, 0.f);
        const float e = expf(-fabsf(l));
        const float sp = log1pf(e) + fmaxf(l, 0.f);
        llp[q] += -mk * (r > 0.5f ? sp - l : sp);
        const float inv = 1.f / (1.f + e);
        const float sg = l >= 0.f ? inv : 1.f - inv;
        const float dl = mk * (r - sg);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dth[q][k] = fmaf(dl, aj[p][k], dth[q][k]);
          da[p][k] = fmaf(dl, th[k], da[p][k]);
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
    const size_t blk = blockIdx.x;
    for (int i = tid; i < TMI * (K + 1); i += THREADS) {
      int j = i / (K + 1), c = i % (K + 1), gj = m0 + j;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red_s[w][j][c];
      if (c < K)
        part_da[(blk * M + gj) * K + c] = sum;
      else
        part_db[blk * M + gj] = sum;
    }
    __syncthreads();  // a_s, b_s and red_s are rewritten by the next tile
  }

  float ll_warp = 0.f;
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int gs = s0 + warp * SPT + q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = dth[q][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && gs < B) dtheta[gs * dt_sb + k * dt_sk] = v;
    }
    float v = llp[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && gs < B && ll_person != nullptr) ll_person[gs] = v;
    ll_warp += v;
  }
  if (lane == 0) ll_s[warp] = ll_warp;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < NWARP; ++w) sum += ll_s[w];
    part_ll[blockIdx.x] = sum;
  }
}

// Sums the per-block partials in block order: da (M*K), db (M), ll (1).
__global__ void loglik_2pl_reduce_kernel(const float* __restrict__ part_da,
                                         const float* __restrict__ part_db,
                                         const float* __restrict__ part_ll,
                                         float* __restrict__ da,
                                         float* __restrict__ db,
                                         float* __restrict__ ll, int nblk,
                                         int M, int K) {
  const size_t n_da = static_cast<size_t>(M) * K;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float sum = 0.f;
  if (i < n_da) {
    for (int k = 0; k < nblk; ++k) sum += part_da[k * n_da + i];
    da[i] = sum;
  } else if (i < n_da + M) {
    const size_t j = i - n_da;
    for (int k = 0; k < nblk; ++k) sum += part_db[static_cast<size_t>(k) * M + j];
    db[j] = sum;
  } else if (i == n_da + M) {
    for (int k = 0; k < nblk; ++k) sum += part_ll[k];
    ll[0] = sum;
  }
}

template <int K>
cudaError_t launch_train(const float* theta, long long th_sb, long long th_sk,
                         const float* a, const float* b, const int8_t* pk,
                         float* dtheta, long long dt_sb, long long dt_sk,
                         float* ll_person, float* part_da, float* part_db,
                         float* part_ll, int nblk, int B, int M,
                         cudaStream_t stream) {
  loglik_2pl_train_kernel<K><<<nblk, THREADS, 0, stream>>>(
      theta, th_sb, th_sk, a, b, pk, dtheta, dt_sb, dt_sk, ll_person, part_da,
      part_db, part_ll, B, M);
  return cudaGetLastError();
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
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nblk = (B + TBS - 1) / TBS;
  if (scratch_blocks != nblk) return static_cast<int>(cudaErrorInvalidValue);
  if (nblk > 0) {
    const float* t = static_cast<const float*>(theta);
    const float* av = static_cast<const float*>(a);
    const float* bv = static_cast<const float*>(b);
    const int8_t* p = static_cast<const int8_t*>(pk);
    float* dt = static_cast<float*>(dtheta);
    float* lp = static_cast<float*>(ll_person);
    float* pa = static_cast<float*>(part_da);
    float* pb = static_cast<float*>(part_db);
    float* pl = static_cast<float*>(part_ll);
    cudaError_t err;
    switch (K) {
#define VIBO_CASE(KK)                                                        \
  case KK:                                                                   \
    err = launch_train<KK>(t, th_sb, th_sk, av, bv, p, dt, dt_sb, dt_sk, lp, \
                           pa, pb, pl, nblk, B, M, stream);                  \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n_out = static_cast<size_t>(M) * K + M + 1;
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((n_out + threads - 1) / threads);
  loglik_2pl_reduce_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const float*>(part_da), static_cast<const float*>(part_db),
      static_cast<const float*>(part_ll), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(ll), nblk, M, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
