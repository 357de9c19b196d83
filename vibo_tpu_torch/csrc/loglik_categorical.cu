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
// The exponentials are kept in a per-thread shared-memory column between
// the value and the gradient: C exp a cell.
//
// What bounds it on an H100, at B = 10,240, M = 1,024, K = 4, C = 5: the
// int8 code is 10.5 MB (~3.1 us at 3.35 TB/s), the f32 operations about
// 6K + 40 a cell (~8 us at 67 TFLOP/s); the special-function (MUFU) results
// bind: GRM two exp and four reciprocals a cell, GPCM C exp and one
// reciprocal (chip_smoke.py counts them in this library's SASS).
//
// The design: loglik_tile.cuh's tile mapping (64 students a block looping
// over item tiles of 128, a warp 8 students, a lane 4 consecutive items),
// with the tile's a and the family's table staged in shared memory, the
// table as rows of TMI items in the lane-major slot order p * 32 + lane, so
// that a lane's gather by its own category never conflicts. dtheta and ll
// accumulate in registers, da in registers per item; dkappa is added straight
// into the warp's own slice of the reduce buffer (a lane owns its items'
// slots, so no two lanes write one). The tile's per-item sums over the 8
// warps are written as the block's partial, and a second kernel sums the
// partials in block order: no float atomics, deterministic. The category
// count C (3..32) is a run-time value, so the shared memory is dynamic and
// sized by C (up to ~212 KB at K = 8, C = 32, opted in above 48 KB).
// K = 1..8 are instantiated; any K > 8 runs the wide variant, a pass a
// chunk of 8 ability dims (loglik_tile.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "loglik_tile.cuh"

namespace vibo {

constexpr int RS = TMI + 1;  // reduce-buffer row stride: conflict-free reads

// The slot of tile item j in a staged row: lane-major, p * 32 + lane.
__device__ __forceinline__ int slot_of(int j) {
  return (j % IPT) * 32 + j / IPT;
}

struct LinkGRM {
  static constexpr float BIG = 50.f;       // boundary-category sentinel
  static constexpr float CLAMP = 30.f;     // base saturation
  static constexpr float GAP = -1e-6f;     // kappa_r - kappa_{r+1} clamp

  // staged rows a tile: thresholds kx (C + 1, with the sentinels), D (C)
  // and log D (C), in C + 1 staging steps an item; no per-thread scratch
  __host__ __device__ static int table_rows(int C) { return 3 * C + 1; }
  __host__ __device__ static int stage_steps(int C) { return C + 1; }
  __host__ __device__ static int scratch_rows(int) { return 0; }

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
  // dkap[t * RS] (threshold kappa_{t+1}); tab points at the item's slot.
  __device__ __forceinline__ static float cell(float dot, const float* tab,
                                               float*, float mk, int r,
                                               int C, float* dkap,
                                               float& dbase) {
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
      if (r >= 1) dkap[(r - 1) * RS] -= gx;
      if (r <= C - 2) dkap[r * RS] += gy;
    }
    return ll;
  }
};

struct LinkGPCM {
  // staged rows a tile: kappa_0 = 0, kappa_1..C-1; a per-thread column of
  // C exponentials
  __host__ __device__ static int table_rows(int C) { return C; }
  __host__ __device__ static int stage_steps(int C) { return C; }
  __host__ __device__ static int scratch_rows(int C) { return C; }

  __device__ __forceinline__ static void stage(float* tab, int sl,
                                               const float* kap, int gj,
                                               int C, int row) {
    tab[row * TMI + sl] =
        row == 0 || gj < 0
            ? 0.f
            : kap[static_cast<size_t>(gj) * (C - 1) + row - 1];
  }

  // e: this thread's scratch column (stride THREADS); every exp of the
  // cell is in the loop over the C categories.
  __device__ __forceinline__ static float cell(float base, const float* tab,
                                               float* e, float mk, int r,
                                               int C, float* dkap,
                                               float& dbase) {
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
      e[c * THREADS] = ev;
      s += ev;
      ec += static_cast<float>(c) * ev;
    }
    const float inv = 1.f / s;
    dbase = mk * (static_cast<float>(r) - ec * inv);
    if (mk != 0.f) {
#pragma unroll 1
      for (int c = 1; c < C; ++c)
        dkap[(c - 1) * RS] +=
            mk * (e[c * THREADS] * inv - (c == r ? 1.f : 0.f));
    }
    return mk * (zr - mx - logf(s));
  }
};

template <class Link>
__host__ __device__ inline size_t smem_bytes(int K, int C) {
  return sizeof(float) *
         (static_cast<size_t>(TBS) * K + TMI * K + Link::table_rows(C) * TMI +
          NWARP * (K + C - 1) * RS + Link::scratch_rows(C) * THREADS);
}

}  // namespace vibo

namespace {

using vibo::IPT;
using vibo::NWARP;
using vibo::RS;
using vibo::SPT;
using vibo::TBS;
using vibo::THREADS;
using vibo::TMI;

// WIDE: K = KC, one pass over the dims [k0, k0 + KC) of kt (loglik_tile.cuh);
// part keeps its (nblk, kt + C - 1, M) layout.
template <class Link, int K, bool WIDE>
__global__ void __launch_bounds__(THREADS)
loglik_categorical_kernel(const float* __restrict__ theta, long long th_sb,
                          long long th_sk, const float* __restrict__ a,
                          const float* __restrict__ kap,
                          const int8_t* __restrict__ pk,
                          float* __restrict__ dtheta, long long dt_sb,
                          long long dt_sk, float* __restrict__ ll_person,
                          float* __restrict__ part, int B, int M, int C,
                          int kt_arg, int k0_arg) {
  extern __shared__ float smem[];
  const int kt = WIDE ? kt_arg : K, k0 = WIDE ? k0_arg : 0;
  const bool first = k0 == 0;  // writes ll and dkappa
  const int NC = K + C - 1;  // reduced columns: da (K), dkappa (C - 1)
  const int NP = kt + C - 1;  // the partial's columns
  float* th_s = smem;                                  // TBS x K
  float* a_s = th_s + TBS * K;                         // TMI x K
  float* tab_s = a_s + TMI * K;                        // table rows x TMI
  float* red_s = tab_s + Link::table_rows(C) * TMI;    // NWARP x NC x RS
  float* scr_s = red_s + NWARP * NC * RS;              // scratch x THREADS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * TBS;
  const bool vec = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(pk) % 4 == 0);
  vibo::stage_theta<K>(th_s, theta, th_sb, th_sk, s0, B, k0, kt);

  float dth[SPT][K];
  float llp[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    llp[q] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dth[q][k] = 0.f;
  }

  const int j0 = lane * IPT;
  // this warp's reduce rows, and this lane's dkappa slots in them
  float* red_w = red_s + warp * NC * RS;
  for (int m0 = 0; m0 < M; m0 += TMI) {
    for (int i = tid; i < TMI * K; i += THREADS) {
      const int j = i / K, k = i % K, gj = m0 + j;
      a_s[i] = gj < M && k0 + k < kt
                   ? a[static_cast<size_t>(gj) * kt + k0 + k] : 0.f;
    }
#pragma unroll 1
    for (int i = tid; i < Link::stage_steps(C) * TMI; i += THREADS) {
      const int row = i / TMI, j = i % TMI, gj = m0 + j;
      Link::stage(tab_s, vibo::slot_of(j), kap, gj < M ? gj : -1, C, row);
    }
    for (int t = K; t < NC; ++t)
#pragma unroll
      for (int p = 0; p < IPT; ++p) red_w[t * RS + p * 32 + lane] = 0.f;
    __syncthreads();

    float aj[IPT][K], da[IPT][K];
#pragma unroll
    for (int p = 0; p < IPT; ++p)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        aj[p][k] = a_s[(j0 + p) * K + k];
        da[p][k] = 0.f;
      }

#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int s = warp * SPT + q;
      int8_t code[IPT];
      vibo::load_codes(pk, s0 + s, m0 + j0, B, M, vec, code);
      float th[K];
#pragma unroll
      for (int k = 0; k < K; ++k) th[k] = th_s[s * K + k];
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        float dot = 0.f;
        if constexpr (WIDE) {
          const int gs = s0 + s, gj = m0 + j0 + p;
          if (gs < B && gj < M)
            dot = vibo::wide_dot(theta + gs * th_sb, th_sk,
                                 a + static_cast<size_t>(gj) * kt, kt);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) dot = fmaf(th[k], aj[p][k], dot);
        }
        const float c = static_cast<float>(code[p]);
        const float mk = fminf(c, 1.f);
        const int r = min(max(static_cast<int>(code[p]) - 1, 0), C - 1);
        const int sl = p * 32 + lane;
        float dbase;
        llp[q] += Link::cell(dot, tab_s + sl, scr_s + tid, mk, r, C,
                             red_w + K * RS + sl, dbase);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dth[q][k] = fmaf(dbase, aj[p][k], dth[q][k]);
          da[p][k] = fmaf(dbase, th[k], da[p][k]);
        }
      }
    }

#pragma unroll
    for (int p = 0; p < IPT; ++p)
#pragma unroll
      for (int k = 0; k < K; ++k) red_w[k * RS + p * 32 + lane] = da[p][k];
    __syncthreads();
    // (column, slot) pairs by the constant TMI: no integer division by the
    // run-time NC (which would spend a MUFU.RCP in the tile loop)
    const size_t blk = blockIdx.x;
    for (int i = tid; i < TMI * NC; i += THREADS) {
      const int col = i / TMI, sl = i % TMI;
      const int gj = m0 + (sl % 32) * IPT + sl / 32;
      if (gj >= M) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += red_s[(w * NC + col) * RS + sl];
      // da column k0 + col of kt, or dkappa column kt + col - K (first pass)
      const int pc = col < K ? k0 + col : kt + col - K;
      if (col < K ? pc < kt : first) part[(blk * NP + pc) * M + gj] = sum;
    }
    __syncthreads();  // a_s, tab_s and red_s are rewritten by the next tile
  }

  vibo::write_dtheta_ll<K>(dth, llp, s0 + warp * SPT, B, dtheta, dt_sb,
                           dt_sk, first ? ll_person : nullptr, k0, kt);
}

// out[i] = sum over the nblk blocks of part[k * n + i], in block order.
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int nblk,
                                  size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int k = 0; k < nblk; ++k) sum += part[k * n + i];
  out[i] = sum;
}

template <class Link, int K, bool WIDE = false>
cudaError_t launch(const float* theta, long long th_sb, long long th_sk,
                   const float* a, const float* kap, const int8_t* pk,
                   float* dtheta, long long dt_sb, long long dt_sk,
                   float* ll_person, float* part, int nblk, int B, int M,
                   int C, cudaStream_t stream, int kt = K, int k0 = 0) {
  const size_t smem = vibo::smem_bytes<Link>(K, C);
  auto kernel = loglik_categorical_kernel<Link, K, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblk, THREADS, smem, stream>>>(theta, th_sb, th_sk, a, kap, pk,
                                          dtheta, dt_sb, dt_sk, ll_person,
                                          part, B, M, C, kt, k0);
  return cudaGetLastError();
}

template <class Link>
int entry(const void* theta, long long th_sb, long long th_sk, const void* a,
          const void* kap, const void* pk, void* dtheta, long long dt_sb,
          long long dt_sk, void* ll_person, void* part, void* grads, int B,
          int M, int K, int C, int scratch_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nblk = (B + TBS - 1) / TBS;
  if (scratch_blocks != nblk || C < 3 || C > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk > 0 && M > 0) {
    const float* t = static_cast<const float*>(theta);
    const float* av = static_cast<const float*>(a);
    const float* kv = static_cast<const float*>(kap);
    const int8_t* p = static_cast<const int8_t*>(pk);
    float* dt = static_cast<float*>(dtheta);
    float* lp = static_cast<float*>(ll_person);
    float* pt = static_cast<float*>(part);
    cudaError_t err;
    switch (K) {
#define VIBO_CASE(KK)                                                       \
  case KK:                                                                  \
    err = launch<Link, KK>(t, th_sb, th_sk, av, kv, p, dt, dt_sb, dt_sk, lp, \
                           pt, nblk, B, M, C, stream);                      \
    break;
      VIBO_CASE(1) VIBO_CASE(2) VIBO_CASE(3) VIBO_CASE(4)
      VIBO_CASE(5) VIBO_CASE(6) VIBO_CASE(7) VIBO_CASE(8)
#undef VIBO_CASE
      default:  // K > 8: one wide pass a chunk of KC dims
        err = K < 1 ? cudaErrorInvalidValue : cudaSuccess;
        for (int k0 = 0; k0 < K && err == cudaSuccess; k0 += vibo::KC)
          err = launch<Link, vibo::KC, true>(t, th_sb, th_sk, av, kv, p, dt,
                                             dt_sb, dt_sk, lp, pt, nblk, B, M,
                                             C, stream, K, k0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n = static_cast<size_t>(M) * (K + C - 1);
  if (n > 0) {
    const int threads = 256;
    column_sum_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                        threads, 0, stream>>>(static_cast<const float*>(part),
                                              static_cast<float*>(grads),
                                              nblk, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// theta/dtheta: f32 at theta[i*th_sb + k*th_sk]; a (M, K) and kappa
// (M, C-1) f32 contiguous (GRM: the ordered thresholds); pk (B, M) int8
// contiguous; ll_person (B,); scratch part (nblk, K + C - 1, M) with nblk =
// ceil(B / 64), which the caller passes so a mismatch is refused instead of
// overrunning the scratch; output grads (K + C - 1, M) = [da^T | dkappa^T].
// 3 <= C <= 32, K >= 1 (K > 8 in passes of 8 dims).
int loglik_grm_train(const void* theta, long long th_sb, long long th_sk,
                     const void* a, const void* kappa, const void* pk,
                     void* dtheta, long long dt_sb, long long dt_sk,
                     void* ll_person, void* part, void* grads, int B, int M,
                     int K, int C, int scratch_blocks, void* stream_ptr) {
  return entry<vibo::LinkGRM>(theta, th_sb, th_sk, a, kappa, pk, dtheta,
                              dt_sb, dt_sk, ll_person, part, grads, B, M, K,
                              C, scratch_blocks, stream_ptr);
}

// As loglik_grm_train, with kappa the GPCM cumulative step sums.
int loglik_gpcm_train(const void* theta, long long th_sb, long long th_sk,
                      const void* a, const void* kappa, const void* pk,
                      void* dtheta, long long dt_sb, long long dt_sk,
                      void* ll_person, void* part, void* grads, int B, int M,
                      int K, int C, int scratch_blocks, void* stream_ptr) {
  return entry<vibo::LinkGPCM>(theta, th_sb, th_sk, a, kappa, pk, dtheta,
                               dt_sb, dt_sk, ll_person, part, grads, B, M, K,
                               C, scratch_blocks, stream_ptr);
}

}  // extern "C"
