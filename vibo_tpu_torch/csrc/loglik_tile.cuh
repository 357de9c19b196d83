// The tile mapping the one-pass training logliks share (loglik_train.cu for
// the binary links, loglik_categorical.cu for the polytomous families).
//
// A block owns TBS = 64 students and loops over the items in tiles of
// TMI = 128. A warp takes SPT = 8 students, a lane IPT = 4 consecutive
// items, so a warp reads 128 contiguous bytes of each student's code row.
// dtheta and the per-person ll accumulate per student in registers across
// all item tiles and are summed over the lanes by warp shuffles once at the
// end (write_dtheta_ll): no atomics.
//
// K beyond the instantiated widths 1..8 (the wide variant): the kernel is
// instantiated at K = KC and run once for every chunk [k0, k0 + KC) of the
// kt ability dims. Each pass recomputes the whole logit with wide_dot (a
// run-time loop over kt, theta and a read from global memory, where the
// tile's a rows sit in L1), stages and accumulates only its chunk's theta,
// dtheta and da in today's register layout, and writes ll, db and the
// link's other per-item gradients in its first pass (k0 == 0) alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vibo {

constexpr int TBS = 64;                 // students per block
constexpr int TMI = 128;                // items per tile
constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int SPT = TBS / NWARP;        // students per warp (and per thread)
constexpr int IPT = TMI / 32;           // consecutive items per lane
constexpr int KC = 8;                   // ability dims a wide pass covers

// theta_i . a_j over all kt ability dims (the wide variant's logit).
__device__ __forceinline__ float wide_dot(const float* __restrict__ th,
                                          long long th_sk,
                                          const float* __restrict__ aj,
                                          int kt) {
  float dot = 0.f;
  for (int k = 0; k < kt; ++k) dot = fmaf(th[k * th_sk], __ldg(aj + k), dot);
  return dot;
}

// theta rows of the block's students into th_s (TBS x K, row-major), zero
// past the last student; theta is addressed through its strides. The wide
// variant stages the dims k0 .. k0 + K - 1 of kt, zero past kt.
template <int K>
__device__ __forceinline__ void stage_theta(float* th_s, const float* theta,
                                            long long th_sb, long long th_sk,
                                            int s0, int B, int k0 = 0,
                                            int kt = K) {
  for (int i = threadIdx.x; i < TBS * K; i += THREADS) {
    const int s = i / K, k = i % K, gs = s0 + s;
    th_s[i] = gs < B && k0 + k < kt ? theta[gs * th_sb + (k0 + k) * th_sk]
                                    : 0.f;
  }
}

// The IPT codes of student gs at items gj .. gj + IPT - 1, 0 outside the
// (B, M) code; vec: the rows are 4-byte aligned (M % 4 == 0).
__device__ __forceinline__ void load_codes(const int8_t* __restrict__ pk,
                                           int gs, int gj, int B, int M,
                                           bool vec, int8_t (&code)[IPT]) {
  const int8_t* row = pk + static_cast<size_t>(gs) * M + gj;
  if (gs < B && vec && gj + IPT <= M) {
    char4 v = *reinterpret_cast<const char4*>(row);
    code[0] = v.x; code[1] = v.y; code[2] = v.z; code[3] = v.w;
  } else {
#pragma unroll
    for (int p = 0; p < IPT; ++p)
      code[p] = (gs < B && gj + p < M) ? row[p] : int8_t(0);
  }
}

// Sums each of the warp's SPT students' dtheta and ll over the lanes; lane
// 0 writes dtheta (through its strides; the wide variant its dims k0 ..
// k0 + K - 1 of kt) and ll_person (when not null). Returns the warp's sum
// of ll over its students.
template <int K>
__device__ __forceinline__ float write_dtheta_ll(
    const float (&dth)[SPT][K], const float (&llp)[SPT], int s_warp, int B,
    float* dtheta, long long dt_sb, long long dt_sk, float* ll_person,
    int k0 = 0, int kt = K) {
  const int lane = threadIdx.x & 31;
  float ll_warp = 0.f;
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int gs = s_warp + q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = dth[q][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && gs < B && k0 + k < kt)
        dtheta[gs * dt_sb + (k0 + k) * dt_sk] = v;
    }
    float v = llp[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && gs < B && ll_person != nullptr) ll_person[gs] = v;
    ll_warp += v;
  }
  return ll_warp;
}

}  // namespace vibo
