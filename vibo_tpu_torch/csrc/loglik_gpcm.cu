// One-pass training log-likelihood of the generalized partial credit model
// (GPCM) on the int8 response code: the family's links and launch on the
// kernel of loglik_categorical.cuh.
//
// Replaces the TPU Pallas kernel vibo_tpu/ops/pallas_gpcm.py
// _fused_train_fwd_gpcm (:148), body _fused_train_kernel_gpcm (:69).
//
// GPCM (pallas_gpcm.py:14-22): z_c = c base - kappa_c (z_0 = 0), mx the
// largest z, e_c = exp(z_c - mx), s = sum_c e_c;
//   ll = m (z_r - mx - log s),  dbase = m (r - sum_c c e_c / s),
//   dkappa_c += m (e_c / s - [r = c])
// At C <= 8 (the usual Likert range; bench.py's C = 5) the category count
// is a template argument (LinkGPCMFixed): each z is computed once, the C
// exponentials stay in registers, the item's table comes in one or two
// 16-byte shared loads a cell, and each lane sums its items' dkappa in
// registers over its warp's students and writes them once a tile beside da,
// with no read-modify-write in shared memory a cell. At 9 <= C <= 32 the
// run-time path (LinkGPCM) takes C exponentials twice a cell (value, then
// dkappa: nothing is kept between) and adds dkappa into the warp's own
// slice of the reduce buffer, as GRM does.
//
// What bounds it on an H100, at B = 10,240, M = 1,024, K = 4, C = 5: the
// int8 code is 10.5 MB (~3.1 us at 3.35 TB/s), the f32 operations about
// 6K + 16C + 16 a cell (~19 us at 67 TFLOP/s), the special-function (MUFU)
// results C exp, a log and a reciprocal a cell (chip_smoke.py counts them
// in this library's SASS). The cell's instruction count and the tile's two
// barriers set the pace.

#include "loglik_categorical.cuh"

namespace vibo {

// GPCM at a run-time C (9..32; any C in the wide variant).
struct LinkGPCM {
  static constexpr int CF = 0;
  static constexpr int NDK = 1;
  static constexpr bool SLOTS = false;

  __host__ __device__ static constexpr int min_blocks(int) { return 1; }
  // staged rows a tile: kappa_0 = 0, kappa_1..C-1
  __host__ __device__ static int tab_floats(int C) { return C * TMI; }
  __host__ __device__ static int stage_steps(int C) { return C; }

  __device__ __forceinline__ static void stage(float* tab, int sl,
                                               const float* kap, int gj,
                                               int C, int row) {
    tab[row * TMI + sl] =
        row == 0 || gj < 0
            ? 0.f
            : kap[static_cast<size_t>(gj) * (C - 1) + row - 1];
  }

  __device__ __forceinline__ static float cell(float base, const float* tab,
                                               float mk, int r, int C,
                                               float* dkap, float& dbase) {
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
      s += ev;
      ec += static_cast<float>(c) * ev;
    }
    const float inv = 1.f / s;
    dbase = mk * (static_cast<float>(r) - ec * inv);
    if (mk != 0.f) {
#pragma unroll 1
      for (int c = 1; c < C; ++c) {
        const float ev =
            expf(static_cast<float>(c) * base - tab[c * TMI] - mx);
        dkap[(c - 1) * TMI] += mk * (ev * inv - (c == r ? 1.f : 0.f));
      }
    }
    return mk * (zr - mx - logf(s));
  }
};

// GPCM at a compile-time C = CC (3..8): the table as CP floats a slot
// (kappa_1..CC-1, zero-padded to a multiple of 4), dkappa in registers.
template <int CC>
struct LinkGPCMFixed {
  static constexpr int CF = CC;
  static constexpr int NDK = CC - 1;
  static constexpr bool SLOTS = false;
  static constexpr int CP = (CC - 1 + 3) / 4 * 4;

  __host__ __device__ static constexpr int min_blocks(int K) {
    return K + CC <= 9 ? 2 : 1;  // past it, 64 registers spill
  }
  __host__ __device__ static int tab_floats(int) { return CP * TMI; }

  // The tile's table (TMI x (CC - 1), prefetched by prefetch1 from kappa +
  // m0 * (CC - 1)) into CP floats a slot; the padding is never read into a
  // result.
  __device__ __forceinline__ static void store(float* tab, float v) {
    static_assert(TMI * (CC - 1) <= THREADS, "one kappa value a thread");
    const int i = threadIdx.x;
    if (i < TMI * (CC - 1))
      tab[slot_of(i / (CC - 1)) * CP + i % (CC - 1)] = v;
  }

  // tab points at the item's CP floats; dk: the item's dkappa sums.
  __device__ __forceinline__ static float cell(float base, const float* tab,
                                               float mk, int r,
                                               float (&dk)[NDK],
                                               float& dbase) {
    float kp[CP];
    load_consts<CP>(tab, kp);
    float z[CC];
    z[0] = 0.f;
    float mx = 0.f, zr = 0.f;
#pragma unroll
    for (int c = 1; c < CC; ++c) {
      z[c] = static_cast<float>(c) * base - kp[c - 1];
      mx = fmaxf(mx, z[c]);
      zr = c == r ? z[c] : zr;
    }
    float e[CC];
    float s = 0.f, ec = 0.f;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      e[c] = expf(z[c] - mx);
      s += e[c];
      ec += static_cast<float>(c) * e[c];
    }
    const float inv = 1.f / s;
    dbase = mk * (static_cast<float>(r) - ec * inv);
#pragma unroll
    for (int c = 1; c < CC; ++c)
      dk[c - 1] += mk * (e[c] * inv - (c == r ? 1.f : 0.f));
    return mk * (zr - mx - logf(s));
  }
};

}  // namespace vibo

namespace {

// The GPCM path of (K, C): the compile-time-C link at C <= 8 and K <= 8.
cudaError_t launch_gpcm(const Args& g, int K) {
  if (K > 8) return launch_wide<vibo::LinkGPCM>(g, K);
  switch (g.C) {
    case 3: return launch_k<vibo::LinkGPCMFixed<3>>(g, K);
    case 4: return launch_k<vibo::LinkGPCMFixed<4>>(g, K);
    case 5: return launch_k<vibo::LinkGPCMFixed<5>>(g, K);
    case 6: return launch_k<vibo::LinkGPCMFixed<6>>(g, K);
    case 7: return launch_k<vibo::LinkGPCMFixed<7>>(g, K);
    case 8: return launch_k<vibo::LinkGPCMFixed<8>>(g, K);
    default: return launch_k<vibo::LinkGPCM>(g, K);
  }
}

// The kernel a (K, C) call launches first, and its shared memory.
const void* kernel_of(int K, int C, size_t* smem) {
  return K <= 8 && C <= 8
             ? fixed_kernel_of<vibo::LinkGPCMFixed>(K, C, smem)
             : runtime_kernel_of<vibo::LinkGPCM>(K, C, smem);
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// As loglik_grm_train (loglik_grm.cu), with kappa the GPCM cumulative step
// sums (tab unused: null).
int loglik_gpcm_train(const void* theta, long long th_sb, long long th_sk,
                      const void* a, const void* kappa, void* tab,
                      const void* pk, void* dtheta, long long dt_sb,
                      long long dt_sk, void* ll_person, void* part_dth,
                      void* part_llp, void* part, void* grads, int B, int M,
                      int K, int C, int nblk, int nsplit, int tps,
                      void* stream_ptr) {
  return entry<launch_gpcm>(theta, th_sb, th_sk, a, kappa, tab, pk, dtheta,
                            dt_sb, dt_sk, ll_person, part_dth, part_llp,
                            part, grads, B, M, K, C, nblk, nsplit, tps,
                            stream_ptr);
}

// Registers, local (spill) bytes and blocks an SM of the kernel a (K, C)
// call launches first, into out[0..2].
int loglik_gpcm_occupancy(int K, int C, int* out) {
  size_t smem = 0;
  return vibo::occupancy_of(kernel_of(K, C, &smem), smem, out);
}

}  // extern "C"
