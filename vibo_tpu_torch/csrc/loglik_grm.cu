// One-pass training log-likelihood of the graded response model (GRM) on
// the int8 response code: the family's links and launch on the kernel of
// loglik_categorical.cuh.
//
// Replaces the TPU Pallas kernel vibo_tpu/ops/pallas_grm.py
// _fused_train_fwd_grm (:198), body _fused_train_kernel_grm (:101), tables
// _grm_tables (:80).
//
// GRM (pallas_grm.py:14-30): base clamped to +-30; lo = kappa_r, hi =
// kappa_{r+1} (sentinels -50 and +50 at the boundary categories); x = base -
// lo, y = base - hi, e_x = exp(-|x|), e_y = exp(-|y|);
//   ll = m (min(x, 0) - log1p(e_x) - max(y, 0) - log1p(e_y) + log D_r)
// with D_r = -expm1(min(kappa_r - kappa_{r+1}, -1e-6)) (boundary rows 1).
// The four sigmoids in product form (e/(1+e) or 1/(1+e) by sign, never
// 1 - sigmoid):
//   dbase = m (s(-x) - s(y))
//   dkappa_r -= m s(-x) / max(s(-y) D, 1e-30)        (r >= 1)
//   dkappa_{r+1} += m s(y) / max(s(x) D, 1e-30)      (r <= C - 2)
// dbase is not zeroed beyond the clamp (the Pallas kernel's contract).
// At C <= 8 and K <= 8 (LinkGRMFixed, C a template argument) D and log D
// are computed once a call, as JAX computes its _grm_tables (:80) outside
// its kernel: a prologue (grm_table_kernel) writes one 16-byte slot (lo,
// hi, D, log D) an item and category, in the order the main kernel stages
// them, and the main kernel copies a tile's slots into shared memory a tile
// ahead (cp.async, double-buffered: no registers held). A cell reads its
// own category's slot in one 16-byte load, takes one log of (1 + e_x)(1 +
// e_y) for the two log1p, one reciprocal of that product for the two
// sigmoids' 1/(1+e), and one reciprocal for both dkappa ratios; each lane
// sums its items' dkappa in registers, a predicated select a column with no
// branch on r, and writes them once a tile beside da. At 9 <= C <= 32 and
// in the wide variant (LinkGRM) each block stages D and log D for every
// tile and a cell adds dkappa into its warp's reduce rows.
//
// What bounds it on an H100, at B = 10,240, M = 1,024, K = 4, C = 5: the
// int8 code is 10.5 MB (~3.1 us at 3.35 TB/s), the f32 operations about
// 6K + 50 a cell (~12 us at 67 TFLOP/s), the special-function (MUFU)
// results two exp and four reciprocals a cell at run-time C, two exp, a
// log2 and two reciprocals at compile-time C (chip_smoke.py counts them in
// this library's SASS; ~15 us at six a cell). Latency and the cell's
// instruction count set the pace, not any of the three: the compile-time
// link computes the tables once a call, takes one log and two reciprocals
// on the special-function unit where the run-time cell has two log1p and
// two IEEE divisions, keeps dkappa in registers and two students' codes in
// one register, and holds no register for the next tile's table.

#include "loglik_categorical.cuh"

namespace vibo {

struct LinkGRM {
  static constexpr int CF = 0;             // C is a run-time value
  static constexpr int NDK = 1;            // (no dkappa registers)
  static constexpr bool SLOTS = false;
  static constexpr float BIG = 50.f;       // boundary-category sentinel
  static constexpr float CLAMP = 30.f;     // base saturation
  static constexpr float GAP = -1e-6f;     // kappa_r - kappa_{r+1} clamp

  __host__ __device__ static constexpr int min_blocks(int K) {
    return K <= 4 ? 2 : 1;
  }
  // staged floats a tile: thresholds kx (C + 1 rows, with the sentinels),
  // D (C) and log D (C), in C + 1 staging steps an item
  __host__ __device__ static int tab_floats(int C) { return (3 * C + 1) * TMI; }
  __host__ __device__ static int stage_steps(int C) { return C + 1; }

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
  // dkap[t * TMI] (threshold kappa_{t+1}); tab points at the item's slot.
  __device__ __forceinline__ static float cell(float dot, const float* tab,
                                               float mk, int r, int C,
                                               float* dkap, float& dbase) {
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
      if (r >= 1) dkap[(r - 1) * TMI] -= gx;
      if (r <= C - 2) dkap[r * TMI] += gy;
    }
    return ll;
  }
};

// GRM at a compile-time C = CC (3..8): the tile's slots (lo, hi, D, log D)
// of every item and category, written once a call by grm_table_kernel and
// copied a tile ahead into one of two shared buffers; dkappa in registers.
template <int CC>
struct LinkGRMFixed {
  static constexpr int CF = CC;
  static constexpr int NDK = CC - 1;
  static constexpr bool SLOTS = true;      // the prologue's slots, cp.async
  static constexpr int TAB = CC * TMI * 4;  // floats of a tile's slots

  __host__ __device__ static constexpr int min_blocks(int K) {
    return K <= 4 && K + CC <= 9 ? 2 : 1;  // past it, 64 registers spill
  }
  __host__ __device__ static int tab_floats(int) { return 2 * TAB; }

  // The tile's slots (TAB floats at tab, in staging order) into buf: one
  // 16-byte copy a thread, waited for before the tile's first barrier.
  __device__ __forceinline__ static void copy_tile(float* buf,
                                                   const float* tab) {
    static_assert(CC * TMI <= THREADS, "one slot a thread");
    const int i = threadIdx.x;
    if (i < CC * TMI) cp_async16(buf + 4 * i, tab + 4 * i);
  }

  // tab points at the item's slot of category 0 in the tile's buffer (the
  // category's slot is TMI * 4 floats on); dk: the item's dkappa sums.
  __device__ __forceinline__ static float cell(float dot, const float* tab,
                                               float mk, int r,
                                               float (&dk)[NDK],
                                               float& dbase) {
    float v[4];  // lo, hi, D, log D
    load_consts<4>(tab + r * (TMI * 4), v);
    const float base = fminf(fmaxf(dot, -LinkGRM::CLAMP), LinkGRM::CLAMP);
    const float x = base - v[0], y = base - v[1];
    const float ex = expf(-fabsf(x)), ey = expf(-fabsf(y));
    const float px = 1.f + ex, py = 1.f + ey, pxy = px * py;
    // log1p(e_x) + log1p(e_y) as one log, 1/(1+e_x) and 1/(1+e_y) from one
    // reciprocal: the product lies in [1, 4], where the special-function
    // unit's log2 and reciprocal are within 4e-7 and 2 ulp
    const float ll = mk * (fminf(x, 0.f) - fmaxf(y, 0.f) - __logf(pxy) + v[3]);
    const float inv = __fdividef(1.f, pxy);
    const float invx = py * inv, invy = px * inv;
    const float sx = x >= 0.f ? invx : ex * invx;     // sigmoid(x)
    const float smx = x >= 0.f ? ex * invx : invx;    // sigmoid(-x)
    const float sy = y >= 0.f ? invy : ey * invy;     // sigmoid(y)
    const float smy = y >= 0.f ? ey * invy : invy;    // sigmoid(-y)
    dbase = mk * (smx - sy);
    // both ratios from one reciprocal: lo <= hi gives x >= y, so one of
    // s(-y), s(x) is >= 1/2, and with D >= 1e-6 the product of the clamped
    // denominators stays a normal float, inside __fdividef's 2-ulp range
    const float den_x = fmaxf(smy * v[2], 1e-30f);
    const float den_y = fmaxf(sx * v[2], 1e-30f);
    const float q = __fdividef(mk, den_x * den_y);
    const float gx = smx * den_y * q, gy = sy * den_x * q;
#pragma unroll
    for (int c = 0; c < NDK; ++c)
      dk[c] += c == r - 1 ? -gx : c == r ? gy : 0.f;
    return ll;
  }
};

}  // namespace vibo

namespace {

// The compile-time GRM's slots, once a call: slot (t, r, sl) = (lo, hi, D,
// log D) of category r of the item in slot sl of tile t (loglik_tile.cuh
// slot_of), at tab[((t * C + r) * TMI + sl) * 4], n = tiles * C * TMI of
// them; items past M take thresholds 0 (finite, and their cells have m = 0).
__global__ void __launch_bounds__(256)
grm_table_kernel(const float* __restrict__ kap, float* __restrict__ tab,
                 int M, int C, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int t = i / (C * TMI), r = i / TMI % C, sl = i % TMI;
  const int gj = t * TMI + (sl % 32) * IPT + sl / 32;
  auto kv = [&](int u) {  // threshold kappa_u, u in 1..C-1
    return gj < M ? kap[static_cast<size_t>(gj) * (C - 1) + u - 1] : 0.f;
  };
  const float lo = r == 0 ? -vibo::LinkGRM::BIG : kv(r);
  const float hi = r == C - 1 ? vibo::LinkGRM::BIG : kv(r + 1);
  float d = 1.f, ld = 0.f;
  if (r >= 1 && r <= C - 2) {
    d = -expm1f(fminf(lo - hi, vibo::LinkGRM::GAP));
    ld = logf(d);
  }
  reinterpret_cast<float4*>(tab)[i] = make_float4(lo, hi, d, ld);
}

// The GRM path of (K, C): at C <= 8 and K <= 8 the prologue's slots and the
// compile-time-C link, else the run-time link.
cudaError_t launch_grm(const Args& g, int K) {
  if (K > 8) return launch_wide<vibo::LinkGRM>(g, K);
  if (g.C > 8) return launch_k<vibo::LinkGRM>(g, K);
  if (g.tab == nullptr) return cudaErrorInvalidValue;
  const int n = (g.M + TMI - 1) / TMI * g.C * TMI;
  if (n > 0) {
    grm_table_kernel<<<(n + 255) / 256, 256, 0, g.stream>>>(g.kv, g.tab, g.M,
                                                          g.C, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  Args f = g;
  f.kv = g.tab;
  switch (g.C) {
    case 3: return launch_k<vibo::LinkGRMFixed<3>>(f, K);
    case 4: return launch_k<vibo::LinkGRMFixed<4>>(f, K);
    case 5: return launch_k<vibo::LinkGRMFixed<5>>(f, K);
    case 6: return launch_k<vibo::LinkGRMFixed<6>>(f, K);
    case 7: return launch_k<vibo::LinkGRMFixed<7>>(f, K);
    default: return launch_k<vibo::LinkGRMFixed<8>>(f, K);
  }
}

// The kernel a (K, C) call launches first, and its shared memory.
const void* kernel_of(int K, int C, size_t* smem) {
  return K <= 8 && C <= 8
             ? fixed_kernel_of<vibo::LinkGRMFixed>(K, C, smem)
             : runtime_kernel_of<vibo::LinkGRM>(K, C, smem);
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// theta/dtheta: f32 at theta[i*th_sb + k*th_sk]; a (M, K) and kappa
// (M, C-1) f32 contiguous (GRM: the ordered thresholds); pk (B, M) int8
// contiguous; ll_person (B,). The plan (nblk, nsplit, tps) of
// ops/one_pass.py split_plan, checked here (loglik_tile.cuh check_plan) so a
// mismatch is refused instead of overrunning the scratch: part_dth
// (nsplit, B, K), part_llp (nsplit, B), part (nblk, K + C - 1, M), tab
// ceil(M / 64) * C * 64 * 4 floats for the prologue's slots (written and
// read at C <= 8 and K <= 8 only); output grads (K + C - 1, M) = [da^T |
// dkappa^T].
// 3 <= C <= 32, K >= 1 (K > 8 in passes of 8 dims).
int loglik_grm_train(const void* theta, long long th_sb, long long th_sk,
                     const void* a, const void* kappa, void* tab,
                     const void* pk, void* dtheta, long long dt_sb,
                     long long dt_sk, void* ll_person, void* part_dth,
                     void* part_llp, void* part, void* grads, int B, int M,
                     int K, int C, int nblk, int nsplit, int tps,
                     void* stream_ptr) {
  return entry<launch_grm>(theta, th_sb, th_sk, a, kappa, tab, pk, dtheta,
                           dt_sb, dt_sk, ll_person, part_dth, part_llp, part,
                           grads, B, M, K, C, nblk, nsplit, tps, stream_ptr);
}

// Registers, local (spill) bytes and blocks an SM of the kernel a (K, C)
// call launches first, into out[0..2].
int loglik_grm_occupancy(int K, int C, int* out) {
  size_t smem = 0;
  return vibo::occupancy_of(kernel_of(K, C, &smem), smem, out);
}

}  // extern "C"
