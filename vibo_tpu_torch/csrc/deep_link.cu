// One-pass training log-likelihood of the deep nonlinear link on the int8
// response code, with every gradient, on the tensor cores.
//
// Replaces the TPU Pallas kernel of vibo_tpu/ops/pallas_deep.py:
//   deep_link_train  <- _fused_deep_fwd (:154), body _fused_deep_kernel (:75)
// Per (student i, item j) pair, with t1 = theta W_theta + b1 (B, H) and
// t2 = d W_item (M, H) computed outside (f32), the code c (0 = missing,
// 1 = wrong, 2 = right), m = min(c, 1), r = max(c - 1, 0):
//   h1 = relu(t1_i + t2_j)             pre2 = bf16(h1) bf16(W2) + b2
//   h2 = relu(pre2)                    logit = h2 . wo + bo
//   ll = m (r logit - softplus(logit)) dlogit = m (r - sigmoid(logit))
//   dpre2 = [pre2 > 0] dlogit wo       dh1 = bf16(dpre2) bf16(W2)^T
//   dpre1 = [t1_i + t2_j > 0] dh1
// and the sums ll (B,), s_theta = sum_j dpre1 (B, H), s_d = sum_i dpre1
// (M, H), dW2 = sum bf16(h1)^T bf16(dpre2) (H, H), db2 = sum dpre2,
// dwo = sum h2 dlogit, dbo = sum dlogit. The (B, M, H) activations never
// leave the chip. The relu masks use the f32 pre-activations; the products'
// operands are rounded to bf16 (round to nearest even) and accumulate in f32,
// the rounding points of the Pallas kernel.
//
// What bounds it on an H100: three products of 2 H^2 operations a pair on
// the bf16 tensor cores (6 H^2 a pair: 3.7e11 at 5,520 x 680 and H = 128,
// ~0.37 ms at 989 TFLOP/s; 1.49, 3.36 and 5.97 ms at H = 256, 384 and
// 512), against about 17 H f32 operations a pair of elementwise work
// outside them (~0.12 ms at 67 TFLOP/s at H = 128), three special-function
// results a pair (exp, log1p, the reciprocal of 1 + e) and ~10 MB of
// traffic (a few microseconds): the tensor-core operations.
//
// Common to every width: a block of 512 threads walks a contiguous run of
// items one at a time for its students (grid y splits the items so that the
// blocks fill the SMs); an item's pairs are the M side of the three
// products, on inline-PTX mma.sync m16n8k16 (bf16 in, f32 accumulate) from
// ldmatrix (.trans where an operand is read transposed). W2 is read from
// device memory once a block, rounded to bf16 into shared memory, and the
// block's running sum of dW2 stays in registers until the block ends. The
// tensor cores do not round their f32 accumulation to nearest, so each
// item's dW2 product starts from a zero accumulator and is added to the
// running sum with f32 adds (a chain over the block's whole item run drifted
// by 3e-4 to 9e-4 of dW2's largest element against the plain version). Every
// sum across blocks (ll and s_theta over the item splits, s_d over the
// student tiles, the weight gradients over all blocks) is a per-block
// partial that a second kernel adds in block order: no atomics,
// deterministic.
//
// H = 128 (paper config 5), deep_link_kernel<128>: one block owns P = 64
// students and all of W2 (34 KB bf16) and dW2 (32 floats a lane). Warp w
// owns 16 pairs x 32 columns of each (P x H) product, so pre2 and dh1 stay
// in the accumulators: a lane sums relu(pre2 + b2) wo over its 8 columns,
// its quad over 32, and the row tile's four column groups through a 64 x 4
// array in a fixed order; dlogit, dpre2 (bf16 to shared), db2 and dwo are
// formed in registers; dh1 is masked by the f32 pre-activations of the
// lane's own h1 (a bit mask kept from building it), s_theta accumulates in
// shared memory at the lane's own positions and s_d is reduced over the
// warp's rows with shuffles. h1 and dpre2 are double-buffered by item
// parity: an item has one block-wide barrier (dpre2 ready) and two of its
// row tile's 128 threads (h1 ready, logit partials). 126 registers a
// thread, no spill, one block an SM. What holds it back (estimates from the
// code, not measured): shared-memory traffic of ~0.6 MB an item for a
// block, each warp loading its own A and B fragments through ldmatrix,
// against ~0.8 us of tensor work an item at one SM's share of the peak; and
// one block of 16 warps an SM, whose phases wait at the barriers with
// nothing else to run.
//
// H = 256, 384, 512, deep_link_cluster_kernel<H>: W2 in bf16 (128 KB to
// 512 KB) and dW2 in f32 (256 KB to 1 MB) outgrow one SM, so a thread-block
// cluster of C CTAs (4, 8 and 16: 16 is a non-portable size) shares P = 32
// students and the item, and CTA r owns a panel of N = H / C columns (64,
// 48, 32). It holds W2[:, panel] (pre2's B) and W2[panel, :] (dh1's B) in
// shared memory and dW2[:, panel]'s running sum in registers (32, 36 and
// 32 floats a lane), and computes for the item:
//   - pre2[:, panel] = h1 W2[:, panel]: each warp 16 pairs x N / 2
//     columns over a quarter of k, the four partial sums added in order
//     (+ b2) by an element pass (16 lanes a pair, 4 or 2 columns a lane);
//   - its P partial sums of the logit, sent to every CTA and added there in
//     rank order (every CTA gets the same logit and dlogit);
//   - dpre2[:, panel] (bf16), db2, dwo, and bf16(h1) of the next item's
//     k-slice (the panel's columns of h1, with its relu mask kept in
//     registers), both sent to every CTA's whole (P x H) copy;
//   - dW2[:, panel] += h1^T dpre2[:, panel] while the panels travel (its
//     operands are local);
//   - dh1[:, panel] = dpre2 W2[panel, :]^T over the whole gathered dpre2
//     (quarters of n added in order), masked into s_theta and, summed over
//     the pairs with shuffles, the item's s_d.
// What crosses the CTAs is bf16 panels and P floats, moved by the copy
// engine (cp.async.bulk shared::cta -> shared::cluster) onto the receiver's
// mbarrier: P H 2 (C - 1) / C bytes of h1 and as many of dpre2 an item a
// CTA. h1 and dpre2 are kept panel-major (a panel is one contiguous copy;
// at N = 32 its rows are XOR-swizzled instead of padded to fit the shared
// memory). An item has two such waits and five block-wide barriers, no
// cluster barrier. W2 is read once a CTA and dW2 written once a CTA, never
// an item. What holds it back (times in PERF.md; this split is estimated
// from the code, not measured): shared-memory traffic of the mma.sync
// operands and the split-k partials (~0.6 MB an item a CTA at H = 256, as
// at H = 128 for half the products), and at C = 8-16 the ~43-60 KB an item
// a CTA through distributed shared memory.
//
// Every other width (any other H % 16 == 0; of those the op admits, H %
// 128 == 0 as JAX's, 640 and up) takes the wide variant,
// deep_link_wide_kernel: a prologue kernel rounds W2 to bf16 once a call
// into the scratch, where it stays L2-resident, and both products that read
// W2 load their B fragments straight from there. H is a run-time value: a
// block of 512 threads owns P = 32 students (16 where 32 do not fit the
// shared memory, H > 832), the products' tiles (nvcuda::wmma) go
// round-robin over the warps, the row pass takes a warp a pair and the
// column passes a thread a column (db2, dwo in shared memory); s_theta and
// dW2 are added into the block's own partials in device memory every item.
// The rounding points and the per-item fresh dW2 fragment are those of the
// other kernels. Its time is that of a repair (PERF.md), not a design for
// speed: at these widths the cluster's shared memory no longer holds its
// panels and dW2 no longer fits a cluster of 16 CTAs' registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;     // 16 warps (faster than 8 on an H100)
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;        // items whose codes are staged at once
constexpr int MAX_SPLITS = 8;    // item splits of the grid, at most

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// The layout of deep_link_kernel<H>: H = 128 only (below)
template <int H>
struct Cfg;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Scratch layout (floats), dW2 partials first so each stays 32-byte aligned
// for wmma: dw2 (nblk, H, H) | s_theta (splits, B, H) | s_d (tiles, M, H) |
// ll (splits, B) | db2 (nblk, H) | dwo (nblk, H) | dbo (nblk).
struct Parts {
  float *dw2, *sth, *sd, *ll, *db2, *dwo, *dbo;
  __host__ __device__ Parts(float* s, long long B, long long M, long long H,
                            long long tiles, long long splits) {
    const long long nblk = tiles * splits;
    dw2 = s;
    sth = dw2 + nblk * H * H;
    sd = sth + splits * B * H;
    ll = sd + tiles * M * H;
    db2 = ll + splits * B;
    dwo = db2 + nblk * H;
    dbo = dwo + nblk * H;
  }
  static long long floats(long long B, long long M, long long H,
                          long long tiles, long long splits) {
    const long long nblk = tiles * splits;
    return nblk * H * H + splits * B * H + tiles * M * H + splits * B +
           2 * nblk * H + nblk;
  }
};

// The one-block kernel: H = 128 only (below)
template <int H>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ wo, const float* __restrict__ bo,
                 const int8_t* __restrict__ pk, float* __restrict__ scratch,
                 int B, int M, int items_per_split);

// ---- H = 128: mma.sync from ldmatrix, pre2 and dh1 in registers ---------

// The shared-memory address of p, for the PTX below.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory, lanes 8i .. 8i + 7 giving the
// row addresses of matrix i; lane l gets row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each (with .trans: of each matrix transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: a 16x16 (row), b 16x8 (col), bf16; d 16x8
// f32. Lane l = 4 g + t holds d's rows g and g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x through an opaque move: what is computed from it is computed where it
// is used, not hoisted out of the item loop and held in registers across it
// (without these moves deep_link_kernel<128> spills at 128 registers).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  uint64_t x = reinterpret_cast<uint64_t>(p);
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return reinterpret_cast<T*>(x);
}

// Barrier `id` (1..15) of the 128 threads of one row tile.
__device__ __forceinline__ void row_tile_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Sums of v[0..8) over the warp's eight row groups (lane / 4), reduced and
// scattered in three shuffle steps: lane 4 g + t returns the sum of v[g].
__device__ __forceinline__ float sum_row_groups(const float (&v)[8],
                                                int lane) {
  const int g = lane / 4;
  float w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = g & 4;
    w[i] = (up ? v[i + 4] : v[i]) +
           __shfl_xor_sync(0xffffffffu, up ? v[i] : v[i + 4], 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool up = g & 2;
    x[i] = (up ? w[i + 2] : w[i]) +
           __shfl_xor_sync(0xffffffffu, up ? w[i] : w[i + 2], 8);
  }
  const bool up = g & 1;
  return (up ? x[1] : x[0]) +
         __shfl_xor_sync(0xffffffffu, up ? x[0] : x[1], 4);
}

// Layout of deep_link_kernel<128>. Warp w owns row tile w / 4 (16 of the
// item's 64 pairs) and column group w % 4 (32 of the 128 columns, four n8
// tiles) of each (P x H) product, and dW2's rows 16 (w / 2) .. + 16 and
// columns 64 (w % 2) .. + 64. h1 and dpre2 are double-buffered by item
// parity, so an item needs one block-wide barrier besides two of its row
// tile's.
template <>
struct Cfg<128> {
  static constexpr int H = 128, P = 64;
  static constexpr int LD = H + 8;      // bf16 row stride: 272 B, ldmatrix conflict-free
  static constexpr int LDT = H + 8;     // f32 row stride of t1: float2 reads conflict-free
  static constexpr int RT = P / 16;     // row tiles
  static constexpr int CG = WARPS / RT; // column groups of 32
  static constexpr size_t W2_OFF = 0;
  static constexpr size_t H1_OFF = W2_OFF + align128(sizeof(__nv_bfloat16) * H * LD);
  static constexpr size_t DP_OFF = H1_OFF + 2 * align128(sizeof(__nv_bfloat16) * P * LD);
  static constexpr size_t T1_OFF = DP_OFF + 2 * align128(sizeof(__nv_bfloat16) * P * LD);
  static constexpr size_t T2_OFF = T1_OFF + align128(sizeof(float) * P * LDT);
  static constexpr size_t B2_OFF = T2_OFF + align128(sizeof(float) * 2 * H);
  static constexpr size_t WO_OFF = B2_OFF + align128(sizeof(float) * H);
  static constexpr size_t LG_OFF = WO_OFF + align128(sizeof(float) * H);
  static constexpr size_t SD_OFF = LG_OFF + align128(sizeof(float) * P * CG);
  static constexpr size_t RED_OFF = SD_OFF + align128(sizeof(float) * 2 * RT * H);
  static constexpr size_t LL_OFF = RED_OFF + align128(sizeof(float) * 2 * RT * H);
  static constexpr size_t DBO_OFF = LL_OFF + align128(sizeof(float) * P);
  static constexpr size_t CODE_OFF = DBO_OFF + align128(sizeof(float) * P);
  static constexpr size_t STH_OFF = CODE_OFF + align128(P * CHUNK);
  static constexpr size_t SMEM = STH_OFF + align128(sizeof(float) * P * LDT);
  static_assert(RT * CG == WARPS && CG * 32 == H, "warp tiles");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_kernel<128>(const float* __restrict__ t1,
                      const float* __restrict__ t2,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ wo,
                      const float* __restrict__ bo,
                      const int8_t* __restrict__ pk,
                      float* __restrict__ scratch, int B, int M,
                      int items_per_split) {
  using C = Cfg<128>;
  constexpr int H = C::H, P = C::P, LD = C::LD, LDT = C::LDT, RT = C::RT,
                CG = C::CG;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2_s = reinterpret_cast<__nv_bfloat16*>(smem + C::W2_OFF);
  __nv_bfloat16* h1_2 = reinterpret_cast<__nv_bfloat16*>(smem + C::H1_OFF);
  __nv_bfloat16* dp_2 = reinterpret_cast<__nv_bfloat16*>(smem + C::DP_OFF);
  float* t1_s = reinterpret_cast<float*>(smem + C::T1_OFF);
  float* t2_s = reinterpret_cast<float*>(smem + C::T2_OFF);
  float* b2_s = reinterpret_cast<float*>(smem + C::B2_OFF);
  float* wo_s = reinterpret_cast<float*>(smem + C::WO_OFF);
  float* lg_s = reinterpret_cast<float*>(smem + C::LG_OFF);
  float* sd_s = reinterpret_cast<float*>(smem + C::SD_OFF);
  float* red_s = reinterpret_cast<float*>(smem + C::RED_OFF);
  float* ll_s = reinterpret_cast<float*>(smem + C::LL_OFF);
  float* dbo_s = reinterpret_cast<float*>(smem + C::DBO_OFF);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem + C::CODE_OFF);
  float* sth_s = reinterpret_cast<float*>(smem + C::STH_OFF);
  constexpr size_t BUF = align128(sizeof(__nv_bfloat16) * P * LD) /
                         sizeof(__nv_bfloat16);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = warp / CG, cg = warp % CG;
  const int wr0 = rt * 16, wc0 = cg * 32;       // the warp's product tile
  const int ra = wr0 + g, rb = ra + 8;           // this lane's two pairs
  const int dr0 = (warp / 2) * 16, dc0 = (warp % 2) * 64;   // its dW2 strip
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x, splits = gridDim.y;
  const int blk = tile * splits + split;
  const int b0 = tile * P;
  const int j0 = split * items_per_split;
  const int j1 = min(M, j0 + items_per_split);

  for (int i = tid; i < H * H; i += THREADS)
    w2_s[(i / H) * LD + i % H] = __float2bfloat16(w2[i]);
  for (int i = tid; i < P * H; i += THREADS) {
    const int r = i / H, c = i % H;
    sth_s[r * LDT + c] = 0.f;
    t1_s[r * LDT + c] =
        b0 + r < B ? t1[static_cast<size_t>(b0 + r) * H + c] : 0.f;
  }
  if (tid < H) {
    b2_s[tid] = b2[tid];
    wo_s[tid] = wo[tid];
    t2_s[tid] = j0 < j1 ? t2[static_cast<size_t>(j0) * H + tid] : 0.f;
  }
  if (tid < P) {
    ll_s[tid] = 0.f;
    dbo_s[tid] = 0.f;
  }
  const float bov = bo[0];
  __syncthreads();

  // Sums over the block's item run. A lane's accumulator positions: element
  // e of n8 tile n is row (e < 2 ? ra : rb), column wc0 + 8 n + 2 t + e % 2;
  // of dW2, row dr0 + g + 8 (e / 2) of 16-column tile i, half h, column
  // dc0 + 16 i + 8 h + 2 t + e % 2. dW2 in registers; s_theta in sth_s at
  // the lane's own positions (16 more registers a thread pushed ptxas into
  // spills at the 128 that 512 threads leave); db2 and dwo of the row tile's
  // pairs in column cs, each item's summed over the warp's rows first; ll
  // and dbo a pair in shared memory.
  float dw2[4][2][4] = {}, db2 = 0.f, dwo = 0.f;
  const int cs = wc0 + (g / 2) * 8 + 2 * t + g % 2;

  for (int j = j0; j < j1; ++j) {
    const int jj = (j - j0) % CHUNK, buf = (j - j0) & 1;
    __nv_bfloat16* h1_s = h1_2 + buf * BUF;
    __nv_bfloat16* dp_s = dp_2 + buf * BUF;
    if (jj == 0) {   // the row tile's codes of the next CHUNK items: thread
      // q takes row wr0 + q / 8, items 2 (q % 8) and + 1
      const int q = opaque(tid) % 128, crow = wr0 + q / 8, ci = 2 * (q % 8);
      const bool in = b0 + crow < B;
      const int8_t* src = opaque(pk) + static_cast<size_t>(b0 + crow) * M + j + ci;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        code_s[crow * CHUNK + ci + u] =
            in && j + ci + u < j1 ? src[u] : int8_t(0);
    }
    float t2_next = 0.f;
    if (tid < H && j + 1 < j1)
      t2_next = opaque(t2)[static_cast<size_t>(j + 1) * H + tid];

    // 1. bf16(h1) at this lane's positions of the row tile, and the relu
    // mask of its f32 pre-activations (bit 4 n + e)
    uint32_t live = 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc0 + 8 * n + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(t2_s + buf * H + c);
      const float2 xa = *reinterpret_cast<const float2*>(t1_s + ra * LDT + c);
      const float2 xb = *reinterpret_cast<const float2*>(t1_s + rb * LDT + c);
      const float p[4] = {xa.x + u.x, xa.y + u.y, xb.x + u.x, xb.y + u.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) live |= (p[e] > 0.f ? 1u : 0u) << (4 * n + e);
      *reinterpret_cast<__nv_bfloat162*>(h1_s + ra * LD + c) =
          __floats2bfloat162_rn(fmaxf(p[0], 0.f), fmaxf(p[1], 0.f));
      *reinterpret_cast<__nv_bfloat162*>(h1_s + rb * LD + c) =
          __floats2bfloat162_rn(fmaxf(p[2], 0.f), fmaxf(p[3], 0.f));
    }
    row_tile_sync(1 + rt);

    // 2. pre2 = h1 W2 + b2 (one chain over k, as the WMMA kernels')
    float acc[4][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, h1_s + (wr0 + lane % 16) * LD + k0 + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t b[4];
        ldsm_x4_trans(b, w2_s + (k0 + lane % 16) * LD + wc0 + 16 * n2 +
                             (lane / 16) * 8);
        mma_bf16(acc[2 * n2], a, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    // 3. the logit: this lane's 8 columns, its quad's 32, then the row
    // tile's four column groups in order (the same sum in every warp)
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc0 + 8 * n + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(b2_s + c);
      const float2 ww = *reinterpret_cast<const float2*>(wo_s + c);
      acc[n][0] += bb.x; acc[n][1] += bb.y;
      acc[n][2] += bb.x; acc[n][3] += bb.y;
      part[0] = fmaf(fmaxf(acc[n][0], 0.f), ww.x, part[0]);
      part[0] = fmaf(fmaxf(acc[n][1], 0.f), ww.y, part[0]);
      part[1] = fmaf(fmaxf(acc[n][2], 0.f), ww.x, part[1]);
      part[1] = fmaf(fmaxf(acc[n][3], 0.f), ww.y, part[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
    }
    if (t == 0) {
      lg_s[ra * CG + cg] = part[0];
      lg_s[rb * CG + cg] = part[1];
    }
    row_tile_sync(1 + rt);
    float dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      const float4 q = *reinterpret_cast<const float4*>(lg_s + r * CG);
      const float logit = (((q.x + q.y) + q.z) + q.w) + bov;
      const float cf = static_cast<float>(code_s[r * CHUNK + jj]);
      const float m = fminf(cf, 1.f), rr = fmaxf(cf - 1.f, 0.f);
      const float e = expf(-fabsf(logit));
      const float inv = 1.f / (1.f + e);
      const float s = logit >= 0.f ? inv : 1.f - inv;   // sigmoid(logit)
      dl[h] = m * (rr - s);
      if (cg == 0 && t == 0) {   // one lane a pair sums ll and dbo
        const float sp = log1pf(e) + fmaxf(logit, 0.f);   // softplus(logit)
        ll_s[r] += -m * (rr > 0.5f ? sp - logit : sp);
        dbo_s[r] += dl[h];
      }
    }
    // 4. dpre2 = [pre2 > 0] dlogit wo (bf16 to shared), db2 and dwo
    float vdb[8], vdw[8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc0 + 8 * n + 2 * t;
      const float2 ww = *reinterpret_cast<const float2*>(wo_s + c);
      float dp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[e] = acc[n][e] > 0.f ? dl[e / 2] * (e % 2 ? ww.y : ww.x) : 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        vdb[2 * n + e] = dp[e] + dp[e + 2];
        vdw[2 * n + e] = fmaf(fmaxf(acc[n][e + 2], 0.f), dl[1],
                              fmaxf(acc[n][e], 0.f) * dl[0]);
      }
      *reinterpret_cast<__nv_bfloat162*>(dp_s + ra * LD + c) =
          __floats2bfloat162_rn(dp[0], dp[1]);
      *reinterpret_cast<__nv_bfloat162*>(dp_s + rb * LD + c) =
          __floats2bfloat162_rn(dp[2], dp[3]);
    }
    db2 += sum_row_groups(vdb, lane);
    dwo += sum_row_groups(vdw, lane);
    if (tid < H && j + 1 < j1) t2_s[(buf ^ 1) * H + tid] = t2_next;
    __syncthreads();   // the only block-wide barrier of an item

    // 5. the previous item's s_d: its row tiles' partials, in order
    if (j > j0 && tid < H) {
      const float* s = sd_s + (buf ^ 1) * RT * H + tid;
      Parts(opaque(scratch), B, M, H, tiles, splits)
          .sd[(static_cast<size_t>(tile) * M + j - 1) * H + tid] =
          ((s[0] + s[H]) + s[2 * H]) + s[3 * H];
    }

    // 6. dW2 += h1^T dpre2: the item's product from a fresh accumulator (a
    // chain of P / 16 steps), added to the running sum with f32 adds: the
    // tensor cores do not round their f32 accumulation to nearest, so a
    // chain over the block's whole item run would drift (measured 3e-4 to
    // 9e-4 of dW2's largest element against the plain version)
#pragma unroll
    for (int i2 = 0; i2 < 4; i2 += 2) {
      float fresh[2][2][4] = {};
#pragma unroll 1
      for (int p0 = 0; p0 < P; p0 += 16) {
        uint32_t a[4];   // h1^T: rows dr0.. of dW2 by pairs p0..
        ldsm_x4_trans(a, h1_s + (p0 + lane % 8 + (lane / 16) * 8) * LD + dr0 +
                             ((lane / 8) % 2) * 8);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t b[4];
          ldsm_x4_trans(b, dp_s + (p0 + lane % 16) * LD + dc0 +
                               16 * (i2 + u) + (lane / 16) * 8);
          mma_bf16(fresh[u][0], a, b[0], b[1]);
          mma_bf16(fresh[u][1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) dw2[i2 + u][h][e] += fresh[u][h][e];
    }

    // 7. dh1 = dpre2 W2^T (one chain over W2's columns), the f32 h1 mask,
    // s_theta, and the row tile's part of the item's s_d
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, dp_s + (wr0 + lane % 16) * LD + k0 + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t b[4];   // W2^T as a col operand: (k, n) at w2_s[n][k]
        ldsm_x4(b, w2_s + (wc0 + 16 * n2 + lane % 8 + (lane / 16) * 8) * LD +
                       k0 + ((lane / 8) % 2) * 8);
        mma_bf16(acc[2 * n2], a, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    float col[8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float d1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d1[e] = (live >> (4 * n + e)) & 1u ? acc[n][e] : 0.f;
      const int c = wc0 + 8 * n + 2 * t;
      float2* sa = reinterpret_cast<float2*>(sth_s + ra * LDT + c);
      float2* sb = reinterpret_cast<float2*>(sth_s + rb * LDT + c);
      float2 va = *sa, vb = *sb;
      va.x += d1[0]; va.y += d1[1]; vb.x += d1[2]; vb.y += d1[3];
      *sa = va; *sb = vb;
      col[2 * n] = d1[0] + d1[2];
      col[2 * n + 1] = d1[1] + d1[3];
    }
    sd_s[(buf * RT + rt) * H + cs] = sum_row_groups(col, lane);
  }
  __syncthreads();

  // the last item's s_d, this split's ll and s_theta of the block's
  // students, the block's dW2
  const Parts parts(opaque(scratch), B, M, H, tiles, splits);
  if (j1 > j0 && tid < H) {
    const float* s = sd_s + ((j1 - 1 - j0) & 1) * RT * H + tid;
    parts.sd[(static_cast<size_t>(tile) * M + j1 - 1) * H + tid] =
        ((s[0] + s[H]) + s[2 * H]) + s[3 * H];
  }
  if (tid < P && b0 + tid < B)
    parts.ll[static_cast<size_t>(split) * B + b0 + tid] = ll_s[tid];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = b0 + (h ? rb : ra);
    if (row >= B) continue;
    float* dst = parts.sth + (static_cast<size_t>(split) * B + row) * H;
#pragma unroll
    for (int n = 0; n < 4; ++n)
      *reinterpret_cast<float2*>(dst + wc0 + 8 * n + 2 * t) =
          *reinterpret_cast<const float2*>(sth_s + (h ? rb : ra) * LDT + wc0 + 8 * n + 2 * t);
  }
  float* dw2_blk = parts.dw2 + static_cast<size_t>(blk) * H * H;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            dw2_blk + static_cast<size_t>(dr0 + g + 8 * r) * H + dc0 +
            16 * i + 8 * h + 2 * t) =
            make_float2(dw2[i][h][2 * r], dw2[i][h][2 * r + 1]);
  // db2, dwo over the row tiles in order; dbo over the block's pairs
  red_s[rt * H + cs] = db2;
  red_s[(RT + rt) * H + cs] = dwo;
  __syncthreads();
  if (tid < H) {
    const float* s = red_s + tid;
    parts.db2[static_cast<size_t>(blk) * H + tid] =
        ((s[0] + s[H]) + s[2 * H]) + s[3 * H];
    s += RT * H;
    parts.dwo[static_cast<size_t>(blk) * H + tid] =
        ((s[0] + s[H]) + s[2 * H]) + s[3 * H];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < P; ++r) s += dbo_s[r];
    parts.dbo[blk] = s;
  }
}

// ---- H = 256, 384, 512: a thread-block cluster a student tile -----------

// Two 8x8 bf16 matrices from shared memory, lanes 0 .. 15 giving the row
// addresses (ldsm_x4's first two).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// bf16(lo), bf16(hi) (round to nearest even) in one word, lo first in
// memory.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Every thread of the cluster here (and every CTA of it running).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `local`'s place in CTA `rank` of the
// cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(local)), "r"(rank));
  return a;
}

// V consecutive floats at p (16 or 8 bytes aligned) and their store.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// bf16 of V floats (round to nearest even) at p (8 or 4 bytes aligned).
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p,
                                           const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  else
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
}

// The cluster's size C at each width, and a warp's tile of the CTA's dW2
// panel (DR m16 row tiles x DN n8 tiles): C keeps the panel at 32-36
// floats a lane of 512 threads.
template <int H>
struct ClusterWidth;
template <>
struct ClusterWidth<256> { static constexpr int C = 4, DR = 2, DN = 4; };
template <>
struct ClusterWidth<384> { static constexpr int C = 8, DR = 3, DN = 3; };
template <>
struct ClusterWidth<512> { static constexpr int C = 16, DR = 2, DN = 4; };

// Layout of deep_link_cluster_kernel<H>. h1 and dpre2 are kept whole in
// every CTA, panel-major (CTA q's panel, P rows, at q PANEL), so that a
// CTA's panel is one contiguous copy; a panel's rows are N + 8 bf16 apart,
// or at N = 32 (where the padding would outgrow the shared memory) N apart
// with the 16-byte chunks of row p XOR-swizzled by (p / 2) % 4, both free of
// ldmatrix bank conflicts. In the (P x N) products
// (pre2, dh1) warp w takes row tile w / 8, column half (w / 4) % 2 and
// contraction quarter w % 4; in dW2's panel, rows 16 DR (w / DCG) .. and n8
// tiles DN (w % DCG) ... The element passes give a pair 16 lanes, each VEC
// of the panel's columns.
template <int H>
struct Clu {
  static constexpr int C = ClusterWidth<H>::C;
  static constexpr int P = 32;          // students a cluster, pairs an item
  static constexpr int N = H / C;       // a CTA's panel of columns
  static constexpr int NT = N / 8;      // n8 tiles of a panel
  static constexpr int NW = N / 16;     // n8 tiles of a warp in pre2, dh1
  static constexpr int KQ = H / 4;      // a warp's quarter of the contraction
  static constexpr int VEC = N == 32 ? 2 : 4;  // columns a lane (element passes)
  static constexpr int LP = 16;         // lanes a pair (element passes)
  static constexpr int DR = ClusterWidth<H>::DR, DN = ClusterWidth<H>::DN;
  static constexpr int DCG = NT / DN;   // dW2's column groups of warps
  static constexpr bool SWZ = N == 32;  // swizzled panels
  static constexpr int LDP = SWZ ? N : N + 8;   // bf16 stride of a panel
  static constexpr int LDC = N + 8;     // bf16 stride: W2's column panel
  static constexpr int LDH = H + 8;     // bf16 stride: W2's row panel
  static constexpr int LDR = N + 4;     // f32 stride: the (P x N) arrays
  static constexpr int PANEL = P * LDP;         // bf16 of a panel of h1, dpre2
  static constexpr int BUFE = C * PANEL;        // bf16 of a whole h1, dpre2
  static constexpr uint32_t PANEL_BYTES = sizeof(__nv_bfloat16) * PANEL;
  static constexpr size_t PN = align128(sizeof(float) * P * LDR);
  static constexpr size_t W2C_OFF = 0;
  static constexpr size_t W2R_OFF =
      W2C_OFF + align128(sizeof(__nv_bfloat16) * H * LDC);
  static constexpr size_t H1_OFF =
      W2R_OFF + align128(sizeof(__nv_bfloat16) * N * LDH);
  static constexpr size_t DP_OFF =
      H1_OFF + 2 * align128(sizeof(__nv_bfloat16) * BUFE);
  static constexpr size_t RED_OFF =         // 4 split-k partials
      DP_OFF + align128(sizeof(__nv_bfloat16) * BUFE);
  static constexpr size_t T1_OFF = RED_OFF + 4 * PN;
  static constexpr size_t STH_OFF = T1_OFF + PN;
  static constexpr size_t DB2_OFF = STH_OFF + PN;
  static constexpr size_t DWO_OFF = DB2_OFF + PN;
  static constexpr size_t SD_OFF = DWO_OFF + PN;
  static constexpr size_t T2_OFF = SD_OFF + PN;
  static constexpr size_t B2_OFF = T2_OFF + align128(sizeof(float) * 2 * N);
  static constexpr size_t WO_OFF = B2_OFF + align128(sizeof(float) * N);
  static constexpr size_t LGX_OFF = WO_OFF + align128(sizeof(float) * N);
  static constexpr size_t BAR_OFF =          // the logit partials' [2][C][P]
      LGX_OFF + align128(sizeof(float) * 2 * C * P);
  static constexpr size_t DBO_OFF = BAR_OFF + align128(3 * sizeof(uint64_t));
  static constexpr size_t CODE_OFF = DBO_OFF + align128(sizeof(float) * P);
  static constexpr size_t SMEM = CODE_OFF + align128(P * CHUNK);
  static_assert(C * N == H && N % 16 == 0, "panels");
  static_assert((H / 16 / DR) * DCG == WARPS && DCG * DN == NT, "dW2 tiles");
  static_assert(P * CHUNK == THREADS && P * LP == THREADS &&
                N <= LP * VEC && N <= THREADS && NT <= WARPS, "passes");
  static_assert(2 * 2 * 4 == WARPS && KQ % 16 == 0, "product tiles");
  static_assert(PANEL_BYTES % 128 == 0 && P * sizeof(float) % 16 == 0,
                "bulk copies");
  static_assert(SMEM <= 232448, "shared memory of one block");

  // Offset (bf16) of row p, 8-column chunk c in a panel
  static __device__ __forceinline__ int at(int p, int c) {
    if constexpr (SWZ) return p * N + 8 * (c ^ ((p >> 1) & 3));
    return p * LDP + 8 * c;
  }
};

// Stores a warp's (16 x 8 NW) accumulator tile at rows r0.., columns n0..
// of dst (f32, row stride LDR).
template <int NW, int LDR>
__device__ __forceinline__ void store_tile(float* dst, int r0, int n0,
                                           int lane,
                                           const float (&acc)[NW][4]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int u = 0; u < NW; ++u) {
    const int c = n0 + 8 * u + 2 * t;
    *reinterpret_cast<float2*>(dst + (r0 + g) * LDR + c) =
        make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(dst + (r0 + g + 8) * LDR + c) =
        make_float2(acc[u][2], acc[u][3]);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// This thread's arrival on bar, which also expects `bytes` of copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// This thread's shared-memory stores, before a bulk copy reads them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` at `local` into the same place of CTA `rank`'s shared memory, by
// the copy engine, completing on that CTA's barrier at `bar`'s place.
__device__ __forceinline__ void copy_to_rank(const void* local,
                                             uint32_t bytes,
                                             const uint64_t* bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(cluster_addr(local, rank)),
      "r"(smem_addr(local)), "r"(bytes), "r"(cluster_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's committed copies have read their sources.
__device__ __forceinline__ void copies_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// What crosses the CTAs goes by bulk copies onto the receiver's barriers,
// each completing once an item (phase = item parity): bar[0] the item's
// logit partials, bar[1] its dpre2 panels, bar[2] its h1 panels (sent
// during the item before). No cluster barrier is needed an item: a CTA
// sends item j's logit partials only after every CTA's h1 of item j has
// reached it, and item j's dpre2 and item j + 1's h1 only after every CTA's
// logit partials of item j have, so each copy lands where every CTA has
// finished reading (h1 and the logit partials are double-buffered by item
// parity; dpre2 is read before a CTA's item j + 1 partials go out).
template <int H>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_cluster_kernel(const float* __restrict__ t1,
                         const float* __restrict__ t2,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ wo,
                         const float* __restrict__ bo,
                         const int8_t* __restrict__ pk,
                         float* __restrict__ scratch, int B, int M,
                         int items_per_split) {
  using K = Clu<H>;
  constexpr int C = K::C, P = K::P, N = K::N, NT = K::NT, NW = K::NW,
                KQ = K::KQ, LP = K::LP, V = K::VEC, DR = K::DR, DN = K::DN,
                DCG = K::DCG, LDC = K::LDC, LDH = K::LDH, LDR = K::LDR,
                PANEL = K::PANEL, BUFE = K::BUFE;
  constexpr int RS = K::PN / sizeof(float);      // floats between partials
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2c_s = reinterpret_cast<__nv_bfloat16*>(smem + K::W2C_OFF);
  __nv_bfloat16* w2r_s = reinterpret_cast<__nv_bfloat16*>(smem + K::W2R_OFF);
  __nv_bfloat16* h1_2 = reinterpret_cast<__nv_bfloat16*>(smem + K::H1_OFF);
  __nv_bfloat16* dp_s = reinterpret_cast<__nv_bfloat16*>(smem + K::DP_OFF);
  float* red_s = reinterpret_cast<float*>(smem + K::RED_OFF);
  float* t1_s = reinterpret_cast<float*>(smem + K::T1_OFF);
  float* sth_s = reinterpret_cast<float*>(smem + K::STH_OFF);
  float* db2_s = reinterpret_cast<float*>(smem + K::DB2_OFF);
  float* dwo_s = reinterpret_cast<float*>(smem + K::DWO_OFF);
  float* sd_s = reinterpret_cast<float*>(smem + K::SD_OFF);
  float* t2_s = reinterpret_cast<float*>(smem + K::T2_OFF);
  float* b2_s = reinterpret_cast<float*>(smem + K::B2_OFF);
  float* wo_s = reinterpret_cast<float*>(smem + K::WO_OFF);
  float* lgx_s = reinterpret_cast<float*>(smem + K::LGX_OFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + K::BAR_OFF);
  float* dbo_s = reinterpret_cast<float*>(smem + K::DBO_OFF);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem + K::CODE_OFF);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x / C, split = blockIdx.y;
  const int tiles = gridDim.x / C, splits = gridDim.y;
  const int blk = tile * splits + split;
  const int b0 = tile * P, c0 = rank * N;   // students, the panel's columns
  const int j0 = split * items_per_split;
  const int j1 = min(M, j0 + items_per_split);
  // element passes: pair ep, the panel's columns en .. en + V
  const int ep = tid / LP, en = (tid % LP) * V;
  const bool elem = en < N;
  // the offset of the pair's columns in a panel (bf16)
  const int pan = K::at(ep, en / 8) + en % 8;
  // the (P x N) products' warp tile; dW2's
  const int rt = warp / 8, half = (warp / 4) % 2, quarter = warp % 4;
  const int rg = warp / DCG, cgd = warp % DCG;

  // bytes at `local` into the same place of every other CTA, lane q of
  // warp 0 sending to rank + q
  const bool sender = warp == 0 && lane >= 1 && lane < C;
  auto send = [&](const void* local, uint32_t bytes, const uint64_t* b) {
    if (sender) copy_to_rank(local, bytes, b, (rank + lane) % C);
  };
  // bf16(h1) of the pair's V columns of the panel for the item whose t2 is
  // t2_s[buf], into this CTA's panel of h1 buffer buf; returns the relu mask
  // of their f32 pre-activations (bit e: column en + e)
  auto build_h1 = [&](int buf) -> uint32_t {
    float x[V], u[V];
    load_vec(t1_s + ep * LDR + en, x);
    load_vec(t2_s + buf * N + en, u);
    uint32_t live = 0;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] += u[e];
      live |= (x[e] > 0.f ? 1u : 0u) << e;
      x[e] = fmaxf(x[e], 0.f);
    }
    store_bf16(h1_2 + buf * BUFE + rank * PANEL + pan, x);
    return live;
  };

  // W2's column panel (pre2's B) and row panel (dh1's B), once a CTA, 4
  // floats a load
#pragma unroll 4
  for (int i = tid; i < H * N / 4; i += THREADS) {
    const int k = i / (N / 4), n = i % (N / 4) * 4;
    float v[4];
    load_vec(w2 + static_cast<size_t>(k) * H + c0 + n, v);
    store_bf16(w2c_s + k * LDC + n, v);
  }
#pragma unroll 4
  for (int i = tid; i < N * H / 4; i += THREADS) {
    const int q = i / (H / 4), n = i % (H / 4) * 4;
    float v[4];
    load_vec(w2 + static_cast<size_t>(c0 + q) * H + n, v);
    store_bf16(w2r_s + q * LDH + n, v);
  }
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N, o = p * LDR + n;
    t1_s[o] = b0 + p < B ? t1[static_cast<size_t>(b0 + p) * H + c0 + n] : 0.f;
    sth_s[o] = 0.f;
    db2_s[o] = 0.f;
    dwo_s[o] = 0.f;
  }
  if (tid < N) {
    b2_s[tid] = b2[c0 + tid];
    wo_s[tid] = wo[c0 + tid];
    t2_s[tid] = j0 < j1 ? t2[static_cast<size_t>(j0) * H + c0 + tid] : 0.f;
  }
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float bov = bo[0];
  __syncthreads();
  cluster_sync();   // every CTA runs, its barriers ready, before any copy
  uint32_t live = 0;   // relu mask bits: this item's 0..V-1, the next's V..
  if (j0 < j1) {   // the first item's h1 everywhere
    if (elem) {
      live = build_h1(0);
      fence_async_shared();
    }
    __syncthreads();
    if (tid == 0) mbar_arrive_expect(&bar[2], (C - 1) * K::PANEL_BYTES);
    send(h1_2 + rank * PANEL, K::PANEL_BYTES, &bar[2]);
    if (sender) copies_commit();
  }

  // Sums over the block's item run: dW2[:, panel] in registers (element e
  // of n8 tile u of row tile i: row 16 (DR rg + i) + g + 8 (e / 2), panel
  // column 8 (DN cgd + u) + 2 t + e % 2); s_theta, db2 and dwo a pair and
  // panel column in shared memory; ll and dbo a pair in its first lane
  float dw2[DR][DN][4] = {};
  float ll_acc = 0.f, dbo_acc = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int jj = (j - j0) % CHUNK, buf = (j - j0) & 1;
    const bool next = j + 1 < j1;
    const __nv_bfloat16* h1_s = h1_2 + buf * BUFE;
    if (jj == 0) {   // the next CHUNK items' codes, one a thread
      const int p = tid / CHUNK, i = tid % CHUNK;
      code_s[tid] = b0 + p < B && j + i < j1
                        ? pk[static_cast<size_t>(b0 + p) * M + j + i]
                        : int8_t(0);
    }
    float t2_next = 0.f;
    if (tid < N && next)
      t2_next = t2[static_cast<size_t>(j + 1) * H + c0 + tid];
    // this CTA's earlier copies have read the panels step 3 rewrites
    if (sender) copies_read();
    mbar_wait(&bar[2], buf);   // every CTA's panel of this item's h1

    // 1. pre2[:, panel]: the warp's 16 pairs x N / 2 columns over its
    // quarter of k, one chain, into the quarter's partial sums
    {
      const int r0 = rt * 16, n0 = half * (N / 2);
      float acc[NW][4] = {};
#pragma unroll 2
      for (int k0 = quarter * KQ; k0 < (quarter + 1) * KQ; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, h1_s + (k0 / N) * PANEL +
                       K::at(r0 + lane % 16, (k0 % N) / 8 + lane / 16));
#pragma unroll
        for (int u = 0; u < NW; u += 2) {
          if (u + 1 < NW) {
            uint32_t b[4];
            ldsm_x4_trans(b, w2c_s + (k0 + lane % 16) * LDC + n0 + 8 * u +
                                 (lane / 16) * 8);
            mma_bf16(acc[u], a, b[0], b[1]);
            mma_bf16(acc[u + 1], a, b[2], b[3]);
          } else {
            uint32_t b[2];
            ldsm_x2_trans(b, w2c_s + (k0 + lane % 16) * LDC + n0 + 8 * u);
            mma_bf16(acc[u], a, b[0], b[1]);
          }
        }
      }
      store_tile<NW, LDR>(red_s + quarter * RS, r0, n0, lane, acc);
    }
    if (tid < N && next) t2_s[(buf ^ 1) * N + tid] = t2_next;
    __syncthreads();

    // 2. pre2 = the quarters in order + b2, and the panel's share of each
    // pair's logit (its V columns, its LP lanes in order), sent to every CTA
    float pre2[V], wov[V];
    {
      float lg = 0.f;
      if (elem) {
        float q[4][V], b[V];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_vec(red_s + i * RS + ep * LDR + en, q[i]);
        load_vec(b2_s + en, b);
        load_vec(wo_s + en, wov);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          pre2[e] = (((q[0][e] + q[1][e]) + q[2][e]) + q[3][e]) + b[e];
          lg = fmaf(fmaxf(pre2[e], 0.f), wov[e], lg);
        }
      }
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1)
        lg += __shfl_xor_sync(0xffffffffu, lg, o);
      if (en == 0) {
        lgx_s[(buf * C + rank) * P + ep] = lg;
        fence_async_shared();
      }
    }
    __syncthreads();
    if (tid == 0) mbar_arrive_expect(&bar[0], (C - 1) * P * sizeof(float));
    send(lgx_s + (buf * C + rank) * P, P * sizeof(float), &bar[0]);
    if (sender) copies_commit();
    mbar_wait(&bar[0], buf);   // every CTA's logit partials here

    // 3. the logit (the panels in rank order, the same in every CTA), ll,
    // dlogit; dpre2[:, panel] (bf16), db2, dwo; the next item's h1
    if (elem) {
      const float* lgx = lgx_s + buf * C * P + ep;
      float logit = lgx[0];
#pragma unroll
      for (int q = 1; q < C; ++q) logit += lgx[q * P];
      logit += bov;
      const float cf = static_cast<float>(code_s[ep * CHUNK + jj]);
      const float m = fminf(cf, 1.f), rr = fmaxf(cf - 1.f, 0.f);
      const float e = expf(-fabsf(logit));
      const float inv = 1.f / (1.f + e);
      const float s = logit >= 0.f ? inv : 1.f - inv;   // sigmoid(logit)
      const float dl = m * (rr - s);
      if (en == 0) {   // one lane a pair sums ll and dbo
        const float sp = log1pf(e) + fmaxf(logit, 0.f);   // softplus(logit)
        ll_acc += -m * (rr > 0.5f ? sp - logit : sp);
        dbo_acc += dl;
      }
      float d[V], db[V], dw[V];
      load_vec(db2_s + ep * LDR + en, db);
      load_vec(dwo_s + ep * LDR + en, dw);
#pragma unroll
      for (int e2 = 0; e2 < V; ++e2) {
        d[e2] = pre2[e2] > 0.f ? dl * wov[e2] : 0.f;
        db[e2] += d[e2];
        dw[e2] = fmaf(fmaxf(pre2[e2], 0.f), dl, dw[e2]);
      }
      store_vec(db2_s + ep * LDR + en, db);
      store_vec(dwo_s + ep * LDR + en, dw);
      store_bf16(dp_s + rank * PANEL + pan, d);
      if (next) live |= build_h1(buf ^ 1) << V;
      fence_async_shared();
    }
    __syncthreads();   // this CTA's panels of dpre2 and the next h1
    if (tid == 0) {
      mbar_arrive_expect(&bar[1], (C - 1) * K::PANEL_BYTES);
      if (next) mbar_arrive_expect(&bar[2], (C - 1) * K::PANEL_BYTES);
    }
    send(dp_s + rank * PANEL, K::PANEL_BYTES, &bar[1]);
    if (next)
      send(h1_2 + (buf ^ 1) * BUFE + rank * PANEL, K::PANEL_BYTES, &bar[2]);
    if (sender) copies_commit();

    // 4. dW2[:, panel] += h1^T dpre2[:, panel]: the item's product from a
    // fresh accumulator (a chain of P / 16 steps), added with f32 adds
#pragma unroll
    for (int i = 0; i < DR; ++i) {
      const int k0 = (rg * DR + i) * 16;
      float fresh[DN][4] = {};
#pragma unroll
      for (int p0 = 0; p0 < P; p0 += 16) {
        uint32_t a[4];   // h1^T: rows k0.. of dW2 by pairs p0..
        ldsm_x4_trans(a, h1_s + (k0 / N) * PANEL +
                             K::at(p0 + lane % 8 + (lane / 16) * 8,
                                   (k0 % N) / 8 + (lane / 8) % 2));
#pragma unroll
        for (int u = 0; u < DN; u += 2) {
          const __nv_bfloat16* dp_r = dp_s + rank * PANEL;
          if (u + 1 < DN) {
            uint32_t b[4];
            ldsm_x4_trans(b, dp_r + K::at(p0 + lane % 16,
                                          cgd * DN + u + lane / 16));
            mma_bf16(fresh[u], a, b[0], b[1]);
            mma_bf16(fresh[u + 1], a, b[2], b[3]);
          } else {
            uint32_t b[2];
            ldsm_x2_trans(b, dp_r + K::at(p0 + lane % 16, cgd * DN + u));
            mma_bf16(fresh[u], a, b[0], b[1]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < DN; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dw2[i][u][e] += fresh[u][e];
    }
    mbar_wait(&bar[1], buf);   // every CTA's panel of dpre2 here

    // 5. dh1[:, panel] = dpre2 W2[panel, :]^T: the warp's 16 pairs x N / 2
    // of the panel's columns over its quarter of n, into the partial sums
    {
      const int r0 = rt * 16, q0 = half * (N / 2);
      float acc[NW][4] = {};
#pragma unroll 2
      for (int n0 = quarter * KQ; n0 < (quarter + 1) * KQ; n0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, dp_s + (n0 / N) * PANEL +
                       K::at(r0 + lane % 16, (n0 % N) / 8 + lane / 16));
#pragma unroll
        for (int u = 0; u < NW; u += 2) {
          // W2[panel, :]^T as a col operand: (n, q) at w2r_s[q][n]
          if (u + 1 < NW) {
            uint32_t b[4];
            ldsm_x4(b, w2r_s + (q0 + 8 * u + lane % 8 + (lane / 16) * 8) * LDH +
                           n0 + ((lane / 8) % 2) * 8);
            mma_bf16(acc[u], a, b[0], b[1]);
            mma_bf16(acc[u + 1], a, b[2], b[3]);
          } else {
            uint32_t b[2];
            ldsm_x2(b, w2r_s + (q0 + 8 * u + lane % 8) * LDH + n0 +
                           ((lane / 8) % 2) * 8);
            mma_bf16(acc[u], a, b[0], b[1]);
          }
        }
      }
      store_tile<NW, LDR>(red_s + quarter * RS, r0, q0, lane, acc);
    }
    __syncthreads();

    // 6. dpre1 = [t1 + t2 > 0] dh1 (the mask of the f32 pre-activations,
    // kept from building h1) into s_theta and the item's s_d
    if (elem) {
      const int o = ep * LDR + en;
      float q[4][V], st[V], d[V];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(red_s + i * RS + o, q[i]);
      load_vec(sth_s + o, st);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = ((q[0][e] + q[1][e]) + q[2][e]) + q[3][e];
        d[e] = (live >> e) & 1u ? v : 0.f;
        st[e] += d[e];
      }
      store_vec(sth_s + o, st);
      store_vec(sd_s + o, d);
    }
    live >>= V;
    __syncthreads();
    // the item's s_d of the panel: the last NT warps, 8 columns each, a
    // lane summing 8 pairs, then the lanes' four groups of pairs in order
    if (warp >= WARPS - NT) {
      const int col = (warp - (WARPS - NT)) * 8 + lane % 8, pg = lane / 8;
      const float* src = sd_s + pg * 8 * LDR + col;
      float s = src[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) s += src[i * LDR];
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (pg == 0)
        Parts(scratch, B, M, H, tiles, splits)
            .sd[(static_cast<size_t>(tile) * M + j) * H + c0 + col] = s;
    }
  }

  // the block's dW2 panel, this split's s_theta, ll and dbo of the block's
  // students, db2 and dwo over the pairs in order; no copy reaches this CTA
  // after its last wait, and its own have read their sources before it ends
  const Parts parts(scratch, B, M, H, tiles, splits);
  float* dw2_blk = parts.dw2 + static_cast<size_t>(blk) * H * H + c0;
  {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < DR; ++i)
#pragma unroll
      for (int u = 0; u < DN; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              dw2_blk + static_cast<size_t>((rg * DR + i) * 16 + g + 8 * r) * H +
              (cgd * DN + u) * 8 + 2 * t) =
              make_float2(dw2[i][u][2 * r], dw2[i][u][2 * r + 1]);
  }
  if (en == 0) {
    dbo_s[ep] = dbo_acc;
    if (rank == 0 && b0 + ep < B)
      parts.ll[static_cast<size_t>(split) * B + b0 + ep] = ll_acc;
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N;
    if (b0 + p < B)
      parts.sth[(static_cast<size_t>(split) * B + b0 + p) * H + c0 + n] =
          sth_s[p * LDR + n];
  }
  if (tid < N) {
    float sb = 0.f, sw = 0.f;
    for (int p = 0; p < P; ++p) {
      sb += db2_s[p * LDR + tid];
      sw += dwo_s[p * LDR + tid];
    }
    parts.db2[static_cast<size_t>(blk) * H + c0 + tid] = sb;
    parts.dwo[static_cast<size_t>(blk) * H + c0 + tid] = sw;
  }
  if (rank == 0 && tid == 0) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += dbo_s[p];
    parts.dbo[blk] = s;
  }
  if (sender) copies_read();
}

// ---- the wide variant (every other H % 16 == 0) -----------------------

// Dynamic shared memory of deep_link_wide_kernel, each region 128-byte
// aligned; ld, ldf: the bf16 and f32 row strides.
struct WideLayout {
  int ld, ldf;
  size_t h1, dp, st, b2, wo, db2, dwo, dl, ll, dbo, code, bytes;
  __host__ __device__ WideLayout(int P, int H) : ld(H + 8), ldf(H + 4) {
    size_t o = 0;
    h1 = o; o += align128(sizeof(__nv_bfloat16) * P * ld);
    dp = o; o += align128(sizeof(__nv_bfloat16) * P * ld);
    st = o; o += align128(sizeof(float) * P * ldf);
    b2 = o; o += align128(sizeof(float) * H);
    wo = o; o += align128(sizeof(float) * H);
    db2 = o; o += align128(sizeof(float) * H);
    dwo = o; o += align128(sizeof(float) * H);
    dl = o; o += align128(sizeof(float) * P);
    ll = o; o += align128(sizeof(float) * P);
    dbo = o; o += align128(sizeof(float) * P);
    code = o; o += align128(P * CHUNK);
    bytes = o;
  }
};

// The students a block of the wide variant owns at width H: 32 where they
// fit the shared memory, else 16; 0 when not even 16 do.
inline int wide_rows(int H) {
  if (WideLayout(32, H).bytes <= 232448) return 32;
  if (WideLayout(16, H).bytes <= 232448) return 16;
  return 0;
}

// Where the bf16 copy of W2 sits in the scratch (floats), 32-byte aligned.
inline long long wide_w2_offset(long long floats) {
  return (floats + 31) / 32 * 32;
}

__global__ void round_bf16_kernel(const float* __restrict__ x,
                                  __nv_bfloat16* __restrict__ y, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    y[i] = __float2bfloat16(x[i]);
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_wide_kernel(const float* __restrict__ t1,
                      const float* __restrict__ t2,
                      const __nv_bfloat16* __restrict__ w2h,
                      const float* __restrict__ b2,
                      const float* __restrict__ wo,
                      const float* __restrict__ bo,
                      const int8_t* __restrict__ pk,
                      float* __restrict__ scratch, int B, int M, int H,
                      int items_per_split) {
  const WideLayout L(P, H);
  const int LD = L.ld, LDF = L.ldf, TC = H / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* h1_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h1);
  __nv_bfloat16* dp_s = reinterpret_cast<__nv_bfloat16*>(smem + L.dp);
  float* st_s = reinterpret_cast<float*>(smem + L.st);
  float* b2_s = reinterpret_cast<float*>(smem + L.b2);
  float* wo_s = reinterpret_cast<float*>(smem + L.wo);
  float* db2_s = reinterpret_cast<float*>(smem + L.db2);
  float* dwo_s = reinterpret_cast<float*>(smem + L.dwo);
  float* dl_s = reinterpret_cast<float*>(smem + L.dl);
  float* ll_s = reinterpret_cast<float*>(smem + L.ll);
  float* dbo_s = reinterpret_cast<float*>(smem + L.dbo);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem + L.code);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x, splits = gridDim.y;
  const int blk = tile * splits + split;
  const int b0 = tile * P;
  const int j0 = split * items_per_split;
  const int j1 = min(M, j0 + items_per_split);
  Parts parts(scratch, B, M, H, tiles, splits);
  float* dw2_blk = parts.dw2 + static_cast<size_t>(blk) * H * H;
  float* sth = parts.sth + static_cast<size_t>(split) * B * H;
  const float bov = bo[0];

  for (int c = tid; c < H; c += THREADS) {
    b2_s[c] = b2[c];
    wo_s[c] = wo[c];
    db2_s[c] = 0.f;
    dwo_s[c] = 0.f;
  }
  for (int r = tid; r < P; r += THREADS) {
    ll_s[r] = 0.f;
    dbo_s[r] = 0.f;
  }
  // the block's own partials, added into every item below
  for (size_t i = tid; i < static_cast<size_t>(H) * H; i += THREADS)
    dw2_blk[i] = 0.f;
  for (int c = tid; c < H; c += THREADS)
    for (int r = 0; r < P && b0 + r < B; ++r)
      sth[static_cast<size_t>(b0 + r) * H + c] = 0.f;
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const int jj = (j - j0) % CHUNK;
    if (jj == 0) {
      for (int i = tid; i < P * CHUNK; i += THREADS) {
        const int row = b0 + i / CHUNK, item = j + i % CHUNK;
        code_s[i] = (row < B && item < j1)
                        ? pk[static_cast<size_t>(row) * M + item] : int8_t(0);
      }
    }
    const float* t2j = t2 + static_cast<size_t>(j) * H;

    // 1. bf16(h1) of the item's P pairs
    for (int i = tid; i < P * H; i += THREADS) {
      const int r = i / H, c = i % H, row = b0 + r;
      const float t1v = row < B ? t1[static_cast<size_t>(row) * H + c] : 0.f;
      h1_s[r * LD + c] = __float2bfloat16(fmaxf(t1v + t2j[c], 0.f));
    }
    __syncthreads();

    // 2. h1 W2 -> staging, W2's fragments from the bf16 copy in L2. Each
    // k step's product starts from a zero fragment and is added with f32
    // adds: a chain of H / 16 steps through the tensor cores' truncating
    // accumulation puts pre2 further from the plain version's, and each
    // pre2 within that distance of 0 is a relu flip (a chained product
    // flipped more of config 5's s_theta rows at H = 512 than the 1 % its
    // check allows, on an H100)
    for (int t = warp; t < (P / 16) * TC; t += WARPS) {
      const int tr = t / TC, tc = t % TC;
      FragC acc, part;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < H; k0 += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, h1_s + tr * 16 * LD + k0, LD);
        wmma::load_matrix_sync(b, w2h + static_cast<size_t>(k0) * H + tc * 16,
                               H);
        wmma::fill_fragment(part, 0.f);
        wmma::mma_sync(part, a, b, part);
#pragma unroll
        for (int e = 0; e < part.num_elements; ++e) acc.x[e] += part.x[e];
      }
      wmma::store_matrix_sync(st_s + tr * 16 * LDF + tc * 16, acc, LDF,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // 3. row pass, a warp a pair: logit, ll and dlogit
    for (int r = warp; r < P; r += WARPS) {
      const float* row = st_s + r * LDF;
      float acc = 0.f;
      for (int c = lane; c < H; c += 32)
        acc = fmaf(fmaxf(row[c] + b2_s[c], 0.f), wo_s[c], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        const float logit = acc + bov;
        const float cf = static_cast<float>(code_s[r * CHUNK + jj]);
        const float m = fminf(cf, 1.f), rr = fmaxf(cf - 1.f, 0.f);
        const float e = expf(-fabsf(logit));
        const float sp = log1pf(e) + fmaxf(logit, 0.f);   // softplus(logit)
        ll_s[r] += -m * (rr > 0.5f ? sp - logit : sp);
        const float inv = 1.f / (1.f + e);
        const float sg = logit >= 0.f ? inv : 1.f - inv;  // sigmoid(logit)
        const float dl = m * (rr - sg);
        dbo_s[r] += dl;
        dl_s[r] = dl;
      }
    }
    __syncthreads();

    // 4. column pass, a thread a column: dpre2 (bf16 to shared), db2, dwo
    for (int c = tid; c < H; c += THREADS) {
      float db = 0.f, dw = 0.f;
      for (int r = 0; r < P; ++r) {
        const float pre2 = st_s[r * LDF + c] + b2_s[c];
        const float dl = dl_s[r];
        dw = fmaf(fmaxf(pre2, 0.f), dl, dw);
        const float dp = pre2 > 0.f ? dl * wo_s[c] : 0.f;
        db += dp;
        dp_s[r * LD + c] = __float2bfloat16(dp);
      }
      db2_s[c] += db;
      dwo_s[c] += dw;
    }
    __syncthreads();

    // 5. the block's dW2 partial += h1^T dpre2 (the item's product from a
    // fresh fragment, added with f32 adds), then dh1 = dpre2 W2^T -> staging
    for (int t = warp; t < TC * TC; t += WARPS) {
      const int tr = t / TC, tc = t % TC;
      FragC part, acc;
      wmma::fill_fragment(part, 0.f);
#pragma unroll
      for (int p0 = 0; p0 < P; p0 += 16) {
        FragAT a;
        FragB b;
        wmma::load_matrix_sync(a, h1_s + p0 * LD + tr * 16, LD);
        wmma::load_matrix_sync(b, dp_s + p0 * LD + tc * 16, LD);
        wmma::mma_sync(part, a, b, part);
      }
      float* dst = dw2_blk + static_cast<size_t>(tr * 16) * H + tc * 16;
      wmma::load_matrix_sync(acc, dst, H, wmma::mem_row_major);
#pragma unroll
      for (int e = 0; e < part.num_elements; ++e) part.x[e] += acc.x[e];
      wmma::store_matrix_sync(dst, part, H, wmma::mem_row_major);
    }
    for (int t = warp; t < (P / 16) * TC; t += WARPS) {
      const int tr = t / TC, tc = t % TC;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < H; k0 += 16) {
        FragA a;
        FragBT b;   // W2^T as a column-major operand: (n, k) at W2[k][n]
        wmma::load_matrix_sync(a, dp_s + tr * 16 * LD + k0, LD);
        wmma::load_matrix_sync(
            b, w2h + static_cast<size_t>(tc * 16) * H + k0, H);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(st_s + tr * 16 * LDF + tc * 16, acc, LDF,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // 6. column pass: dpre1 = [h1 > 0] dh1 into s_theta and the item's s_d
    for (int c = tid; c < H; c += THREADS) {
      float colsum = 0.f;
      for (int r = 0; r < P; ++r) {
        const int row = b0 + r;
        const float t1v =
            row < B ? t1[static_cast<size_t>(row) * H + c] : 0.f;
        const float dp1 = t1v + t2j[c] > 0.f ? st_s[r * LDF + c] : 0.f;
        if (row < B) sth[static_cast<size_t>(row) * H + c] += dp1;
        colsum += dp1;
      }
      parts.sd[(static_cast<size_t>(tile) * M + j) * H + c] = colsum;
    }
  }
  __syncthreads();

  for (int r = tid; r < P; r += THREADS)
    if (b0 + r < B) parts.ll[static_cast<size_t>(split) * B + b0 + r] = ll_s[r];
  for (int c = tid; c < H; c += THREADS) {
    parts.db2[static_cast<size_t>(blk) * H + c] = db2_s[c];
    parts.dwo[static_cast<size_t>(blk) * H + c] = dwo_s[c];
  }
  if (tid == 0) {
    float sdbo = 0.f;
    for (int r = 0; r < P; ++r) sdbo += dbo_s[r];
    parts.dbo[blk] = sdbo;
  }
}

// out = [ll (B) | s_theta (B, H) | s_d (M, H) | dW2 (H, H) | db2 (H) |
// dwo (H) | dbo (1)], each the sum of its partials in block order.
__global__ void deep_link_reduce_kernel(const float* __restrict__ scratch,
                                        float* __restrict__ out, int B, int M,
                                        int H, int tiles, int splits) {
  Parts parts(const_cast<float*>(scratch), B, M, H, tiles, splits);
  const size_t nblk = static_cast<size_t>(tiles) * splits;
  const size_t n_ll = B, n_sth = static_cast<size_t>(B) * H,
               n_sd = static_cast<size_t>(M) * H,
               n_w = static_cast<size_t>(H) * H;
  const size_t total = n_ll + n_sth + n_sd + n_w + 2 * H + 1;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    size_t x = i;
    float s = 0.f;
    if (x < n_ll) {
      for (int z = 0; z < splits; ++z) s += parts.ll[z * n_ll + x];
    } else if ((x -= n_ll) < n_sth) {
      for (int z = 0; z < splits; ++z) s += parts.sth[z * n_sth + x];
    } else if ((x -= n_sth) < n_sd) {
      for (int t = 0; t < tiles; ++t) s += parts.sd[t * n_sd + x];
    } else if ((x -= n_sd) < n_w) {
      for (size_t b = 0; b < nblk; ++b) s += parts.dw2[b * n_w + x];
    } else if ((x -= n_w) < static_cast<size_t>(H)) {
      for (size_t b = 0; b < nblk; ++b) s += parts.db2[b * H + x];
    } else if ((x -= H) < static_cast<size_t>(H)) {
      for (size_t b = 0; b < nblk; ++b) s += parts.dwo[b * H + x];
    } else {
      for (size_t b = 0; b < nblk; ++b) s += parts.dbo[b];
    }
    out[i] = s;
  }
}

// The item splits of a grid of `tiles` x splits blocks (or clusters) that
// fill `slots` resident ones best (the fewest among equals): every block
// does the same work. Every split gets at least one item.
int best_splits(long long tiles, long long slots, int M) {
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= std::min(MAX_SPLITS, std::max(M, 1)); ++s) {
    const long long blocks = tiles * s;
    const double fill = static_cast<double>(blocks) /
                        (((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  const int per = (std::max(M, 1) + best - 1) / best;
  return (std::max(M, 1) + per - 1) / per;
}

// The item splits of a grid of `kernel` (P students a block, `smem` bytes
// of dynamic shared memory): best_splits over its resident blocks.
template <class Kern>
int fill_splits(Kern kernel, size_t smem, int P, int B, int M, int* splits) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = std::max(1, (B + P - 1) / P);
  *splits = best_splits(tiles, static_cast<long long>(sms) * occ, M);
  return 0;
}

template <int H>
int plan(int B, int M, int* splits, long long* scratch_floats) {
  using C = Cfg<H>;
  const int rc = fill_splits(deep_link_kernel<H>, C::SMEM, C::P, B, M, splits);
  if (rc != 0) return rc;
  const long long tiles = std::max(1, (B + C::P - 1) / C::P);
  *scratch_floats = Parts::floats(B, M, H, tiles, *splits);
  return 0;
}

// The launch of deep_link_cluster_kernel<H>: clusters of C CTAs along x.
// The configuration points into this object: use it in place.
template <int H>
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(dim3 grid, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Clu<H>::C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Clu<H>::SMEM;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The kernel's shared memory and, for a cluster of 16, the non-portable
// cluster size.
template <int H>
cudaError_t cluster_attributes() {
  const void* fn = reinterpret_cast<const void*>(deep_link_cluster_kernel<H>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Clu<H>::SMEM));
  if (err == cudaSuccess && Clu<H>::C > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The clusters of deep_link_cluster_kernel<H> the device holds at once.
template <int H>
int resident_clusters(int* clusters) {
  cudaError_t err = cluster_attributes<H>();
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch<H> launch(dim3(Clu<H>::C), nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, deep_link_cluster_kernel<H>,
                                       &launch.cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *clusters < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <int H>
int plan_cluster(int B, int M, int* splits, long long* scratch_floats) {
  int clusters = 0;
  const int rc = resident_clusters<H>(&clusters);
  if (rc != 0) return rc;
  const long long tiles = std::max(1, (B + Clu<H>::P - 1) / Clu<H>::P);
  *splits = best_splits(tiles, clusters, M);
  *scratch_floats = Parts::floats(B, M, H, tiles, *splits);
  return 0;
}

// The wide variant: its partials, then the bf16 copy of W2.
template <int P>
int plan_wide(int B, int M, int H, int* splits, long long* scratch_floats) {
  const int rc = fill_splits(deep_link_wide_kernel<P>,
                             WideLayout(P, H).bytes, P, B, M, splits);
  if (rc != 0) return rc;
  const long long tiles = std::max(1, (B + P - 1) / P);
  *scratch_floats =
      wide_w2_offset(Parts::floats(B, M, H, tiles, *splits)) +
      (static_cast<long long>(H) * H + 1) / 2;
  return 0;
}

// The ordered sums of the partials into out (deep_link_reduce_kernel).
cudaError_t reduce(const float* scratch, float* out, int B, int M, int H,
                   int tiles, int splits, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * (H + 1) +
                       static_cast<size_t>(M) * H +
                       static_cast<size_t>(H) * (H + 2) + 1;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  deep_link_reduce_kernel<<<blocks, 256, 0, stream>>>(scratch, out, B, M, H,
                                                      tiles, splits);
  return cudaGetLastError();
}

template <int P>
int launch_wide(const void* t1, const void* t2, const void* w2,
                const void* b2, const void* wo, const void* bo,
                const void* pk, void* out, void* scratch, int B, int M, int H,
                int splits, cudaStream_t stream) {
  const int tiles = std::max(1, (B + P - 1) / P);
  const int per = (std::max(M, 1) + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= std::max(M, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = WideLayout(P, H).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      deep_link_wide_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* sc = static_cast<float*>(scratch);
  __nv_bfloat16* w2h = reinterpret_cast<__nv_bfloat16*>(
      sc + wide_w2_offset(Parts::floats(B, M, H, tiles, splits)));
  const size_t hh = static_cast<size_t>(H) * H;
  round_bf16_kernel<<<static_cast<int>(std::min<size_t>((hh + 255) / 256,
                                                        1024)),
                      256, 0, stream>>>(static_cast<const float*>(w2), w2h,
                                        hh);
  deep_link_wide_kernel<P><<<dim3(tiles, splits), THREADS, smem, stream>>>(
      static_cast<const float*>(t1), static_cast<const float*>(t2), w2h,
      static_cast<const float*>(b2), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<const int8_t*>(pk), sc, B, M,
      H, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      reduce(sc, static_cast<float*>(out), B, M, H, tiles, splits, stream));
}

template <int H>
int launch(const void* t1, const void* t2, const void* w2, const void* b2,
           const void* wo, const void* bo, const void* pk, void* out,
           void* scratch, int B, int M, int splits, cudaStream_t stream) {
  using C = Cfg<H>;
  const int tiles = std::max(1, (B + C::P - 1) / C::P);
  const int per = (std::max(M, 1) + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= std::max(M, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      deep_link_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  deep_link_kernel<H><<<dim3(tiles, splits), THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(t1), static_cast<const float*>(t2),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<const int8_t*>(pk), static_cast<float*>(scratch), B, M, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(static_cast<const float*>(scratch),
                                 static_cast<float*>(out), B, M, H, tiles,
                                 splits, stream));
}

template <int H>
int launch_cluster(const void* t1, const void* t2, const void* w2,
                   const void* b2, const void* wo, const void* bo,
                   const void* pk, void* out, void* scratch, int B, int M,
                   int splits, cudaStream_t stream) {
  using K = Clu<H>;
  const int tiles = std::max(1, (B + K::P - 1) / K::P);
  const int per = (std::max(M, 1) + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= std::max(M, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cluster_attributes<H>();
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch<H> launch(dim3(K::C * tiles, splits), stream);
  err = cudaLaunchKernelEx(
      &launch.cfg, deep_link_cluster_kernel<H>, static_cast<const float*>(t1),
      static_cast<const float*>(t2), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<const int8_t*>(pk),
      static_cast<float*>(scratch), B, M, per);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(static_cast<const float*>(scratch),
                                 static_cast<float*>(out), B, M, H, tiles,
                                 splits, stream));
}

template <int H>
int occupancy(int* out) {
  const void* fn = reinterpret_cast<const void*>(deep_link_kernel<H>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Cfg<H>::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      Cfg<H>::SMEM);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(err);
}

// deep_link_cluster_kernel<H>: out[0..5) as deep_link_occupancy's.
template <int H>
int occupancy_cluster(int* out) {
  const void* fn = reinterpret_cast<const void*>(deep_link_cluster_kernel<H>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0, blocks = 0;
  const int rc = resident_clusters<H>(&clusters);
  if (rc != 0) return rc;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      Clu<H>::SMEM);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = Clu<H>::C;
  out[4] = clusters;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The item splits of the grid for (B, M, H) on the current device, and the
// scratch deep_link_train needs (floats). H is 128 (one block a student
// tile), 256, 384, 512 (a cluster a student tile) or any other multiple of
// 16 up to what the wide variant's shared memory takes (1,600).
int deep_link_plan(int B, int M, int H, int* splits,
                   long long* scratch_floats) {
  if (B < 0 || M < 0 || H < 16 || H % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 128) return plan<128>(B, M, splits, scratch_floats);
  if (H == 256) return plan_cluster<256>(B, M, splits, scratch_floats);
  if (H == 384) return plan_cluster<384>(B, M, splits, scratch_floats);
  if (H == 512) return plan_cluster<512>(B, M, splits, scratch_floats);
  switch (wide_rows(H)) {
    case 32: return plan_wide<32>(B, M, H, splits, scratch_floats);
    case 16: return plan_wide<16>(B, M, H, splits, scratch_floats);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// t1 (B, H), t2 (M, H), w2 (H, H), b2 (H), wo (H), bo (1): f32 contiguous;
// pk (B, M) int8 contiguous; out (B + B*H + M*H + H*H + 2H + 1) f32 (the
// layout of deep_link_reduce_kernel); scratch of the size deep_link_plan
// gives for `splits`.
int deep_link_train(const void* t1, const void* t2, const void* w2,
                    const void* b2, const void* wo, const void* bo,
                    const void* pk, void* out, void* scratch, int B, int M,
                    int H, int splits, void* stream) {
  if (B < 0 || M < 0 || H < 16 || H % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 128)
    return launch<128>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M, splits, s);
  if (H == 256)
    return launch_cluster<256>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M,
                               splits, s);
  if (H == 384)
    return launch_cluster<384>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M,
                               splits, s);
  if (H == 512)
    return launch_cluster<512>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M,
                               splits, s);
  switch (wide_rows(H)) {
    case 32:
      return launch_wide<32>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M,
                             H, splits, s);
    case 16:
      return launch_wide<16>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M,
                             H, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel of link width H (128: deep_link_kernel<128>; 256, 384, 512:
// deep_link_cluster_kernel<H>) into out[0..5): ptxas's registers a thread,
// its local (spill) bytes, its resident blocks an SM, its cluster size (1
// for a kernel without clusters) and the clusters the device holds at once
// (for H = 128 its resident blocks).
int deep_link_occupancy(int H, int* out) {
  if (H == 128) {
    const int rc = occupancy<128>(out);
    if (rc != 0) return rc;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    out[3] = 1;
    out[4] = out[2] * sms;
    return static_cast<int>(err);
  }
  if (H == 256) return occupancy_cluster<256>(out);
  if (H == 384) return occupancy_cluster<384>(out);
  if (H == 512) return occupancy_cluster<512>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
