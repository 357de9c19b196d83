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
// leave the SM. The relu masks use the f32 pre-activations; the products'
// operands are rounded to bf16 (round to nearest even) and accumulate in f32,
// the rounding points of the Pallas kernel.
//
// What bounds it on an H100: three products of 2 H^2 operations a pair on
// the bf16 tensor cores (6 H^2 a pair: 3.7e11 at 5,520 x 680 and H = 128,
// ~0.37 ms at 989 TFLOP/s), against about 17 H f32 operations a pair of
// elementwise work outside them (~0.12 ms at 67 TFLOP/s), three
// special-function results a pair (exp, log1p, the reciprocal of 1 + e) and
// ~10 MB of traffic (a few microseconds): the tensor-core operations.
//
// Common to both fixed widths: a block of 512 threads owns P students (64
// at H = 128, 32 at H = 256) and walks a contiguous run of items one at a
// time (grid y splits the items so that the blocks fill the SMs); an item's
// P pairs are the M side of the three products. W2 is staged once per block
// in shared memory as bf16. The tensor cores do not round their f32
// accumulation to nearest, so each item's dW2 product starts from a zero
// accumulator and is added to the running sum with f32 adds; the forward
// product and dh1 are each one chain over k, 16 at a time. Every sum across
// blocks (ll and s_theta over the item splits, s_d over the student tiles,
// the weight gradients over all blocks) is a per-block partial that a second
// kernel adds in block order: no atomics, deterministic.
//
// H = 128 (paper config 5), deep_link_kernel<128>: inline-PTX mma.sync
// m16n8k16 (bf16 in, f32 accumulate; the instruction nvcuda::wmma's 16x16x16
// step compiles to, twice) from ldmatrix, .trans where an operand is read
// transposed (W2 for pre2, h1^T and dpre2 for dW2). Warp w owns 16 pairs x
// 32 columns of each (P x H) product, so pre2 and dh1 stay in the
// accumulators: a lane sums relu(pre2 + b2) wo over its 8 columns, its quad
// over 32, and the row tile's four column groups through a 64 x 4 array in
// a fixed order; dlogit, dpre2 (bf16 to shared), db2 and dwo are formed in
// registers; dh1 is masked by the f32 pre-activations of the lane's own h1
// (a bit mask kept from building it), s_theta accumulates in shared memory
// at the lane's own positions and s_d is reduced over the warp's rows with
// shuffles. h1 and dpre2 are double-buffered by item parity: an item has one
// block-wide barrier (dpre2 ready) and two of its row tile's 128 threads (h1
// ready, logit partials), against six block-wide ones and two f32 staging
// passes in the WMMA design it replaced. dW2's running sum stays in
// registers (32 a lane). 126 registers a thread, no spill, one block an SM.
// What holds it back (estimates from the code, not measured): shared-memory
// traffic of ~0.6 MB an item for a block, each warp loading its own A and B
// fragments through ldmatrix (a W2 tile is read by the four row tiles, an h1
// or dpre2 row tile by the four column groups), against ~0.8 us of tensor
// work an item at one SM's share of the peak; and one block of 16 warps an
// SM, whose phases wait at the barriers with nothing else to run. wgmma
// (B read once per warpgroup from shared memory) on this register layout is
// the next step.
//
// H = 256, deep_link_kernel<256>: plain WMMA from shared memory. Per item:
// build bf16(h1) (P x H) in shared memory; the forward product h1 W2
// (nvcuda::wmma, 16x16x16 bf16 -> f32) goes to an f32 staging tile; a row
// pass (TPR threads a pair) reduces the logit and takes ll and dlogit; a
// column pass (a thread owns one of the H columns for 16 pairs) forms dpre2
// as bf16 and sums db2 and dwo in registers; then dW2 += h1^T dpre2 and
// dh1 = dpre2 W2^T, whose column pass applies the f32 h1 mask and sums
// s_theta (registers, the block owns its students) and the item's s_d over
// the block's pairs. The dW2 sums do not fit in registers, and each warp
// adds its tiles into the block's own partial in device memory (a slice no
// other block touches).
//
// Every other width (H % 16 == 0; the op admits H % 128 == 0, as JAX's
// does) takes the wide variant, deep_link_wide_kernel: at H = 384, W2 alone
// (384 x 392 bf16, 301 KB) outgrows a block's 227 KB of shared memory. A
// prologue kernel rounds W2 to bf16 once a call into the scratch, where it
// stays L2-resident (0.3 MB at H = 384, 0.5 MB at 512), and both products
// that read W2 load their B fragments straight from there. H is a run-time
// value: a block of 512 threads owns P = 32 students (16 where 32 do not fit
// the shared memory, H > 832), the products' tiles go round-robin over the
// warps, the row pass takes a warp a pair and the column passes a thread a
// column (db2, dwo in shared memory); s_theta and dW2 are added into the
// block's own partials in device memory every item. The rounding points and
// the per-item fresh dW2 fragment are those of the fixed widths. Its time is
// that of a repair (PERF.md), not a design for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

using namespace nvcuda;

namespace {

constexpr int THREADS = 512;     // 16 warps (faster than 8 on an H100)
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;        // items whose codes are staged at once
constexpr int MAX_SPLITS = 8;    // item splits of the grid, at most

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

template <int H>
struct Cfg {
  static constexpr int P = 32;                   // students a block, pairs an item
  static constexpr int LD = H + 8;               // bf16 row stride (ldm % 8 == 0)
  static constexpr int TPR = THREADS / P;        // row pass: threads a pair
  static constexpr int LDF = H + TPR;            // f32 row stride: row pass conflict-free
  static constexpr int RPT = P * H / THREADS;    // column pass: pairs a thread
  static constexpr int GROUPS = THREADS / H;     // column pass: row groups
  static constexpr int TR = P / 16;              // tile rows of a (P x H) product
  static constexpr int WPR = WARPS / TR;         // warps a tile row
  static constexpr int TCW = H / 16 / WPR;       // tile columns a warp
  static constexpr int TCOLS = H / 16;           // tile columns of dW2
  static constexpr int DW2_TILES = TCOLS * TCOLS / WARPS;   // a warp
  // dynamic shared memory, each region 128-byte aligned
  static constexpr size_t W2_OFF = 0;
  static constexpr size_t H1_OFF = W2_OFF + align128(sizeof(__nv_bfloat16) * H * LD);
  static constexpr size_t DP_OFF = H1_OFF + align128(sizeof(__nv_bfloat16) * P * LD);
  static constexpr size_t ST_OFF = DP_OFF + align128(sizeof(__nv_bfloat16) * P * LD);
  static constexpr size_t B2_OFF = ST_OFF + align128(sizeof(float) * P * LDF);
  static constexpr size_t WO_OFF = B2_OFF + align128(sizeof(float) * H);
  static constexpr size_t DL_OFF = WO_OFF + align128(sizeof(float) * H);
  static constexpr size_t RED_OFF = DL_OFF + align128(sizeof(float) * P);
  static constexpr size_t DBO_OFF =
      RED_OFF + align128(sizeof(float) * 2 * H * (GROUPS > 1 ? GROUPS - 1 : 1));
  static constexpr size_t CODE_OFF = DBO_OFF + align128(sizeof(float) * WARPS);
  static constexpr size_t SMEM = CODE_OFF + align128(P * CHUNK);
  static_assert(RPT * GROUPS == P && GROUPS * H == THREADS, "column pass");
  static_assert(TPR * P == THREADS && WPR * TR == WARPS, "row pass, tiles");
  static_assert(DW2_TILES * WARPS == TCOLS * TCOLS, "dW2 tiles");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

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

template <int H>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ wo, const float* __restrict__ bo,
                 const int8_t* __restrict__ pk, float* __restrict__ scratch,
                 int B, int M, int items_per_split) {
  using C = Cfg<H>;
  constexpr int P = C::P, LD = C::LD, LDF = C::LDF, RPT = C::RPT,
                TPR = C::TPR, TCW = C::TCW;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2_s = reinterpret_cast<__nv_bfloat16*>(smem + C::W2_OFF);
  __nv_bfloat16* h1_s = reinterpret_cast<__nv_bfloat16*>(smem + C::H1_OFF);
  __nv_bfloat16* dp_s = reinterpret_cast<__nv_bfloat16*>(smem + C::DP_OFF);
  float* st_s = reinterpret_cast<float*>(smem + C::ST_OFF);
  float* b2_s = reinterpret_cast<float*>(smem + C::B2_OFF);
  float* wo_s = reinterpret_cast<float*>(smem + C::WO_OFF);
  float* dl_s = reinterpret_cast<float*>(smem + C::DL_OFF);
  float* red_s = reinterpret_cast<float*>(smem + C::RED_OFF);
  float* dbo_s = reinterpret_cast<float*>(smem + C::DBO_OFF);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem + C::CODE_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x, splits = gridDim.y;
  const int blk = tile * splits + split;
  const int b0 = tile * P;
  const int j0 = split * items_per_split;
  const int j1 = min(M, j0 + items_per_split);
  Parts parts(scratch, B, M, H, tiles, splits);
  float* dw2_blk = parts.dw2 + static_cast<size_t>(blk) * H * H;

  for (int i = tid; i < H * H; i += THREADS)
    w2_s[(i / H) * LD + i % H] = __float2bfloat16(w2[i]);
  for (int i = tid; i < H; i += THREADS) {
    b2_s[i] = b2[i];
    wo_s[i] = wo[i];
  }
  const float bov = bo[0];

  // column passes: this thread owns column `col` of pairs r0 .. r0 + RPT
  const int col = tid % H, grp = tid / H, r0 = grp * RPT;
  float t1r[RPT], sth[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = b0 + r0 + k;
    t1r[k] = row < B ? t1[static_cast<size_t>(row) * H + col] : 0.f;
    sth[k] = 0.f;
  }
  const float b2c = b2[col], woc = wo[col];
  float dwo_acc = 0.f, db2_acc = 0.f;
  // row pass: this thread takes columns q, q + TPR, ... of pair `prow`
  const int prow = tid / TPR, q = tid % TPR;
  float ll_acc = 0.f, dbo_acc = 0.f;
  // the warp's tiles of a (P x H) product: rows wr0.., columns wc0..
  const int wr0 = (warp / C::WPR) * 16, wc0 = (warp % C::WPR) * TCW * 16;

  float t2_next = j0 < j1 ? t2[static_cast<size_t>(j0) * H + col] : 0.f;
  for (int j = j0; j < j1; ++j) {
    const int jj = (j - j0) % CHUNK;
    if (jj == 0) {
      for (int i = tid; i < P * CHUNK; i += THREADS) {
        const int row = b0 + i / CHUNK, item = j + i % CHUNK;
        code_s[i] = (row < B && item < j1)
                        ? pk[static_cast<size_t>(row) * M + item] : int8_t(0);
      }
    }
    const float t2c = t2_next;
    if (j + 1 < j1) t2_next = t2[static_cast<size_t>(j + 1) * H + col];

    // 1. bf16(h1) of the item's P pairs
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      h1_s[(r0 + k) * LD + col] = __float2bfloat16(fmaxf(t1r[k] + t2c, 0.f));
    __syncthreads();

    // 2. h1 W2 -> staging (b2 is added by the passes that read it)
    {
      FragC acc[TCW];
#pragma unroll
      for (int t = 0; t < TCW; ++t) wmma::fill_fragment(acc[t], 0.f);
#pragma unroll 2
      for (int k0 = 0; k0 < H; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, h1_s + wr0 * LD + k0, LD);
#pragma unroll
        for (int t = 0; t < TCW; ++t) {
          FragB b;
          wmma::load_matrix_sync(b, w2_s + k0 * LD + wc0 + 16 * t, LD);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < TCW; ++t)
        wmma::store_matrix_sync(st_s + wr0 * LDF + wc0 + 16 * t, acc[t], LDF,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // 3. row pass: logit, ll and dlogit of pair `prow`
    {
      const float* row = st_s + prow * LDF;
      float acc = 0.f;
#pragma unroll 8
      for (int c = q; c < H; c += TPR)
        acc = fmaf(fmaxf(row[c] + b2_s[c], 0.f), wo_s[c], acc);
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (q == 0) {
        const float logit = acc + bov;
        const float cf = static_cast<float>(code_s[prow * CHUNK + jj]);
        const float m = fminf(cf, 1.f), r = fmaxf(cf - 1.f, 0.f);
        const float e = expf(-fabsf(logit));
        const float sp = log1pf(e) + fmaxf(logit, 0.f);   // softplus(logit)
        ll_acc += -m * (r > 0.5f ? sp - logit : sp);
        const float inv = 1.f / (1.f + e);
        const float s = logit >= 0.f ? inv : 1.f - inv;   // sigmoid(logit)
        const float dl = m * (r - s);
        dbo_acc += dl;
        dl_s[prow] = dl;
      }
    }
    __syncthreads();

    // 4. column pass: dpre2 (bf16 to shared), db2 and dwo
#pragma unroll 8
    for (int k = 0; k < RPT; ++k) {
      const int r = r0 + k;
      const float pre2 = st_s[r * LDF + col] + b2c;
      const float dl = dl_s[r];
      dwo_acc = fmaf(fmaxf(pre2, 0.f), dl, dwo_acc);
      const float dp = pre2 > 0.f ? dl * woc : 0.f;
      db2_acc += dp;
      dp_s[r * LD + col] = __float2bfloat16(dp);
    }
    __syncthreads();

    // 5. dW2 += h1^T dpre2, and dh1 = dpre2 W2^T -> staging. The item's
    // product goes to a fresh fragment (a chain of P/16 tensor-core steps)
    // and is added to the running sum with f32 adds: the tensor cores do
    // not round their f32 accumulation to nearest, so a chain over the
    // block's whole item run would drift (measured 3e-4 to 9e-4 of dW2's
    // largest element against the plain version).
    // warp w owns dW2's tiles w * DW2_TILES .. + DW2_TILES in row-major
    // tile order, added into the block's own partial
    for (int i = 0; i < C::DW2_TILES; ++i) {
      const int tr = (warp * C::DW2_TILES + i) / C::TCOLS,
                tc = (warp * C::DW2_TILES + i) % C::TCOLS;
      float* dst = dw2_blk + static_cast<size_t>(tr * 16) * H + tc * 16;
      FragC part;
      wmma::fill_fragment(part, 0.f);
#pragma unroll
      for (int p0 = 0; p0 < P; p0 += 16) {
        FragAT a;
        FragB b;
        wmma::load_matrix_sync(a, h1_s + p0 * LD + tr * 16, LD);
        wmma::load_matrix_sync(b, dp_s + p0 * LD + tc * 16, LD);
        wmma::mma_sync(part, a, b, part);
      }
      if (j > j0) {
        FragC acc;
        wmma::load_matrix_sync(acc, dst, H, wmma::mem_row_major);
#pragma unroll
        for (int e = 0; e < part.num_elements; ++e) part.x[e] += acc.x[e];
      }
      wmma::store_matrix_sync(dst, part, H, wmma::mem_row_major);
    }
    {
      FragC acc[TCW];
#pragma unroll
      for (int t = 0; t < TCW; ++t) wmma::fill_fragment(acc[t], 0.f);
#pragma unroll 2
      for (int k0 = 0; k0 < H; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, dp_s + wr0 * LD + k0, LD);
#pragma unroll
        for (int t = 0; t < TCW; ++t) {
          // W2^T as a column-major operand: element (n, k) at w2_s[k][n]
          FragBT b;
          wmma::load_matrix_sync(b, w2_s + (wc0 + 16 * t) * LD + k0, LD);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < TCW; ++t)
        wmma::store_matrix_sync(st_s + wr0 * LDF + wc0 + 16 * t, acc[t], LDF,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // 6. column pass: dpre1 = [h1 > 0] dh1 into s_theta and the item's s_d
    float colsum = 0.f;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const float dp1 = t1r[k] + t2c > 0.f ? st_s[(r0 + k) * LDF + col] : 0.f;
      sth[k] += dp1;
      colsum += dp1;
    }
    float* sd_row = parts.sd + (static_cast<size_t>(tile) * M + j) * H;
    if constexpr (C::GROUPS == 1) {
      sd_row[col] = colsum;
    } else {
      if (grp > 0) red_s[(grp - 1) * H + col] = colsum;
      __syncthreads();
      if (grp == 0) {
#pragma unroll
        for (int g = 1; g < C::GROUPS; ++g) colsum += red_s[(g - 1) * H + col];
        sd_row[col] = colsum;
      }
    }
  }

  // this split's ll and s_theta of the block's students
  if (q == 0 && b0 + prow < B)
    parts.ll[static_cast<size_t>(split) * B + b0 + prow] = ll_acc;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = b0 + r0 + k;
    if (row < B)
      parts.sth[(static_cast<size_t>(split) * B + row) * H + col] = sth[k];
  }
  if (j0 >= j1) {
    for (int i = tid; i < H * H; i += THREADS) dw2_blk[i] = 0.f;
  }
  // db2, dwo over the row groups; dbo over the block's pairs
  __syncthreads();
  if (grp > 0) {
    red_s[(grp - 1) * 2 * H + col] = db2_acc;
    red_s[(grp - 1) * 2 * H + H + col] = dwo_acc;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    dbo_acc += __shfl_xor_sync(0xffffffffu, dbo_acc, o);
  if (lane == 0) dbo_s[warp] = dbo_acc;
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int g = 1; g < C::GROUPS; ++g) {
      db2_acc += red_s[(g - 1) * 2 * H + col];
      dwo_acc += red_s[(g - 1) * 2 * H + H + col];
    }
    parts.db2[static_cast<size_t>(blk) * H + col] = db2_acc;
    parts.dwo[static_cast<size_t>(blk) * H + col] = dwo_acc;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += dbo_s[w];
    parts.dbo[blk] = s;
  }
}

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

// ---- the wide variant (any H % 16 == 0 other than 128 and 256) ----------

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

// The item splits of a grid of `kernel` (P students a block, `smem` bytes
// of dynamic shared memory) whose blocks fill the resident slots best (the
// fewest among equals): every block does the same work. Every split gets
// at least one item.
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
  const long long slots = static_cast<long long>(sms) * occ;
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
  *splits = (std::max(M, 1) + per - 1) / per;
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

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The item splits of the grid for (B, M, H) on the current device, and the
// scratch deep_link_train needs (floats). H is 128, 256 (their own
// instantiations) or any other multiple of 16 up to what the wide
// variant's shared memory takes (1,600).
int deep_link_plan(int B, int M, int H, int* splits,
                   long long* scratch_floats) {
  if (B < 0 || M < 0 || H < 16 || H % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 128) return plan<128>(B, M, splits, scratch_floats);
  if (H == 256) return plan<256>(B, M, splits, scratch_floats);
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
    return launch<256>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M, splits, s);
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

// deep_link_kernel<H> (H = 128 or 256): ptxas's registers a thread, its
// local (spill) bytes and its resident blocks an SM, into out[0..3).
int deep_link_occupancy(int H, int* out) {
  if (H == 128) return occupancy<128>(out);
  if (H == 256) return occupancy<256>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
