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
// The simple design: a block of 512 threads owns P students (64 at H = 128,
// 32 at H = 256) and walks a contiguous run of items one at a time (grid y
// splits the items so that the blocks fill the SMs); an item's P pairs are
// the M side of the three products. W2 is staged once per block in shared
// memory as bf16. Per item: build bf16(h1) (P x H) in shared memory; the
// forward product h1 W2 (nvcuda::wmma, 16x16x16 bf16 -> f32) goes to an f32
// staging tile; a row pass (TPR threads a pair) reduces the logit and takes
// ll and dlogit; a column pass (a thread owns one of the H columns for 16
// pairs) forms dpre2 as bf16 and sums db2 and dwo in registers; then
// dW2 += h1^T dpre2 and dh1 = dpre2 W2^T, whose column pass applies the f32
// h1 mask and sums s_theta (registers, the block owns its students) and the
// item's s_d over the block's pairs. The tensor cores do not round their f32
// accumulation to nearest, so each item's dW2 product starts from a zero
// fragment and is added to the running sum with f32 adds. At H = 128 the dW2
// sums stay in registers over the whole loop (4 fragments a warp); at H =
// 256 they do not fit, and each warp adds its tiles into the block's own
// partial in device memory (a slice no other block touches). Every sum
// across blocks (ll and s_theta over the item splits, s_d over the student
// tiles, the weight gradients over all blocks) is a per-block partial that a
// second kernel adds in block order: no atomics, deterministic. Plain WMMA
// from shared memory, one item at a time: wgmma, TMA and software pipelining
// are later work.

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

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int H>
struct Cfg {
  static constexpr int P = H == 128 ? 64 : 32;   // students a block, pairs an item
  static constexpr int LD = H + 8;               // bf16 row stride (ldm % 8 == 0)
  static constexpr int TPR = THREADS / P;        // row pass: threads a pair
  static constexpr int LDF = H + TPR;            // f32 row stride: row pass conflict-free
  static constexpr int RPT = P * H / THREADS;    // column pass: pairs a thread
  static constexpr int GROUPS = THREADS / H;     // column pass: row groups
  static constexpr int TR = P / 16;              // tile rows of a (P x H) product
  static constexpr int WPR = WARPS / TR;         // warps a tile row
  static constexpr int TCW = H / 16 / WPR;       // tile columns a warp
  static constexpr bool DW2_REGS = H == 128;     // dW2 in registers over the loop
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

  FragC dw2_acc[C::DW2_REGS ? C::DW2_TILES : 1];
  if constexpr (C::DW2_REGS) {
#pragma unroll
    for (int t = 0; t < C::DW2_TILES; ++t) wmma::fill_fragment(dw2_acc[t], 0.f);
  }

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
    // tile order
    if constexpr (C::DW2_REGS) {
#pragma unroll
      for (int t = 0; t < C::DW2_TILES; ++t) {
        const int tr = (warp * C::DW2_TILES + t) / C::TCOLS,
                  tc = (warp * C::DW2_TILES + t) % C::TCOLS;
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
#pragma unroll
        for (int e = 0; e < part.num_elements; ++e) dw2_acc[t].x[e] += part.x[e];
      }
    } else {
      // at H = 256 the tiles are added into the block's own partial
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
  if constexpr (C::DW2_REGS) {
#pragma unroll
    for (int t = 0; t < C::DW2_TILES; ++t) {
      const int tr = (warp * C::DW2_TILES + t) / C::TCOLS,
                tc = (warp * C::DW2_TILES + t) % C::TCOLS;
      wmma::store_matrix_sync(dw2_blk + static_cast<size_t>(tr * 16) * H + tc * 16,
                              dw2_acc[t], H, wmma::mem_row_major);
    }
  } else if (j0 >= j1) {
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

template <int H>
int plan(int B, int M, int* splits, long long* scratch_floats) {
  using C = Cfg<H>;
  cudaError_t err = cudaFuncSetAttribute(
      deep_link_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, deep_link_kernel<H>, THREADS, C::SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the item splits whose blocks fill the resident slots best (the fewest
  // among equals): every block does the same work
  const long long tiles = std::max(1, (B + C::P - 1) / C::P);
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
  // every split gets at least one item
  const int per = (std::max(M, 1) + best - 1) / best;
  *splits = (std::max(M, 1) + per - 1) / per;
  *scratch_floats = Parts::floats(B, M, H, tiles, *splits);
  return 0;
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
  const size_t total = static_cast<size_t>(B) * (H + 1) +
                       static_cast<size_t>(M) * H +
                       static_cast<size_t>(H) * (H + 2) + 1;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  deep_link_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), B, M, H,
      tiles, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The item splits of the grid for (B, M, H) on the current device, and the
// scratch deep_link_train needs (floats). H is 128 or 256.
int deep_link_plan(int B, int M, int H, int* splits,
                   long long* scratch_floats) {
  if (B < 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H == 128) return plan<128>(B, M, splits, scratch_floats);
  if (H == 256) return plan<256>(B, M, splits, scratch_floats);
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
  if (B < 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 128)
    return launch<128>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M, splits, s);
  if (H == 256)
    return launch<256>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
