// One-pass training log-likelihood of the deep nonlinear link on the int8
// response code, with every gradient, in true f32 (the deep HMC
// potential's mode), on the CUDA cores.
//
// Replaces the TPU Pallas kernel of vibo_tpu/ops/pallas_deep.py in its
// f32 mode:
//   deep_link_f32_train  <- _fused_deep_fwd(..., f32_dots=True) (:154),
//                           body _fused_deep_kernel (:75), dot_dtype f32
// Per (student i, item j) pair, with t1 = theta W_theta + b1 (B, H) and
// t2 = d W_item (M, H) computed outside (f32), the code c (0 = missing,
// 1 = wrong, 2 = right), m = min(c, 1), r = max(c - 1, 0):
//   h1 = relu(t1_i + t2_j)             pre2 = h1 W2 + b2
//   h2 = relu(pre2)                    logit = h2 . wo + bo
//   ll = m (r logit - softplus(logit)) dlogit = m (r - sigmoid(logit))
//   dpre2 = [pre2 > 0] dlogit wo       dh1 = dpre2 W2^T
//   dpre1 = [h1 > 0] dh1
// and the sums ll (B,), s_theta = sum_j dpre1 (B, H), s_d = sum_i dpre1
// (M, H), dW2 = sum h1^T dpre2 (H, H), db2 = sum dpre2, dwo = sum h2
// dlogit, dbo = sum dlogit. Every product takes f32 operands and sums in
// f32 (fmaf chains), as the Pallas kernel's dots at HIGHEST precision do:
// csrc/deep_link.cu rounds the operands to bf16, which the Metropolis test
// of HMC cannot take (a dH noise floor of units at the gold shapes).
//
// What bounds it on an H100: three products of 2 H^2 operations a pair,
// 6 H^2 f32 operations a pair at 67 TFLOP/s (0.59 ms at 2,000 x 200 and
// H = 128), against ~17 H of elementwise work a pair and a few MB of
// traffic: the f32 operations.
//
// Design: a block of 256 threads (8 warps) owns P = 32 students and walks a
// contiguous run of items (grid y splits the items so that the blocks fill
// the SMs, as csrc/deep_link.cu does). Warp w owns rows 4w..4w+3 of each
// (P x H) product and a lane the columns l + 32 q of every 128-column
// group, a 4 x 4 register tile a group: the forward's logit and the
// dlogit of a row stay in its warp (shuffles), with no block barrier. Per
// item: h1 is built transposed (h1T, H x P, rows of P + 4 floats, so a
// warp's four rows are one float4); pre2 goes to a staging tile (P x H),
// where each thread turns its own elements into dpre2 (also written
// transposed, dpT); then dW2 += h1^T dpre2 (a thread owns an 8 x 8 tile of
// each 128 x 128 block of dW2, rows a + 16 u, columns b + 16 v) and dh1 =
// dpre2 W2^T, masked by h1 > 0 into s_theta and, summed over the warp's
// rows, into the item's s_d (the warps' sums added in warp order). Three
// block barriers an item.
//
// At H = 128 (paper config 5, the deep gold), RESIDENT: W2 is staged in
// shared memory (rows of H + 1 floats: the forward reads a row across the
// lanes, dh1 a column, both free of bank conflicts), and the block's dW2
// (64 floats a thread) and s_theta (16) stay in registers for the whole
// run. Wider links read W2 and a transposed copy (a prologue kernel writes
// it into the scratch) from L2, and add dW2 and s_theta into the block's
// own partials in device memory every item; their per-item buffers stay in
// shared memory up to H = 384 and move to the block's own slice of the
// scratch beyond (correct at every H % 128 == 0, built for it, not for
// speed). Every sum across blocks (ll and s_theta over the item splits, s_d
// over the student tiles, the weight gradients over all blocks) is a
// per-block partial that a second kernel adds in block order: no atomics,
// deterministic. A simple kernel on the CUDA cores; tensor cores (3 x bf16
// or 3 x TF32 splits) are a later design.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int P = 32;              // students a block
constexpr int ROWS = P / WARPS;    // rows of a warp (4)
constexpr int GROUP = 128;         // columns a lane group covers (32 x 4)
constexpr int LDP = P + 4;         // h1T / dpT row stride (float4 rows)
constexpr int CHUNK = 16;          // items whose codes are staged at once
constexpr int MAX_SPLITS = 8;      // item splits of the grid, at most
constexpr size_t SMEM_MAX = 232448;

static_assert(ROWS == 4 && WARPS * ROWS == P, "a warp's rows are a float4");

// The per-item buffers of a block, in floats from its base: h1T (H x LDP),
// dpT (H x LDP), st (P x H: pre2, then dpre2), red (WARPS x H: each warp's
// s_d sum), db2w and dwow (WARPS x H: each warp's running db2 and dwo).
struct Buf {
  long long h1t, dpt, st, red, db2w, dwow, floats;
  __host__ __device__ explicit Buf(long long H) {
    h1t = 0;
    dpt = h1t + H * LDP;
    st = dpt + H * LDP;
    red = st + static_cast<long long>(P) * H;
    db2w = red + WARPS * H;
    dwow = db2w + WARPS * H;
    floats = dwow + WARPS * H;
  }
};

// Dynamic shared memory: [W2 (H x (H + 1)), resident only] [b2, wo (H
// each)] [the buffers, when in shared memory] [the code tile (P x CHUNK)].
struct Smem {
  size_t w2, b2, wo, buf, code, bytes;
  __host__ __device__ Smem(int H, bool resident, bool shared_buf) {
    size_t o = 0;
    w2 = o;
    if (resident) o += sizeof(float) * static_cast<size_t>(H) * (H + 1);
    b2 = o; o += sizeof(float) * H;
    wo = o; o += sizeof(float) * H;
    buf = o;
    if (shared_buf) o += sizeof(float) * static_cast<size_t>(Buf(H).floats);
    code = o; o += P * CHUNK;
    bytes = (o + 127) / 128 * 128;
  }
};

// Scratch layout (floats): dw2 (nblk, H, H) | s_theta (splits, B, H) | s_d
// (tiles, M, H) | ll (splits, B) | db2 (nblk, H) | dwo (nblk, H) | dbo
// (nblk) | W2^T (H, H; not resident) | the blocks' buffers (nblk x Buf;
// only where they do not fit shared memory).
struct Parts {
  float *dw2, *sth, *sd, *ll, *db2, *dwo, *dbo, *w2t, *bufs;
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
    w2t = dbo + nblk;
    bufs = w2t + H * H;
  }
  static long long floats(long long B, long long M, long long H,
                          long long tiles, long long splits,
                          bool shared_buf) {
    const long long nblk = tiles * splits;
    return nblk * H * H + splits * B * H + tiles * M * H + splits * B +
           2 * nblk * H + nblk + H * H +
           (shared_buf ? 0 : nblk * Buf(H).floats);
  }
};

// Where a width's buffers live: shared memory when they fit beside the
// rest (H <= 384), else the scratch.
inline bool shared_buf(int H) {
  return Smem(H, H == GROUP, true).bytes <= SMEM_MAX;
}

__global__ void transpose_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int H) {
  const size_t n = static_cast<size_t>(H) * H;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / H, c = i % H;
    y[c * H + r] = x[i];
  }
}

// RESIDENT (H == 128): W2 in shared memory, dW2 and s_theta in registers.
// SHARED_BUF: the per-item buffers in shared memory (else the scratch).
template <bool RESIDENT, bool SHARED_BUF>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_f32_kernel(const float* __restrict__ t1,
                     const float* __restrict__ t2,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ wo,
                     const float* __restrict__ bo,
                     const int8_t* __restrict__ pk, float* scratch, int B,
                     int M, int H, int items_per_split) {
  const Smem S(H, RESIDENT, SHARED_BUF);
  const Buf L(H);
  extern __shared__ __align__(128) unsigned char smem[];
  float* w2_s = reinterpret_cast<float*>(smem + S.w2);
  float* b2_s = reinterpret_cast<float*>(smem + S.b2);
  float* wo_s = reinterpret_cast<float*>(smem + S.wo);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem + S.code);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x, splits = gridDim.y;
  const int blk = tile * splits + split;
  const int b0 = tile * P;
  const int j0 = split * items_per_split;
  const int j1 = min(M, j0 + items_per_split);
  const int groups = H / GROUP;
  const int LDW = RESIDENT ? H + 1 : H;
  Parts parts(scratch, B, M, H, tiles, splits);
  float* base = SHARED_BUF ? reinterpret_cast<float*>(smem + S.buf)
                           : parts.bufs + static_cast<size_t>(blk) * L.floats;
  float* h1t = base + L.h1t;
  float* dpt = base + L.dpt;
  float* st = base + L.st;
  float* red = base + L.red;
  float* db2w = base + L.db2w;
  float* dwow = base + L.dwow;
  float* dw2_blk = parts.dw2 + static_cast<size_t>(blk) * H * H;
  float* sth = parts.sth + static_cast<size_t>(split) * B * H;
  // the forward reads W2 by rows, dh1 by columns: W2 itself (shared,
  // resident) or its transposed copy (L2)
  const float* w2f = RESIDENT ? w2_s : w2;
  const float* w2c = RESIDENT ? w2_s : parts.w2t;
  const float bov = bo[0];

  if (RESIDENT)
    for (int i = tid; i < H * H; i += THREADS)
      w2_s[(i / H) * LDW + i % H] = w2[i];
  for (int c = tid; c < H; c += THREADS) {
    b2_s[c] = b2[c];
    wo_s[c] = wo[c];
  }
  for (int i = tid; i < WARPS * H; i += THREADS) {
    db2w[i] = 0.f;
    dwow[i] = 0.f;
  }
  if (!RESIDENT) {
    for (size_t i = tid; i < static_cast<size_t>(H) * H; i += THREADS)
      dw2_blk[i] = 0.f;
    for (int i = tid; i < P * H; i += THREADS) {
      const int row = b0 + i / H;
      if (row < B) sth[static_cast<size_t>(row) * H + i % H] = 0.f;
    }
  }
  // resident accumulators: dW2 rows a + 16 u, columns b + 16 v; s_theta of
  // rows 4 warp + i, columns lane + 32 q
  const int da = tid / 16, db = tid % 16;
  float dw2_acc[RESIDENT ? 8 : 1][RESIDENT ? 8 : 1];
  float sth_acc[RESIDENT ? ROWS : 1][RESIDENT ? 4 : 1];
  if (RESIDENT) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) dw2_acc[u][v] = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) sth_acc[i][q] = 0.f;
  }
  float ll_acc[ROWS], dbo_acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) ll_acc[i] = dbo_acc[i] = 0.f;
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

    // 1. h1T (H x P): a warp's lanes take consecutive students
    for (int i = tid; i < P * H; i += THREADS) {
      const int k = i / P, r = i % P, row = b0 + r;
      const float t1v = row < B ? t1[static_cast<size_t>(row) * H + k] : 0.f;
      h1t[k * LDP + r] = fmaxf(t1v + t2j[k], 0.f);
    }
    __syncthreads();

    // 2. pre2 = h1 W2 + b2 -> st; the warp's logits by shuffles
    float lp[ROWS] = {0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < groups; ++g) {
      const int c0 = g * GROUP + lane;
      float acc[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h1t + k * LDP + warp * ROWS);
        const float* wr = w2f + static_cast<size_t>(k) * LDW + c0;
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = wr[32 * q];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0][q] = fmaf(hv.x, wv[q], acc[0][q]);
          acc[1][q] = fmaf(hv.y, wv[q], acc[1][q]);
          acc[2][q] = fmaf(hv.z, wv[q], acc[2][q]);
          acc[3][q] = fmaf(hv.w, wv[q], acc[3][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + 32 * q;
          const float pre2 = acc[i][q] + b2_s[c];
          st[(warp * ROWS + i) * H + c] = pre2;
          lp[i] = fmaf(fmaxf(pre2, 0.f), wo_s[c], lp[i]);
        }
    }
    float dl[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float s = lp[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float logit = s + bov;
      const float cf =
          static_cast<float>(code_s[(warp * ROWS + i) * CHUNK + jj]);
      const float m = fminf(cf, 1.f), rr = fmaxf(cf - 1.f, 0.f);
      const float e = expf(-fabsf(logit));
      const float sp = log1pf(e) + fmaxf(logit, 0.f);     // softplus(logit)
      ll_acc[i] += -m * (rr > 0.5f ? sp - logit : sp);
      const float inv = 1.f / (1.f + e);
      const float sg = logit >= 0.f ? inv : 1.f - inv;    // sigmoid(logit)
      dl[i] = m * (rr - sg);
      dbo_acc[i] += dl[i];
    }

    // 3. the thread's own elements: dpre2 (st and dpT), the warp's db2, dwo
    for (int g = 0; g < groups; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = g * GROUP + lane + 32 * q;
        const float woc = wo_s[c];
        float dbs = 0.f, dws = 0.f;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int r = warp * ROWS + i;
          const float pre2 = st[r * H + c];
          dws = fmaf(fmaxf(pre2, 0.f), dl[i], dws);
          const float dp = pre2 > 0.f ? dl[i] * woc : 0.f;
          dbs += dp;
          st[r * H + c] = dp;
          dpt[c * LDP + r] = dp;
        }
        db2w[warp * H + c] += dbs;
        dwow[warp * H + c] += dws;
      }
    __syncthreads();

    // 4. dW2 += h1^T dpre2, a 128 x 128 block at a time
    for (int bi = 0; bi < groups; ++bi)
      for (int bj = 0; bj < groups; ++bj) {
        float part[8][8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v)
            part[u][v] = RESIDENT ? dw2_acc[RESIDENT ? u : 0][RESIDENT ? v : 0]
                                  : 0.f;
        const float* hr = h1t + (bi * GROUP + da) * LDP;
        const float* dr = st + bj * GROUP + db;
#pragma unroll 2
        for (int p = 0; p < P; ++p) {
          float hv[8], dv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) hv[u] = hr[16 * u * LDP + p];
#pragma unroll
          for (int v = 0; v < 8; ++v) dv[v] = dr[p * H + 16 * v];
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int v = 0; v < 8; ++v)
              part[u][v] = fmaf(hv[u], dv[v], part[u][v]);
        }
        if (RESIDENT) {
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int v = 0; v < 8; ++v)
              dw2_acc[RESIDENT ? u : 0][RESIDENT ? v : 0] = part[u][v];
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int v = 0; v < 8; ++v) {
              float* dst = dw2_blk +
                           static_cast<size_t>(bi * GROUP + da + 16 * u) * H +
                           bj * GROUP + db + 16 * v;
              *dst += part[u][v];
            }
        }
      }

    // 5. dh1 = dpre2 W2^T, masked by h1 > 0: s_theta and the warp's s_d
    for (int g = 0; g < groups; ++g) {
      const int k0 = g * GROUP + lane;
      float acc[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 4
      for (int c = 0; c < H; ++c) {
        const float4 dv =
            *reinterpret_cast<const float4*>(dpt + c * LDP + warp * ROWS);
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = RESIDENT ? w2c[static_cast<size_t>(k0 + 32 * q) * LDW + c]
                           : w2c[static_cast<size_t>(c) * H + k0 + 32 * q];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0][q] = fmaf(dv.x, wv[q], acc[0][q]);
          acc[1][q] = fmaf(dv.y, wv[q], acc[1][q]);
          acc[2][q] = fmaf(dv.z, wv[q], acc[2][q]);
          acc[3][q] = fmaf(dv.w, wv[q], acc[3][q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + 32 * q;
        float col = 0.f;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int r = warp * ROWS + i, row = b0 + r;
          const float dp1 = h1t[k * LDP + r] > 0.f ? acc[i][q] : 0.f;
          col += dp1;
          if (RESIDENT) {
            sth_acc[RESIDENT ? i : 0][RESIDENT ? q : 0] += dp1;
          } else if (row < B) {
            sth[static_cast<size_t>(row) * H + k] += dp1;
          }
        }
        red[warp * H + k] = col;
      }
    }
    __syncthreads();

    // 6. the item's s_d: the warps' sums in warp order
    for (int c = tid; c < H; c += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * H + c];
      parts.sd[(static_cast<size_t>(tile) * M + j) * H + c] = s;
    }
  }
  __syncthreads();

  // the block's partials
  if (RESIDENT) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v)
        dw2_blk[static_cast<size_t>(da + 16 * u) * H + db + 16 * v] =
            dw2_acc[RESIDENT ? u : 0][RESIDENT ? v : 0];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = b0 + warp * ROWS + i;
      if (row < B)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sth[static_cast<size_t>(row) * H + lane + 32 * q] =
              sth_acc[RESIDENT ? i : 0][RESIDENT ? q : 0];
    }
  }
  if (lane == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = b0 + warp * ROWS + i;
      if (row < B) parts.ll[static_cast<size_t>(split) * B + row] = ll_acc[i];
      s += dbo_acc[i];
    }
    red[warp] = s;      // free since the last barrier of the item loop
  }
  for (int c = tid; c < H; c += THREADS) {
    float sb = 0.f, sw = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sb += db2w[w * H + c];
      sw += dwow[w * H + c];
    }
    parts.db2[static_cast<size_t>(blk) * H + c] = sb;
    parts.dwo[static_cast<size_t>(blk) * H + c] = sw;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w];
    parts.dbo[blk] = s;
  }
}

// out = [ll (B) | s_theta (B, H) | s_d (M, H) | dW2 (H, H) | db2 (H) |
// dwo (H) | dbo (1)], each the sum of its partials in block order.
__global__ void deep_link_f32_reduce_kernel(const float* __restrict__ scratch,
                                            float* __restrict__ out, int B,
                                            int M, int H, int tiles,
                                            int splits) {
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

template <bool RESIDENT, bool SHARED_BUF>
cudaError_t set_smem(int H) {
  return cudaFuncSetAttribute(deep_link_f32_kernel<RESIDENT, SHARED_BUF>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(
                                  Smem(H, RESIDENT, SHARED_BUF).bytes));
}

// The item splits of the grid whose blocks fill the resident slots best
// (the fewest among equals), as csrc/deep_link.cu fills its grid. Every
// split gets at least one item.
template <bool RESIDENT, bool SHARED_BUF>
int fill_splits(int B, int M, int H, int* splits) {
  const size_t smem = Smem(H, RESIDENT, SHARED_BUF).bytes;
  cudaError_t err = set_smem<RESIDENT, SHARED_BUF>(H);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, deep_link_f32_kernel<RESIDENT, SHARED_BUF>, THREADS,
           smem)) != cudaSuccess)
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

template <bool RESIDENT, bool SHARED_BUF>
int launch(const void* t1, const void* t2, const void* w2, const void* b2,
           const void* wo, const void* bo, const void* pk, void* out,
           void* scratch, int B, int M, int H, int splits,
           cudaStream_t stream) {
  const int tiles = std::max(1, (B + P - 1) / P);
  const int per = (std::max(M, 1) + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= std::max(M, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem<RESIDENT, SHARED_BUF>(H);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* sc = static_cast<float*>(scratch);
  if (!RESIDENT) {
    Parts parts(sc, B, M, H, tiles, splits);
    const size_t hh = static_cast<size_t>(H) * H;
    transpose_kernel<<<static_cast<int>(std::min<size_t>((hh + 255) / 256,
                                                         1024)),
                       256, 0, stream>>>(static_cast<const float*>(w2),
                                         parts.w2t, H);
  }
  deep_link_f32_kernel<RESIDENT, SHARED_BUF>
      <<<dim3(tiles, splits), THREADS, Smem(H, RESIDENT, SHARED_BUF).bytes,
         stream>>>(
          static_cast<const float*>(t1), static_cast<const float*>(t2),
          static_cast<const float*>(w2), static_cast<const float*>(b2),
          static_cast<const float*>(wo), static_cast<const float*>(bo),
          static_cast<const int8_t*>(pk), sc, B, M, H, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * (H + 1) +
                       static_cast<size_t>(M) * H +
                       static_cast<size_t>(H) * (H + 2) + 1;
  const int blocks =
      static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  deep_link_f32_reduce_kernel<<<blocks, 256, 0, stream>>>(
      sc, static_cast<float*>(out), B, M, H, tiles, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool RESIDENT, bool SHARED_BUF>
int occupancy(int H, int* out) {
  const void* fn =
      reinterpret_cast<const void*>(deep_link_f32_kernel<RESIDENT, SHARED_BUF>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = set_smem<RESIDENT, SHARED_BUF>(H)) != cudaSuccess)
    return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, THREADS, Smem(H, RESIDENT, SHARED_BUF).bytes);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(err);
}

inline bool valid(int B, int M, int H) {
  return B >= 0 && M >= 0 && H >= GROUP && H % GROUP == 0;
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The item splits of the grid for (B, M, H) on the current device, and the
// scratch deep_link_f32_train needs (floats). H is any multiple of 128.
int deep_link_f32_plan(int B, int M, int H, int* splits,
                       long long* scratch_floats) {
  if (!valid(B, M, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bool sb = shared_buf(H);
  int rc;
  if (H == GROUP)
    rc = fill_splits<true, true>(B, M, H, splits);
  else if (sb)
    rc = fill_splits<false, true>(B, M, H, splits);
  else
    rc = fill_splits<false, false>(B, M, H, splits);
  if (rc != 0) return rc;
  const long long tiles = std::max(1, (B + P - 1) / P);
  *scratch_floats = Parts::floats(B, M, H, tiles, *splits, sb);
  return 0;
}

// t1 (B, H), t2 (M, H), w2 (H, H), b2 (H), wo (H), bo (1): f32 contiguous;
// pk (B, M) int8 contiguous; out (B + B*H + M*H + H*H + 2H + 1) f32 (the
// layout of deep_link_f32_reduce_kernel); scratch of the size
// deep_link_f32_plan gives for `splits`.
int deep_link_f32_train(const void* t1, const void* t2, const void* w2,
                        const void* b2, const void* wo, const void* bo,
                        const void* pk, void* out, void* scratch, int B,
                        int M, int H, int splits, void* stream) {
  if (!valid(B, M, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == GROUP)
    return launch<true, true>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M,
                              H, splits, s);
  if (shared_buf(H))
    return launch<false, true>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B,
                               M, H, splits, s);
  return launch<false, false>(t1, t2, w2, b2, wo, bo, pk, out, scratch, B, M,
                              H, splits, s);
}

// The kernel a width H runs: ptxas's registers a thread, its local (spill)
// bytes and its resident blocks an SM, into out[0..3).
int deep_link_f32_occupancy(int H, int* out) {
  if (!valid(0, 0, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (H == GROUP) return occupancy<true, true>(H, out);
  if (shared_buf(H)) return occupancy<false, true>(H, out);
  return occupancy<false, false>(H, out);
}

}  // extern "C"
