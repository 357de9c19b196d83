// One-pass training log-likelihood of the deep nonlinear link on the int8
// response code, with every gradient, at f32 accuracy (the deep HMC
// potential's mode).
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
// dlogit, dbo = sum dlogit. Every product keeps f32 accuracy, as the
// Pallas kernel's dots at HIGHEST precision do: csrc/deep_link.cu rounds
// the operands to bf16 once, which the Metropolis test of HMC cannot take
// (a dH noise floor of units at the gold shapes). The relu masks use the
// f32 pre-activations.
//
// H = 128 (paper config 5, the deep gold), deep_link_f32_mma_kernel: the
// three products on the bf16 tensor cores with split operands. Each f32
// operand x is held as three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo
// = bf16(x - hi - mid) (round to nearest; their sum is x exactly), and a
// product takes the six part products whose terms reach ~2^-24 of it: hi.lo,
// mid.mid, lo.hi, hi.mid, mid.hi, hi.hi, in that order, each k-step of 16
// from a zero accumulator, added to the running f32 sum with f32 adds (the
// tensor cores truncate their f32 accumulation: the small terms go first so
// they truncate at their own scale, and no chain runs past 16 terms of
// hi.hi). That is f32's accuracy, not its rounding: a pre2 within f32
// rounding of 0 could take the other relu branch than an f32 product would
// (it moves the pair's dpre2 by dlogit wo, a whole term of the student's and
// the item's gradient rows), so a pre2 within HINGE of 0 (a bound of the
// split's error, from h1's row maximum and W2's column sums of |W2|) is
// recomputed by the warp as an f64 sum of exact products, and the relu branch
// is the exact sum's. What bounds it on an H100: six bf16 products of 6 H^2
// operations a pair, 36 H^2 a pair at 989 TFLOP/s (0.239 ms at 2,000 x 200
// and H = 128), against ~17 H of elementwise work, the operands' splits and
// the chunk adds (~11 H + 3 H^2 / 16 a pair) at 67 TFLOP/s (0.04 ms) and a
// few MB of traffic: the tensor-core operations. The layout is that of
// csrc/deep_link.cu's H = 128 kernel: inline-PTX mma.sync m16n8k16 from
// ldmatrix (.trans where an operand is read transposed: W2 for pre2, h1^T and
// dpre2 for dW2). A block of 256 threads owns P = 32 students and walks a
// contiguous run of items (grid y splits the items so the blocks fill the
// SMs); warp w owns row tile w / 4 (16 of the item's 32 pairs) and column
// group w % 4 (32 columns) of each (P x H) product, so pre2 and dh1 stay in
// its accumulators: dlogit, dpre2, db2 and dwo are formed in registers, a
// lane builds h1 and dpre2 at its own positions and splits them into the
// three parts in shared memory, and h1's relu mask is a bit mask of the
// lane's f32 pre-activations. W2's parts are split once a block into shared
// memory (102 KB), h1's and dpre2's are double-buffered by item parity (an
// item has one block-wide barrier, dpre2 ready, and two of its row tile's 128
// threads: h1 ready, the logit partials). The block's dW2 (warp w: rows 32 (w
// / 2) .. + 32, columns 64 (w % 2) .. + 64), s_theta and t1 stay in registers
// for the whole run (217 KB of shared memory leave no room).
//
// H = 256, 384, 512, deep_link_f32_cluster_kernel<H>: the H = 128 kernel's
// split arithmetic (three bf16 parts an operand, six part products a k-step
// of 16 from zero, f32 adds; pre2 near the hinge exact in f64) on a
// thread-block cluster. What bounds it is the same: 36 H^2 tensor-core
// operations a pair (0.954, 2.147 and 3.817 ms at 2,000 x 200 and H = 256,
// 384, 512). W2 in three parts (384 KB to 1.5 MB) and dW2 in f32 (256 KB to
// 1 MB) outgrow one SM, so a cluster of C CTAs (4, 8, 16; 16 is a
// non-portable size) shares P = 16 students (one m16 row tile) and the item,
// and CTA r owns link rows and columns c0 = r N .. c0 + N (N = H / C = 64,
// 48, 32). It holds W2's row panel W2[c0:c0+N, :] in three parts in shared
// memory (split once a CTA) and dW2[c0:c0+N, :]'s running sum in registers
// (64, 72, 64 floats a lane of 256), and computes for the item:
//   - h1[:, panel] = relu(t1 + t2) in three parts, its relu mask kept in
//     registers and its row maxima sent to every CTA;
//   - the panel's partial of pre2 over its k, h1[:, panel] W2[panel, :]
//     (P x H): the columns of CTA q's panel go to q (st.async onto q's
//     mbarrier), where pre2[:, panel] is the C partials added in rank order
//     plus b2, and a pre2 within the hinge of 0 is recomputed in f64;
//   - the panel's share of each pair's logit, sent to every CTA and added
//     there in rank order (the same logit and dlogit in every CTA);
//   - dpre2[:, panel] in three parts, sent to every CTA's whole (P x H) copy
//     (cp.async.bulk onto the receiver's mbarrier);
//   - dW2[panel, :] += h1[:, panel]^T dpre2, and dh1[:, panel] = dpre2
//     W2[panel, :]^T over the warps' shares of k (partials added in order),
//     masked into s_theta and s_d.
// The cluster holds W2 once: the layout of csrc/deep_link.cu's cluster
// kernel (W2's column and row panels a CTA, h1 gathered whole) takes 2 x 6
// P H bytes of h1's parts and two W2 panels, past the 232,448 bytes of a CTA
// at every width here. Per CTA (C, P, three bf16 parts of W2's row panel,
// dpre2 and h1's panel (two items), the f32 partials of pre2 and dh1;
// Clu<H>::SMEM, bytes):
//   H = 256: C = 4,  P = 16, W2 101,376 + dpre2 27,648 + partials 36,864 +
//            the rest 19,712 = 185,600;
//   H = 384: C = 8,  P = 16, W2 112,896 + dpre2 43,008 + partials 57,344 +
//            the rest 16,128 = 229,376;
//   H = 512: C = 16, P = 16, W2  99,840 + dpre2 61,440 + partials 55,296 +
//            the rest 12,672 = 229,248.
// With P = 32 dpre2's parts and the partials double, past the limit at 384
// and 512 (a send buffer for bulk copies of pre2's partials does not fit
// either, hence st.async). The items are pipelined: item j + 1's h1 and
// partials are built and sent while item j's dpre2 panels travel, and
// travel while item j's dW2 and dh1 run, so only the logit partials'
// exchange waits with nothing to do. An item has four block-wide barriers
// and three waits (pre2's partials, the logit partials, dpre2), no cluster
// barrier.
//
// Wider widths (H % 128 == 0), deep_link_f32_kernel: f32 products on
// the CUDA cores (6 H^2 f32 operations a pair at 67 TFLOP/s). A block of 256
// threads (8 warps) owns P = 32 students and walks a run of items; warp w
// owns rows 4w..4w+3 of each (P x H) product and a lane the columns l + 32 q
// of every 128-column group. Per item: h1 is built transposed (h1T, H x P,
// rows of P + 4 floats); pre2 goes to a staging tile (P x H), where each
// thread turns its own elements into dpre2 (also written transposed, dpT);
// then dW2 += h1^T dpre2 (a thread owns an 8 x 8 tile of each 128 x 128
// block of dW2) and dh1 = dpre2 W2^T, masked by h1 > 0 into s_theta and,
// summed over the warp's rows, into the item's s_d. Three block barriers an
// item. It reads W2 and a transposed copy (a prologue kernel writes it into
// the scratch) from L2, and adds dW2 and s_theta into the block's own
// partials in device memory every item; its per-item buffers stay in shared
// memory up to H = 384 and move to the block's own slice of the scratch
// beyond, 128-byte aligned (correct at every H % 128 == 0, built for it,
// not for speed; it runs at the widths past 512 only).
//
// Every kernel leaves every sum across blocks (ll and s_theta over the item
// splits, s_d over the student tiles, the weight gradients over all blocks)
// as a per-block partial that a second kernel adds in block order: no
// atomics, deterministic. The cluster kernel also counts, a CTA, the pre2
// values it recomputed in f64; the second kernel adds the counts into the
// output's last word (an int; -1 where the kernel does not count).

#include <cuda_bf16.h>
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

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

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

// Dynamic shared memory of deep_link_f32_kernel: [b2, wo (H each)] [the
// buffers, when in shared memory] [the code tile (P x CHUNK)].
struct Smem {
  size_t b2, wo, buf, code, bytes;
  __host__ __device__ Smem(int H, bool shared_buf) {
    size_t o = 0;
    b2 = o; o += sizeof(float) * H;
    wo = o; o += sizeof(float) * H;
    buf = o;
    if (shared_buf) o += sizeof(float) * static_cast<size_t>(Buf(H).floats);
    code = o; o += P * CHUNK;
    bytes = align128(o);
  }
};

constexpr int MAX_CLUSTER = 16;    // CTAs a cluster, at most

// Scratch layout (floats): dw2 (nblk, H, H) | s_theta (splits, B, H) | s_d
// (tiles, M, H) | ll (splits, B) | db2 (nblk, H) | dwo (nblk, H) | dbo
// (nblk) | the f64 recomputes (nblk, MAX_CLUSTER; ints, a CTA of the
// cluster kernel) | for deep_link_f32_kernel only, from a 128-byte
// boundary (its buffers take float4 loads): W2^T (H, H) and the blocks'
// buffers (nblk x Buf; only where they do not fit shared memory).
struct Parts {
  float *dw2, *sth, *sd, *ll, *db2, *dwo, *dbo, *w2t, *bufs;
  int* cnt;
  __host__ __device__ static long long head(long long B, long long M,
                                            long long H, long long tiles,
                                            long long splits) {
    const long long nblk = tiles * splits;
    return (nblk * H * H + splits * B * H + tiles * M * H + splits * B +
            2 * nblk * H + nblk + nblk * MAX_CLUSTER + 31) / 32 * 32;
  }
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
    cnt = reinterpret_cast<int*>(dbo + nblk);
    w2t = s + head(B, M, H, tiles, splits);
    bufs = w2t + H * H;
  }
  // cuda_core: deep_link_f32_kernel's W2^T and, where they do not fit
  // shared memory, its buffers
  static long long floats(long long B, long long M, long long H,
                          long long tiles, long long splits, bool cuda_core,
                          bool shared_buf) {
    const long long nblk = tiles * splits;
    return head(B, M, H, tiles, splits) +
           (cuda_core ? H * H + (shared_buf ? 0 : nblk * Buf(H).floats) : 0);
  }
};

// Where a width's buffers live: shared memory when they fit beside the
// rest (H <= 384), else the scratch.
inline bool shared_buf(int H) { return Smem(H, true).bytes <= SMEM_MAX; }

__global__ void transpose_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int H) {
  const size_t n = static_cast<size_t>(H) * H;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / H, c = i % H;
    y[c * H + r] = x[i];
  }
}

// ---- H % 128 == 0 other than 128: f32 products on the CUDA cores ---------

// SHARED_BUF: the per-item buffers in shared memory (else the scratch).
template <bool SHARED_BUF>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_f32_kernel(const float* __restrict__ t1,
                     const float* __restrict__ t2,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ wo,
                     const float* __restrict__ bo,
                     const int8_t* __restrict__ pk, float* scratch, int B,
                     int M, int H, int items_per_split) {
  const Smem S(H, SHARED_BUF);
  const Buf L(H);
  extern __shared__ __align__(128) unsigned char smem[];
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
  // the forward reads W2 by rows, dh1 by columns: its transposed copy
  const float* w2t = parts.w2t;
  const float bov = bo[0];

  for (int c = tid; c < H; c += THREADS) {
    b2_s[c] = b2[c];
    wo_s[c] = wo[c];
  }
  for (int i = tid; i < WARPS * H; i += THREADS) {
    db2w[i] = 0.f;
    dwow[i] = 0.f;
  }
  for (size_t i = tid; i < static_cast<size_t>(H) * H; i += THREADS)
    dw2_blk[i] = 0.f;
  for (int i = tid; i < P * H; i += THREADS) {
    const int row = b0 + i / H;
    if (row < B) sth[static_cast<size_t>(row) * H + i % H] = 0.f;
  }
  // a thread's dW2 tile: rows da + 16 u, columns db + 16 v
  const int da = tid / 16, db = tid % 16;
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
        const float* wr = w2 + static_cast<size_t>(k) * H + c0;
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
          for (int v = 0; v < 8; ++v) part[u][v] = 0.f;
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
          wv[q] = w2t[static_cast<size_t>(c) * H + k0 + 32 * q];
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
          if (row < B) sth[static_cast<size_t>(row) * H + k] += dp1;
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

// ---- H = 128: split-bf16 products on the tensor cores --------------------

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

constexpr int PARTS = 3;           // hi, mid, lo

// (x0, x1) as three bf16x2 parts, p[0] = hi, p[1] = mid, p[2] = lo, each
// rounded to nearest from what the parts before it leave: x - hi and
// x - hi - mid are exact in f32 and lo takes the last 8 bits, so the parts
// sum to x exactly.
__device__ __forceinline__ void split3(float x0, float x1,
                                       uint32_t (&p)[PARTS]) {
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    p[q] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// The six part products of a split product, smallest first: (a part, b
// part) of step s = hi.lo, mid.mid, lo.hi, hi.mid, mid.hi, hi.hi. The
// dropped ones (mid.lo, lo.mid, lo.lo) are below 2^-24 of |a| |b|.
__device__ __forceinline__ constexpr int part_a(int s) {
  return s < 3 ? s : s < 5 ? s - 3 : 0;
}
__device__ __forceinline__ constexpr int part_b(int s) {
  return s < 3 ? 2 - s : s < 5 ? 4 - s : 0;
}

// Layout of deep_link_f32_mma_kernel (H = 128). Shared memory, each region
// 128-byte aligned: W2's three parts (H x LD bf16 each), h1's and dpre2's
// three parts (P x LD bf16 each) for two items, t2 for two items, b2, wo,
// W2's column sums of |W2| (H), the logit partials and the h1 row maxima
// (P x CG each), the row tiles' s_d partials for two items, their db2 and
// dwo sums, ll and dbo a pair, the codes (P x CHUNK).
struct Mma {
  static constexpr int H = GROUP;
  static constexpr int LD = H + 8;       // bf16 row stride: 272 B, ldmatrix
                                         // and the parts' stores conflict-free
  static constexpr int RT = P / 16;      // row tiles (2)
  static constexpr int CG = WARPS / RT;  // column groups of 32 (4)
  static constexpr size_t W2_PART = align128(sizeof(__nv_bfloat16) * H * LD);
  static constexpr size_t ACT_PART = align128(sizeof(__nv_bfloat16) * P * LD);
  static constexpr size_t ACT_BUF = PARTS * ACT_PART;   // one item's parts
  static constexpr size_t W2_OFF = 0;
  static constexpr size_t H1_OFF = W2_OFF + PARTS * W2_PART;
  static constexpr size_t DP_OFF = H1_OFF + 2 * ACT_BUF;
  static constexpr size_t T2_OFF = DP_OFF + 2 * ACT_BUF;
  static constexpr size_t B2_OFF = T2_OFF + align128(sizeof(float) * 2 * H);
  static constexpr size_t WO_OFF = B2_OFF + align128(sizeof(float) * H);
  static constexpr size_t WC_OFF = WO_OFF + align128(sizeof(float) * H);
  static constexpr size_t LG_OFF = WC_OFF + align128(sizeof(float) * H);
  static constexpr size_t HM_OFF = LG_OFF + align128(sizeof(float) * P * CG);
  static constexpr size_t SD_OFF = HM_OFF + align128(sizeof(float) * P * CG);
  static constexpr size_t RED_OFF = SD_OFF + align128(sizeof(float) * 2 * RT * H);
  static constexpr size_t LL_OFF = RED_OFF + align128(sizeof(float) * 2 * RT * H);
  static constexpr size_t DBO_OFF = LL_OFF + align128(sizeof(float) * P);
  static constexpr size_t CODE_OFF = DBO_OFF + align128(sizeof(float) * P);
  static constexpr size_t SMEM = CODE_OFF + align128(P * CHUNK);
  static_assert(RT * CG == WARPS && CG * 32 == H, "warp tiles");
  static_assert(RT == 2 && CG == 4, "the row tiles' sums, the logit float4");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
};

// The split's pre2 = h1 W2 + b2 lies within 2^-19.4 of sum_k h1_k |W2_kn|
// of the exact sum (the dropped part products below 2^-23 of each term,
// the tensor cores' truncation of each k-step's six products below 6
// 2^-22 of its terms, eight f32 adds); HINGE = 2^-19 of the bound
// max_k h1_k sum_k |W2_kn| (>= sum_k h1_k |W2_kn|) is past that. A pre2
// within HINGE of 0 is recomputed by exact_dot, so the relu branch is the
// exact sum's.
constexpr float HINGE = 1.0f / 524288.0f;

// (h1 W2)[r][c] of h1's row r (pairs of the item) as the f64 sum of the
// exact products of h1's and W2's f32 values (each the sum of its three
// parts, exact in f64), by the whole warp: lane l takes k = l + 32 i, then
// a fixed shuffle tree; every lane returns the sum.
__device__ __forceinline__ double exact_dot(const __nv_bfloat16* h1_s,
                                            const __nv_bfloat16* w2_s, int r,
                                            int c, int lane) {
  constexpr int LD = Mma::LD;
  constexpr size_t W2E = Mma::W2_PART / sizeof(__nv_bfloat16);
  constexpr size_t ACTE = Mma::ACT_PART / sizeof(__nv_bfloat16);
  static_assert(Mma::H == 4 * 32, "four k a lane");
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = lane + 32 * i;
    double x = 0.0, y = 0.0;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      x += static_cast<double>(__bfloat162float(h1_s[q * ACTE + r * LD + k]));
      y += static_cast<double>(__bfloat162float(w2_s[q * W2E + k * LD + c]));
    }
    sum = fma(x, y, sum);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// The split products of one k-step of a warp's 16 x 32 tile: fresh[n] = a
// b[n] over the six part products (from zero), b[n2][q] holding n8 tiles
// 2 n2 and 2 n2 + 1 of part q; then acc += fresh with f32 adds.
__device__ __forceinline__ void tile_step(float (&acc)[4][4],
                                          const uint32_t (&a)[PARTS][4],
                                          const uint32_t (&b)[2][PARTS][4]) {
  float fresh[4][4] = {};
#pragma unroll
  for (int s = 0; s < 6; ++s)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      mma_bf16(fresh[n], a[part_a(s)], b[n / 2][part_b(s)][2 * (n % 2)],
               b[n / 2][part_b(s)][2 * (n % 2) + 1]);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += fresh[n][e];
}

__global__ void __launch_bounds__(THREADS, 1)
deep_link_f32_mma_kernel(const float* __restrict__ t1,
                         const float* __restrict__ t2,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ wo,
                         const float* __restrict__ bo,
                         const int8_t* __restrict__ pk,
                         float* __restrict__ scratch, int B, int M,
                         int items_per_split) {
  using C = Mma;
  constexpr int H = C::H, LD = C::LD, RT = C::RT, CG = C::CG;
  constexpr size_t W2E = C::W2_PART / sizeof(__nv_bfloat16);
  constexpr size_t ACTE = C::ACT_PART / sizeof(__nv_bfloat16);
  constexpr size_t BUFE = C::ACT_BUF / sizeof(__nv_bfloat16);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2_s = reinterpret_cast<__nv_bfloat16*>(smem + C::W2_OFF);
  __nv_bfloat16* h1_2 = reinterpret_cast<__nv_bfloat16*>(smem + C::H1_OFF);
  __nv_bfloat16* dp_2 = reinterpret_cast<__nv_bfloat16*>(smem + C::DP_OFF);
  float* t2_s = reinterpret_cast<float*>(smem + C::T2_OFF);
  float* b2_s = reinterpret_cast<float*>(smem + C::B2_OFF);
  float* wo_s = reinterpret_cast<float*>(smem + C::WO_OFF);
  float* wc_s = reinterpret_cast<float*>(smem + C::WC_OFF);
  float* lg_s = reinterpret_cast<float*>(smem + C::LG_OFF);
  float* hm_s = reinterpret_cast<float*>(smem + C::HM_OFF);
  float* sd_s = reinterpret_cast<float*>(smem + C::SD_OFF);
  float* red_s = reinterpret_cast<float*>(smem + C::RED_OFF);
  float* ll_s = reinterpret_cast<float*>(smem + C::LL_OFF);
  float* dbo_s = reinterpret_cast<float*>(smem + C::DBO_OFF);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem + C::CODE_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = warp / CG, cg = warp % CG;
  const int wr0 = rt * 16, wc0 = cg * 32;       // the warp's product tile
  const int ra = wr0 + g, rb = ra + 8;           // this lane's two pairs
  const int dr0 = (warp / 2) * 32, dc0 = (warp % 2) * 64;   // its dW2 tile
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x, splits = gridDim.y;
  const int blk = tile * splits + split;
  const int b0 = tile * P;
  const int j0 = split * items_per_split;
  const int j1 = min(M, j0 + items_per_split);

  for (int i = tid; i < H * H / 2; i += THREADS) {
    const int r = 2 * i / H, c = 2 * i % H;
    const float2 v = reinterpret_cast<const float2*>(w2)[i];
    uint32_t p[PARTS];
    split3(v.x, v.y, p);
#pragma unroll
    for (int q = 0; q < PARTS; ++q)
      *reinterpret_cast<uint32_t*>(w2_s + q * W2E + r * LD + c) = p[q];
  }
  if (tid < H) {
    b2_s[tid] = b2[tid];
    wo_s[tid] = wo[tid];
    t2_s[tid] = j0 < j1 ? t2[static_cast<size_t>(j0) * H + tid] : 0.f;
    float wc = 0.f;
    for (int k = 0; k < H; ++k) wc += fabsf(w2[k * H + tid]);
    wc_s[tid] = wc;
  }
  if (tid < P) {
    ll_s[tid] = 0.f;
    dbo_s[tid] = 0.f;
  }
  const float bov = bo[0];
  // Registers for the block's run. A lane's positions in a (P x H)
  // product: element e of n8 tile n is row (e < 2 ? ra : rb), column
  // wc0 + 8 n + 2 t + e % 2; t1 and s_theta there ([row half][2 n + e % 2]).
  // dW2: element e of n8 tile n of m16 tile u is row dr0 + 16 u + g +
  // 8 (e / 2), column dc0 + 8 n + 2 t + e % 2. db2 and dwo of the row tile's
  // pairs in column cs, each item's summed over the warp's rows first.
  float t1r[2][8], sth[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = b0 + (h ? rb : ra);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 v =
          row < B ? *reinterpret_cast<const float2*>(
                        t1 + static_cast<size_t>(row) * H + wc0 + 8 * n + 2 * t)
                  : make_float2(0.f, 0.f);
      t1r[h][2 * n] = v.x;
      t1r[h][2 * n + 1] = v.y;
      sth[h][2 * n] = sth[h][2 * n + 1] = 0.f;
    }
  }
  float dw2[2][8][4] = {}, db2 = 0.f, dwo = 0.f;
  const int cs = wc0 + (g / 2) * 8 + 2 * t + g % 2;
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const int jj = (j - j0) % CHUNK, buf = (j - j0) & 1;
    __nv_bfloat16* h1_s = h1_2 + buf * BUFE;     // part q at + q * ACTE
    __nv_bfloat16* dp_s = dp_2 + buf * BUFE;
    if (jj == 0) {   // the row tile's codes of the next CHUNK items: thread
      // q takes row wr0 + q / 8, items 2 (q % 8) and + 1
      const int q = tid % 128, crow = wr0 + q / 8, ci = 2 * (q % 8);
      const bool in = b0 + crow < B;
      const int8_t* src = pk + static_cast<size_t>(b0 + crow) * M + j + ci;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        code_s[crow * CHUNK + ci + u] =
            in && j + ci + u < j1 ? src[u] : int8_t(0);
    }
    float t2_next = 0.f;
    if (tid < H && j + 1 < j1)
      t2_next = t2[static_cast<size_t>(j + 1) * H + tid];

    // 1. h1's parts at this lane's positions of the row tile, the relu
    // mask of its f32 pre-activations (bit 4 n + e), and the row maxima of
    // h1 over the warp's 32 columns
    uint32_t live = 0;
    float hmax[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc0 + 8 * n + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(t2_s + buf * H + c);
      const float p[4] = {t1r[0][2 * n] + u.x, t1r[0][2 * n + 1] + u.y,
                          t1r[1][2 * n] + u.x, t1r[1][2 * n + 1] + u.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        live |= (p[e] > 0.f ? 1u : 0u) << (4 * n + e);
        hmax[e / 2] = fmaxf(hmax[e / 2], p[e]);
      }
      uint32_t pa[PARTS], pb[PARTS];
      split3(fmaxf(p[0], 0.f), fmaxf(p[1], 0.f), pa);
      split3(fmaxf(p[2], 0.f), fmaxf(p[3], 0.f), pb);
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        *reinterpret_cast<uint32_t*>(h1_s + q * ACTE + ra * LD + c) = pa[q];
        *reinterpret_cast<uint32_t*>(h1_s + q * ACTE + rb * LD + c) = pb[q];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hmax[h] = fmaxf(hmax[h], __shfl_xor_sync(0xffffffffu, hmax[h], 1));
      hmax[h] = fmaxf(hmax[h], __shfl_xor_sync(0xffffffffu, hmax[h], 2));
    }
    if (t == 0) {
      hm_s[ra * CG + cg] = hmax[0];
      hm_s[rb * CG + cg] = hmax[1];
    }
    row_tile_sync(1 + rt);

    // 2. pre2 = h1 W2 + b2
    float acc[4][4] = {};
#pragma unroll 1
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[PARTS][4], b[2][PARTS][4];
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        ldsm_x4(a[q], h1_s + q * ACTE + (wr0 + lane % 16) * LD + k0 +
                          (lane / 16) * 8);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(b[n2][q], w2_s + q * W2E + (k0 + lane % 16) * LD +
                                      wc0 + 16 * n2 + (lane / 16) * 8);
      }
      tile_step(acc, a, b);
    }
    // 3. pre2 within HINGE of 0 made exact (its relu branch the exact
    // sum's); the logit: this lane's 8 columns, its quad's 32, then the
    // row tile's four column groups in order (the same sum in every warp)
    float hinge[2];   // HINGE times the row's h1 maximum
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 q =
          *reinterpret_cast<const float4*>(hm_s + (h ? rb : ra) * CG);
      hinge[h] = HINGE * fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w));
    }
    uint32_t near = 0;   // bit 4 n + e: pre2 within HINGE of 0
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc0 + 8 * n + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(b2_s + c);
      const float2 wc = *reinterpret_cast<const float2*>(wc_s + c);
      acc[n][0] += bb.x; acc[n][1] += bb.y;
      acc[n][2] += bb.x; acc[n][3] += bb.y;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        near |= (fabsf(acc[n][e]) <= hinge[e / 2] * (e % 2 ? wc.y : wc.x)
                     ? 1u : 0u) << (4 * n + e);
    }
    if (__any_sync(0xffffffffu, near)) {   // rare: the warp recomputes each
      for (int i = 0; i < 16; ++i) {        // flagged element in turn
        for (uint32_t m = __ballot_sync(0xffffffffu, (near >> i) & 1u); m;
             m &= m - 1) {
          const int src = __ffs(m) - 1, n = i / 4, e = i % 4;
          const int c = wc0 + 8 * n + 2 * (src % 4) + e % 2;
          const float v = static_cast<float>(
              exact_dot(h1_s, w2_s, wr0 + src / 4 + 8 * (e / 2), c, lane) +
              static_cast<double>(b2_s[c]));
          if (lane == src) {
#pragma unroll
            for (int q = 0; q < 16; ++q)
              if (q == i) acc[q / 4][q % 4] = v;
          }
        }
      }
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc0 + 8 * n + 2 * t;
      const float2 ww = *reinterpret_cast<const float2*>(wo_s + c);
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
    // 4. dpre2 = [pre2 > 0] dlogit wo (its parts to shared), db2 and dwo
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
      uint32_t pa[PARTS], pb[PARTS];
      split3(dp[0], dp[1], pa);
      split3(dp[2], dp[3], pb);
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        *reinterpret_cast<uint32_t*>(dp_s + q * ACTE + ra * LD + c) = pa[q];
        *reinterpret_cast<uint32_t*>(dp_s + q * ACTE + rb * LD + c) = pb[q];
      }
    }
    db2 += sum_row_groups(vdb, lane);
    dwo += sum_row_groups(vdw, lane);
    if (tid < H && j + 1 < j1) t2_s[(buf ^ 1) * H + tid] = t2_next;
    __syncthreads();   // the only block-wide barrier of an item

    // 5. the previous item's s_d: its row tiles' partials, in order
    if (j > j0 && tid < H) {
      const float* s = sd_s + (buf ^ 1) * RT * H + tid;
      Parts(scratch, B, M, H, tiles, splits)
          .sd[(static_cast<size_t>(tile) * M + j - 1) * H + tid] = s[0] + s[H];
    }

    // 6. dW2 += h1^T dpre2: per k-step of 16 pairs, the split products of
    // the warp's 32 x 64 tile from zero, added to the running sum with f32
    // adds
#pragma unroll 1
    for (int p0 = 0; p0 < P; p0 += 16) {
      uint32_t a[2][PARTS][4];   // h1^T: rows dr0 + 16 u.. by pairs p0..
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int q = 0; q < PARTS; ++q)
          ldsm_x4_trans(a[u][q], h1_s + q * ACTE +
                                     (p0 + lane % 8 + (lane / 16) * 8) * LD +
                                     dr0 + 16 * u + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t b[PARTS][4];    // dpre2: columns dc0 + 16 i.. by pairs p0..
#pragma unroll
        for (int q = 0; q < PARTS; ++q)
          ldsm_x4_trans(b[q], dp_s + q * ACTE + (p0 + lane % 16) * LD + dc0 +
                                  16 * i + (lane / 16) * 8);
        float fresh[2][2][4] = {};
#pragma unroll
        for (int s = 0; s < 6; ++s)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mma_bf16(fresh[u][h], a[u][part_a(s)], b[part_b(s)][2 * h],
                       b[part_b(s)][2 * h + 1]);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw2[u][2 * i + h][e] += fresh[u][h][e];
      }
    }

    // 7. dh1 = dpre2 W2^T, the f32 h1 mask, s_theta, and the row tile's
    // part of the item's s_d
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[PARTS][4], b[2][PARTS][4];
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        ldsm_x4(a[q], dp_s + q * ACTE + (wr0 + lane % 16) * LD + k0 +
                          (lane / 16) * 8);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)   // W2^T as a col operand: (k, n) at
          // W2[n][k]
          ldsm_x4(b[n2][q], w2_s + q * W2E +
                                (wc0 + 16 * n2 + lane % 8 + (lane / 16) * 8) *
                                    LD +
                                k0 + ((lane / 8) % 2) * 8);
      }
      tile_step(acc, a, b);
    }
    float col[8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float d1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d1[e] = (live >> (4 * n + e)) & 1u ? acc[n][e] : 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sth[0][2 * n + e] += d1[e];
        sth[1][2 * n + e] += d1[e + 2];
        col[2 * n + e] = d1[e] + d1[e + 2];
      }
    }
    sd_s[(buf * RT + rt) * H + cs] = sum_row_groups(col, lane);
  }
  __syncthreads();

  // the last item's s_d, this split's ll and s_theta of the block's
  // students, the block's dW2, db2, dwo and dbo
  const Parts parts(scratch, B, M, H, tiles, splits);
  if (j1 > j0 && tid < H) {
    const float* s = sd_s + ((j1 - 1 - j0) & 1) * RT * H + tid;
    parts.sd[(static_cast<size_t>(tile) * M + j1 - 1) * H + tid] =
        s[0] + s[H];
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
          make_float2(sth[h][2 * n], sth[h][2 * n + 1]);
  }
  float* dw2_blk = parts.dw2 + static_cast<size_t>(blk) * H * H;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            dw2_blk + static_cast<size_t>(dr0 + 16 * u + g + 8 * r) * H +
            dc0 + 8 * n + 2 * t) =
            make_float2(dw2[u][n][2 * r], dw2[u][n][2 * r + 1]);
  red_s[rt * H + cs] = db2;
  red_s[(RT + rt) * H + cs] = dwo;
  __syncthreads();
  if (tid < H) {
    const float* s = red_s + tid;
    parts.db2[static_cast<size_t>(blk) * H + tid] = s[0] + s[H];
    s += RT * H;
    parts.dwo[static_cast<size_t>(blk) * H + tid] = s[0] + s[H];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < P; ++r) s += dbo_s[r];
    parts.dbo[blk] = s;
  }
}

// ---- H = 256, 384, 512: split-bf16 products over a thread-block cluster --

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

// Four floats (16 bytes aligned) into another CTA's shared memory at the
// shared::cluster address `remote`, completing 16 bytes on its barrier at
// `bar` (a shared::cluster address); one float, 4 bytes.
__device__ __forceinline__ void st_async4(uint32_t remote, float4 x,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async1(uint32_t remote, float x,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(remote),
      "f"(x), "r"(bar)
      : "memory");
}

// The hinge of the cluster kernel at width H: a pre2 within hinge(H) max_k
// h1_k sum_k |W2_kn| of 0 is recomputed in f64. The split's pre2 lies within
// E = (2 + 24 + H / 16 + 1) 2^-24 sum_k h1_k |W2_kn| of the exact sum: the
// dropped part products (mid.lo, lo.mid, lo.lo) below 2^-23 of each term;
// the tensor cores' truncation of each k-step's six chained products below
// 6 2^-22 of its terms; H / 16 - 1 f32 adds of the k-steps' sums (within
// each panel's partial and of the C partials in rank order) and the add of
// b2, each below 2^-24 of the terms' sum; one more 2^-24 for the f64
// value's rounding to f32. E grows with H (the H = 128 kernel's HINGE,
// derived for its eight adds, is below E at 256 and up); hinge(H) = 2 E / 
// sum: the tensor cores' accumulation is not documented, so twice the
// derived bound, and max_k h1_k sum_k |W2_kn| >= sum_k h1_k |W2_kn| adds to
// the margin. Too wide only sends more values down the f64 path (counted).
__host__ __device__ constexpr float deep_hinge(int H) {
  return 2.0f * (27 + H / 16) / 16777216.0f;
}

// The cluster's size C at each width.
template <int H>
struct SplitWidth;
template <>
struct SplitWidth<256> { static constexpr int C = 4; };
template <>
struct SplitWidth<384> { static constexpr int C = 8; };
template <>
struct SplitWidth<512> { static constexpr int C = 16; };

// Layout of deep_link_f32_cluster_kernel<H> (shared memory, each region
// 128-byte aligned): W2's row panel in three parts (N x LDH bf16 each);
// dpre2 whole in three parts, panel-major (CTA q's panel at q PANEL: part,
// then P rows of LDP bf16), so that a panel is one contiguous copy; h1's
// panel in three parts (two items, by parity); the C partials of pre2 sent here (P rows of LDR
// floats each, column N holding the sender's h1 row maxima); the warps'
// split-k partials of dh1 (KS, P x LDR); the warps' s_d sums (two items, by
// parity); b2, wo and sum_k |W2_kn| of the panel's columns; the logit
// partials (two items, [C][P]); the warps' recompute counts; three
// barriers; the codes (P x CHUNK). The warps: in pre2's partial and dW2,
// warp w takes NQ n8 tiles (columns w NQ 8 ..) of the (P x H) product, in
// chunks of CHP n8 pairs; in dh1 it takes group w / KS of NQH n8 tiles of
// the panel and share w % KS of k. The element passes give a pair LP = 16
// threads and each thread V = N / 16 of the panel's columns.
template <int H>
struct Clu {
  static constexpr int C = SplitWidth<H>::C;
  static constexpr int P = 16;          // students a cluster, pairs an item
  static constexpr int N = H / C;       // a CTA's panel: 64, 48, 32
  static constexpr int LP = 16;         // threads a pair (element passes)
  static constexpr int V = N / LP;      // columns a thread: 4, 3, 2
  static constexpr int NQ = H / 8 / WARPS;   // n8 tiles a warp: 4, 6, 8
  static constexpr int NPAIR = NQ / 2;
  static constexpr int CHP = NPAIR % 2 ? NPAIR : 2;   // pairs a chunk
  static constexpr int NH = N / 8 >= 8 ? 2 : 1;       // dh1's column groups
  static constexpr int KS = WARPS / NH;               // dh1's k shares
  static constexpr int NQH = N / 8 / NH;              // dh1: n8 tiles a warp
  static constexpr int KSTEPS = H / 16 / KS;          // dh1: k-steps a warp
  static constexpr int LDH = H + 8;     // bf16 stride: W2's row panel
  static constexpr int LDP = N + 8;     // bf16 stride: h1's, dpre2's panels
  // f32 stride of the partials, padded against bank conflicts (N = 32:
  // + 4 only, for the shared memory's limit)
  static constexpr int LDR = N == 32 ? N + 4 : N + 8;
  static constexpr int PANEL = PARTS * P * LDP;   // bf16 of a dpre2 panel
  static constexpr uint32_t PANEL_BYTES = sizeof(__nv_bfloat16) * PANEL;
  // what one CTA sends another of pre2: its partial and h1's row maxima
  static constexpr uint32_t SLOT_BYTES = sizeof(float) * (P * N + P);
  static constexpr size_t W2_OFF = 0;
  static constexpr size_t DP_OFF =
      W2_OFF + align128(sizeof(__nv_bfloat16) * PARTS * N * LDH);
  static constexpr size_t H1_OFF =
      DP_OFF + align128(sizeof(__nv_bfloat16) * C * PANEL);
  static constexpr size_t RECV_OFF =
      H1_OFF + align128(sizeof(__nv_bfloat16) * 2 * PARTS * P * LDP);
  static constexpr size_t RED_OFF =
      RECV_OFF + align128(sizeof(float) * C * P * LDR);
  static constexpr size_t SD_OFF =
      RED_OFF + align128(sizeof(float) * KS * P * LDR);
  static constexpr size_t B2_OFF = SD_OFF + align128(sizeof(float) * 2 * WARPS * N);
  static constexpr size_t WO_OFF = B2_OFF + align128(sizeof(float) * N);
  static constexpr size_t WC_OFF = WO_OFF + align128(sizeof(float) * N);
  static constexpr size_t LGX_OFF = WC_OFF + align128(sizeof(float) * N);
  static constexpr size_t CNT_OFF =
      LGX_OFF + align128(sizeof(float) * 2 * C * P);
  static constexpr size_t BAR_OFF = CNT_OFF + align128(sizeof(int) * WARPS);
  static constexpr size_t CODE_OFF = BAR_OFF + align128(3 * sizeof(uint64_t));
  static constexpr size_t SMEM = CODE_OFF + align128(P * CHUNK);
  static_assert(C * N == H && N % 16 == 0 && C <= MAX_CLUSTER, "panels");
  static_assert(P * LP == THREADS && P * CHUNK == THREADS && N <= THREADS,
                "element passes");
  static_assert(NPAIR % CHP == 0 && NQH % 2 == 0 && KS * KSTEPS * 16 == H &&
                NH * KS == WARPS && KS >= 2, "warp tiles; db2, dwo in RED");
  static_assert(PANEL_BYTES % 16 == 0 && P * sizeof(float) % 16 == 0,
                "bulk copies");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
};

// fresh = a b over the six part products, from zero: b[u] holds n8 tiles
// 2 u and 2 u + 1 of each part (ldsm_x4 / ldsm_x4_trans of a 16 x 16
// block).
template <int NP>
__device__ __forceinline__ void split_fresh(
    float (&fresh)[2 * NP][4], const uint32_t (&a)[PARTS][4],
    const uint32_t (&b)[NP][PARTS][4]) {
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) fresh[n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < 6; ++s)
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n)
      mma_bf16(fresh[n], a[part_a(s)], b[n / 2][part_b(s)][2 * (n % 2)],
               b[n / 2][part_b(s)][2 * (n % 2) + 1]);
}

// acc += the k-step's split product (split_fresh), with f32 adds.
template <int NP>
__device__ __forceinline__ void split_step(float (&acc)[2 * NP][4],
                                           const uint32_t (&a)[PARTS][4],
                                           const uint32_t (&b)[NP][PARTS][4]) {
  float fresh[2 * NP][4];
  split_fresh<NP>(fresh, a, b);
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += fresh[n][e];
}

// This CTA's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// V consecutive floats at p and their store (V = 4, 2: 16 or 8 bytes
// aligned).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = p[e];
  }
}

// The three bf16 parts of V floats at dst + q part (part q of x[e] at
// dst + q part + e).
template <int V>
__device__ __forceinline__ void store_parts(__nv_bfloat16* dst, int part,
                                            const float (&x)[V]) {
  if constexpr (V % 2 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      uint32_t p[PARTS];
      split3(x[e], x[e + 1], p);
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
        *reinterpret_cast<uint32_t*>(dst + q * part + e) = p[q];
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      uint32_t p[PARTS];
      split3(x[e], 0.f, p);
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
        reinterpret_cast<uint16_t*>(dst + q * part)[e] =
            static_cast<uint16_t>(p[q] & 0xffffu);
    }
  }
}

// pre2 - b2 of student row `row` and item j at column n, (h1 W2)[n], as the
// f64 sum of exact products from t1, t2 and W2 in device memory (h1 =
// relu(t1 + t2) in f32, as the kernel builds it), by the whole warp: lane l
// takes k = l + 32 i, then a fixed shuffle tree; every lane returns the sum.
template <int H>
__device__ __forceinline__ double exact_dot_rows(const float* __restrict__ t1,
                                                 const float* __restrict__ t2,
                                                 const float* __restrict__ w2,
                                                 int row, int j, int n,
                                                 int lane) {
  static_assert(H % 32 == 0, "H / 32 terms a lane");
  const float* t1r = t1 + static_cast<size_t>(row) * H;
  const float* t2r = t2 + static_cast<size_t>(j) * H;
  double sum = 0.0;
#pragma unroll 8
  for (int i = 0; i < H / 32; ++i) {
    const int k = lane + 32 * i;
    const float x = fmaxf(t1r[k] + t2r[k], 0.f);
    sum = fma(static_cast<double>(x),
              static_cast<double>(w2[static_cast<size_t>(k) * H + n]), sum);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// What crosses the CTAs, each completing once an item on the receiver's
// barrier (phase = item parity): bar[0] pre2's partials and h1's row maxima
// and bar[1] the logit partials (st.async), bar[2] the dpre2 panels (bulk
// copies). No cluster barrier is needed an item: a CTA sends item j + 1's
// partials only after every CTA's logit partials of item j have reached it,
// which each sent after reading its partials of item j; its logit partials
// only after every CTA's partials of the item have reached it, and its
// dpre2 panel only after every CTA's logit partials (each sent after its
// dW2 and dh1 of the item before), so each store or copy lands where its
// receiver has finished reading, in a phase its barrier has begun.
template <int H>
__global__ void __launch_bounds__(THREADS, 1)
deep_link_f32_cluster_kernel(const float* __restrict__ t1,
                             const float* __restrict__ t2,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             const float* __restrict__ wo,
                             const float* __restrict__ bo,
                             const int8_t* __restrict__ pk,
                             float* __restrict__ scratch, int B, int M,
                             int items_per_split) {
  using K = Clu<H>;
  constexpr int C = K::C, P = K::P, N = K::N, V = K::V, LP = K::LP,
                NQ = K::NQ, NPAIR = K::NPAIR, CHP = K::CHP, KS = K::KS,
                NQH = K::NQH, KSTEPS = K::KSTEPS, LDH = K::LDH,
                LDP = K::LDP, LDR = K::LDR, PANEL = K::PANEL;
  constexpr int W2P = N * LDH, H1P = P * LDP, PART_R = P * LDR;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2r_s = reinterpret_cast<__nv_bfloat16*>(smem + K::W2_OFF);
  __nv_bfloat16* dp_s = reinterpret_cast<__nv_bfloat16*>(smem + K::DP_OFF);
  __nv_bfloat16* h1_s = reinterpret_cast<__nv_bfloat16*>(smem + K::H1_OFF);
  float* recv_s = reinterpret_cast<float*>(smem + K::RECV_OFF);
  float* red_s = reinterpret_cast<float*>(smem + K::RED_OFF);
  float* sd_s = reinterpret_cast<float*>(smem + K::SD_OFF);
  float* b2_s = reinterpret_cast<float*>(smem + K::B2_OFF);
  float* wo_s = reinterpret_cast<float*>(smem + K::WO_OFF);
  float* wc_s = reinterpret_cast<float*>(smem + K::WC_OFF);
  float* lgx_s = reinterpret_cast<float*>(smem + K::LGX_OFF);
  int* cnt_s = reinterpret_cast<int*>(smem + K::CNT_OFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + K::BAR_OFF);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem + K::CODE_OFF);

  const int rank = cluster_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x / C, split = blockIdx.y;
  const int tiles = gridDim.x / C, splits = gridDim.y;
  const int blk = tile * splits + split;
  const int b0 = tile * P, c0 = rank * N;   // students; the panel's k, n
  const int j0 = split * items_per_split;
  const int j1 = min(M, j0 + items_per_split);
  // element passes: pair ep, the panel's columns en .. en + V
  const int ep = tid / LP, en = (tid % LP) * V;
  const bool live_row = b0 + ep < B;
  // the warp's columns of the (P x H) products; dh1's group and k share
  const int cw0 = warp * NQ * 8;
  const int q0 = (warp / KS) * NQH * 8, ks = warp % KS;

  const bool sender = warp == 0 && lane >= 1 && lane < C;
  auto send = [&](const void* local, uint32_t bytes, const uint64_t* b) {
    if (sender) copy_to_rank(local, bytes, b, (rank + lane) % C);
  };

  // W2's row panel in three parts, once a CTA
  for (int i = tid; i < N * H / 2; i += THREADS) {
    const int q = 2 * i / H, k = 2 * i % H;
    const float2 v = *reinterpret_cast<const float2*>(
        w2 + static_cast<size_t>(c0 + q) * H + k);
    uint32_t p[PARTS];
    split3(v.x, v.y, p);
#pragma unroll
    for (int r = 0; r < PARTS; ++r)
      *reinterpret_cast<uint32_t*>(w2r_s + r * W2P + q * LDH + k) = p[r];
  }
  if (tid < N) {
    b2_s[tid] = b2[c0 + tid];
    wo_s[tid] = wo[c0 + tid];
    float wc = 0.f;
    for (int k = 0; k < H; ++k) wc += fabsf(w2[static_cast<size_t>(k) * H + c0 + tid]);
    wc_s[tid] = wc;
  }
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Registers for the CTA's run: t1, s_theta, db2 and dwo at the thread's
  // (pair, columns); dW2[panel, :] (element e of n8 tile n of m16 tile i:
  // row c0 + 16 i + g + 8 (e / 2), column cw0 + 8 n + 2 t + e % 2); ll and
  // dbo of the pair in its first thread; the thread's recompute count
  float t1r[V], sth[V], db2r[V], dwor[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    t1r[e] = live_row ? t1[static_cast<size_t>(b0 + ep) * H + c0 + en + e]
                      : 0.f;
    sth[e] = db2r[e] = dwor[e] = 0.f;
  }
  float dw2[N / 16][NQ][4] = {};
  float ll_acc = 0.f, dbo_acc = 0.f;
  int cnt = 0;
  const float bov = bo[0];
  // this CTA's slot in every receiver's partials (the same offset in each)
  float* my_slot = recv_s + rank * PART_R;

  // Steps 1-2 of item j, given t2[j]'s panel columns of the thread: h1[:,
  // panel] in three parts into buffer (j - j0) & 1, its relu mask (bit e:
  // column en + e) returned, the pair's row maximum sent to every CTA's slot
  // of this CTA; then the panel's partial of pre2 (P x H) over its k: the
  // warp's NQ n8 tiles, chunk by chunk, each chunk's columns in one CTA's
  // panel, sent there (into this CTA's slot). The receivers have read their
  // slots of the item before: each sent its logit partials after reading
  // them, and these sends follow their receipt.
  auto h1_and_partial = [&](int j, const float (&t2v)[V]) -> uint32_t {
    __nv_bfloat16* h1b = h1_s + ((j - j0) & 1) * PARTS * H1P;
    uint32_t live = 0;
    {
      float x[V];
      float rm = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float pre = t1r[e] + t2v[e];
        live |= (pre > 0.f ? 1u : 0u) << e;
        x[e] = fmaxf(pre, 0.f);
        rm = fmaxf(rm, x[e]);
      }
      store_parts<V>(h1b + ep * LDP + en, H1P, x);
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1)
        rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, o));
      // the pair's thread l keeps it (l = 0) or sends it to rank + l
      const int l = tid % LP;
      float* dst = my_slot + ep * LDR + N;
      if (l == 0) {
        *dst = rm;
      } else if (l < C) {
        const int to = (rank + l) % C;
        st_async1(cluster_addr(dst, to), rm, cluster_addr(&bar[0], to));
      }
    }
    if (tid == 0) mbar_arrive_expect(&bar[0], (C - 1) * K::SLOT_BYTES);
    __syncthreads();   // h1's panel
#pragma unroll
    for (int ch = 0; ch < NPAIR / CHP; ++ch) {
      const int col0 = cw0 + ch * CHP * 16;
      float acc[2 * CHP][4] = {};
#pragma unroll 1
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t a[PARTS][4], b[CHP][PARTS][4];
#pragma unroll
        for (int q = 0; q < PARTS; ++q) {
          ldsm_x4(a[q], h1b + q * H1P + (lane % 16) * LDP + k0 +
                            (lane / 16) * 8);
#pragma unroll
          for (int u = 0; u < CHP; ++u)
            ldsm_x4_trans(b[u][q], w2r_s + q * W2P + (k0 + lane % 16) * LDH +
                                       col0 + 16 * u + (lane / 16) * 8);
        }
        split_step<CHP>(acc, a, b);
      }
      // lanes t and t ^ 1 trade halves: even t sends row g, columns 2 t ..
      // 2 t + 3 of each n8 tile, odd t row g + 8, columns 2 t - 2 .. 2 t + 1
      const bool odd = t & 1;
      float4 v[2 * CHP];
#pragma unroll
      for (int n = 0; n < 2 * CHP; ++n) {
        const float x0 = __shfl_xor_sync(0xffffffffu,
                                         odd ? acc[n][0] : acc[n][2], 1);
        const float x1 = __shfl_xor_sync(0xffffffffu,
                                         odd ? acc[n][1] : acc[n][3], 1);
        v[n] = odd ? make_float4(x0, x1, acc[n][2], acc[n][3])
                   : make_float4(acc[n][0], acc[n][1], x0, x1);
      }
      const int to = col0 / N;
      float* dst = my_slot + (g + (odd ? 8 : 0)) * LDR + (col0 - to * N) +
                   2 * (t & ~1);
      if (to == rank) {
#pragma unroll
        for (int n = 0; n < 2 * CHP; ++n)
          *reinterpret_cast<float4*>(dst + 8 * n) = v[n];
      } else {
        const uint32_t r = cluster_addr(dst, to),
                       rb = cluster_addr(&bar[0], to);
#pragma unroll
        for (int n = 0; n < 2 * CHP; ++n) st_async4(r + 4 * (8 * n), v[n], rb);
      }
    }
    return live;
  };

  __syncthreads();
  cluster_sync();   // every CTA runs, its barriers ready, before any send
  uint32_t live = 0;   // relu mask bits of the item's h1 (its panel)
  if (j0 < j1) {
    float t2v[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      t2v[e] = t2[static_cast<size_t>(j0) * H + c0 + en + e];
    live = h1_and_partial(j0, t2v);
  }

  for (int j = j0; j < j1; ++j) {
    const int jj = (j - j0) % CHUNK, buf = (j - j0) & 1;
    const uint32_t phase = (j - j0) & 1;
    const bool next = j + 1 < j1;
    const __nv_bfloat16* h1b = h1_s + buf * PARTS * H1P;
    if (jj == 0) {   // the next CHUNK items' codes, one a thread
      const int p = tid / CHUNK, i = tid % CHUNK;
      code_s[tid] = b0 + p < B && j + i < j1
                        ? pk[static_cast<size_t>(b0 + p) * M + j + i]
                        : int8_t(0);
    }
    float t2n[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      t2n[e] = next ? t2[static_cast<size_t>(j + 1) * H + c0 + en + e] : 0.f;
    mbar_wait(&bar[0], phase);   // every CTA's partial of this panel here
    __syncthreads();             // and this CTA's own, and the codes

    // 3. pre2[:, panel] = the partials in rank order + b2; a pre2 within
    // the hinge of 0 (an observed cell of a student of the table) made
    // exact, so its relu branch is the exact sum's; the panel's share of
    // the pair's logit (its V columns, its LP threads in order)
    float pre2[V], wov[V];
    {
      const float* rm = recv_s + ep * LDR + N;   // the senders' row maxima
      const float* rp = recv_s + ep * LDR + en;
      float hm = rm[0];
      load_vec<V>(rp, pre2);
#pragma unroll
      for (int r = 1; r < C; ++r) {
        float q[V];
        load_vec<V>(rp + r * PART_R, q);
        hm = fmaxf(hm, rm[r * PART_R]);
#pragma unroll
        for (int e = 0; e < V; ++e) pre2[e] += q[e];
      }
      float bb[V], wc[V];
      load_vec<V>(b2_s + en, bb);
      load_vec<V>(wo_s + en, wov);
      load_vec<V>(wc_s + en, wc);
      const bool observed = live_row && code_s[ep * CHUNK + jj] != 0;
      const float hinge = deep_hinge(H) * hm;
      uint32_t near = 0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        pre2[e] += bb[e];
        near |= (observed && fabsf(pre2[e]) <= hinge * wc[e] ? 1u : 0u) << e;
      }
      if (__any_sync(0xffffffffu, near)) {   // rare: the warp recomputes
        cnt += __popc(near);                   // each flagged value in turn
#pragma unroll
        for (int e = 0; e < V; ++e) {
          for (uint32_t m = __ballot_sync(0xffffffffu, (near >> e) & 1u); m;
               m &= m - 1) {
            const int src = __ffs(m) - 1;
            const int p = 2 * warp + src / LP, n = (src % LP) * V + e;
            const float v = static_cast<float>(
                exact_dot_rows<H>(t1, t2, w2, b0 + p, j, c0 + n, lane) +
                static_cast<double>(b2_s[n]));
            if (lane == src) pre2[e] = v;
          }
        }
      }
      float lg = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) lg = fmaf(fmaxf(pre2[e], 0.f), wov[e], lg);
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1)
        lg += __shfl_xor_sync(0xffffffffu, lg, o);
      // the pair's thread l keeps it (l = 0) or sends it to rank + l
      const int l = tid % LP;
      float* dst = lgx_s + (buf * C + rank) * P + ep;
      if (l == 0) {
        *dst = lg;
      } else if (l < C) {
        const int to = (rank + l) % C;
        st_async1(cluster_addr(dst, to), lg, cluster_addr(&bar[1], to));
      }
      __syncwarp();   // the pair's own partial, for its threads in step 4
      // the item before's s_d: the warps' sums in order
      if (j > j0 && tid < N) {
        const float* s = sd_s + (buf ^ 1) * WARPS * N + tid;
        float v = s[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) v += s[w * N];
        Parts(scratch, B, M, H, tiles, splits)
            .sd[(static_cast<size_t>(tile) * M + j - 1) * H + c0 + tid] = v;
      }
    }
    if (tid == 0) mbar_arrive_expect(&bar[1], (C - 1) * P * sizeof(float));
    mbar_wait(&bar[1], phase);   // every CTA's logit partials here

    // 4. the logit (the panels in rank order, the same in every CTA), ll,
    // dlogit; dpre2[:, panel] in three parts, db2, dwo
    {
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
      if (en == 0) {   // one thread a pair sums ll and dbo
        const float sp = log1pf(e) + fmaxf(logit, 0.f);   // softplus(logit)
        ll_acc += -m * (rr > 0.5f ? sp - logit : sp);
        dbo_acc += dl;
      }
      float d[V];
#pragma unroll
      for (int e2 = 0; e2 < V; ++e2) {
        d[e2] = pre2[e2] > 0.f ? dl * wov[e2] : 0.f;
        db2r[e2] += d[e2];
        dwor[e2] = fmaf(fmaxf(pre2[e2], 0.f), dl, dwor[e2]);
      }
      store_parts<V>(dp_s + rank * PANEL + ep * LDP + en, H1P, d);
      fence_async_shared();
    }
    __syncthreads();   // this CTA's panel of dpre2
    if (tid == 0) mbar_arrive_expect(&bar[2], (C - 1) * K::PANEL_BYTES);
    send(dp_s + rank * PANEL, K::PANEL_BYTES, &bar[2]);
    if (sender) copies_commit();

    // 1-2 of the next item while the panels travel: every CTA has read its
    // partials of this item (their logit partials are here)
    uint32_t live_next = 0;
    if (next) live_next = h1_and_partial(j + 1, t2n);
    mbar_wait(&bar[2], phase);   // every CTA's panel of dpre2 here

    // 5. dW2[panel, :] += h1[:, panel]^T dpre2: each (m16, n8) tile's
    // product from zero (one k-step: the item's 16 pairs), added with f32
    // adds
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      uint32_t a[PARTS][4];   // h1^T: rows 16 i.. of the panel by pairs
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
        ldsm_x4_trans(a[q], h1b + q * H1P +
                                (lane % 8 + (lane / 16) * 8) * LDP + 16 * i +
                                ((lane / 8) % 2) * 8);
#pragma unroll
      for (int ch = 0; ch < NPAIR / CHP; ++ch) {
        uint32_t b[CHP][PARTS][4];   // dpre2: columns col.. by pairs
#pragma unroll
        for (int u = 0; u < CHP; ++u) {
          const int col = cw0 + (ch * CHP + u) * 16, s = col / N;
#pragma unroll
          for (int q = 0; q < PARTS; ++q)
            ldsm_x4_trans(b[u][q], dp_s + s * PANEL + q * H1P +
                                       (lane % 16) * LDP + col - s * N +
                                       (lane / 16) * 8);
        }
        float fresh[2 * CHP][4];
        split_fresh<CHP>(fresh, a, b);
#pragma unroll
        for (int n = 0; n < 2 * CHP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dw2[i][ch * 2 * CHP + n][e] += fresh[n][e];
      }
    }

    // 6. dh1[:, panel] = dpre2 W2[panel, :]^T: the warp's NQH n8 tiles over
    // its share of k, into the split-k partials
    {
      float acc[NQH][4] = {};
#pragma unroll 1
      for (int st = 0; st < KSTEPS; ++st) {
        const int k0 = (ks * KSTEPS + st) * 16, s = k0 / N;
        uint32_t a[PARTS][4], b[NQH / 2][PARTS][4];
#pragma unroll
        for (int q = 0; q < PARTS; ++q) {
          ldsm_x4(a[q], dp_s + s * PANEL + q * H1P + (lane % 16) * LDP +
                            k0 - s * N + (lane / 16) * 8);
#pragma unroll
          for (int u = 0; u < NQH / 2; ++u)   // W2[panel, :]^T as a col
            // operand: (k, n) at W2[c0 + n][k]
            ldsm_x4(b[u][q], w2r_s + q * W2P +
                                 (q0 + 16 * u + lane % 8 + (lane / 16) * 8) *
                                     LDH +
                                 k0 + ((lane / 8) % 2) * 8);
        }
        split_step<NQH / 2>(acc, a, b);
      }
      float* dst = red_s + ks * PART_R + g * LDR + q0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NQH; ++n) {
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(dst + 8 * LDR + 8 * n) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
    // this CTA's copies have read its dpre2 panel, which the next item's
    // step 4 rewrites
    if (sender) copies_read();
    __syncthreads();

    // 7. dpre1 = [t1 + t2 > 0] dh1 (the shares of k in order; the mask of
    // the f32 pre-activations) into s_theta and the warp's part of the
    // item's s_d (its two pairs)
    {
      float col[V];
      const float* rp = red_s + ep * LDR + en;
      load_vec<V>(rp, col);
#pragma unroll
      for (int r = 1; r < KS; ++r) {
        float q[V];
        load_vec<V>(rp + r * PART_R, q);
#pragma unroll
        for (int e = 0; e < V; ++e) col[e] += q[e];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        col[e] = (live >> e) & 1u ? col[e] : 0.f;
        sth[e] += col[e];
        col[e] += __shfl_xor_sync(0xffffffffu, col[e], 16);
      }
      if (lane < 16) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          sd_s[(buf * WARPS + warp) * N + en + e] = col[e];
      }
    }
    live = live_next;
  }
  __syncthreads();

  // the last item's s_d, the block's dW2 rows, this split's s_theta, ll and
  // dbo of the block's students, db2 and dwo over the pairs in order, the
  // recompute count; no copy or store reaches this CTA after its last wait,
  // and its own copies have read their sources before it ends
  const Parts parts(scratch, B, M, H, tiles, splits);
  if (j1 > j0 && tid < N) {
    const float* s = sd_s + ((j1 - 1 - j0) & 1) * WARPS * N + tid;
    float v = s[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += s[w * N];
    parts.sd[(static_cast<size_t>(tile) * M + j1 - 1) * H + c0 + tid] = v;
  }
  float* dw2_blk = parts.dw2 + static_cast<size_t>(blk) * H * H;
#pragma unroll
  for (int i = 0; i < N / 16; ++i)
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            dw2_blk + static_cast<size_t>(c0 + 16 * i + g + 8 * r) * H + cw0 +
            8 * n + 2 * t) = make_float2(dw2[i][n][2 * r], dw2[i][n][2 * r + 1]);
  if (live_row) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      parts.sth[(static_cast<size_t>(split) * B + b0 + ep) * H + c0 + en + e] =
          sth[e];
    if (rank == 0 && en == 0)
      parts.ll[static_cast<size_t>(split) * B + b0 + ep] = ll_acc;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red_s[ep * LDR + en + e] = db2r[e];
    red_s[PART_R + ep * LDR + en + e] = dwor[e];
  }
  if (en == 0) recv_s[ep] = dbo_acc;   // free: no copy reaches it any more
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0) cnt_s[warp] = cnt;
  __syncthreads();
  if (tid < N) {
    float sb = 0.f, sw = 0.f;
    for (int p = 0; p < P; ++p) {
      sb += red_s[p * LDR + tid];
      sw += red_s[PART_R + p * LDR + tid];
    }
    parts.db2[static_cast<size_t>(blk) * H + c0 + tid] = sb;
    parts.dwo[static_cast<size_t>(blk) * H + c0 + tid] = sw;
  }
  if (tid == 0) {
    int c = 0;
    for (int w = 0; w < WARPS; ++w) c += cnt_s[w];
    parts.cnt[static_cast<size_t>(blk) * MAX_CLUSTER + rank] = c;
    if (rank == 0) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += recv_s[p];
      parts.dbo[blk] = s;
    }
  }
  if (sender) copies_read();
}

// out = [ll (B) | s_theta (B, H) | s_d (M, H) | dW2 (H, H) | db2 (H) |
// dwo (H) | dbo (1) | the f64 recomputes (1, an int)], each the sum of its
// partials in block order; `counts` CTAs a block counted their recomputes
// (0: the kernel does not count, and the last word is -1).
__global__ void deep_link_f32_reduce_kernel(const float* __restrict__ scratch,
                                            float* __restrict__ out, int B,
                                            int M, int H, int tiles,
                                            int splits, int counts) {
  Parts parts(const_cast<float*>(scratch), B, M, H, tiles, splits);
  const size_t nblk = static_cast<size_t>(tiles) * splits;
  const size_t n_ll = B, n_sth = static_cast<size_t>(B) * H,
               n_sd = static_cast<size_t>(M) * H,
               n_w = static_cast<size_t>(H) * H;
  const size_t total = n_ll + n_sth + n_sd + n_w + 2 * H + 2;
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
    } else if (x == static_cast<size_t>(H)) {
      for (size_t b = 0; b < nblk; ++b) s += parts.dbo[b];
    } else {
      int c = counts ? 0 : -1;
      for (size_t b = 0; b < nblk; ++b)
        for (int r = 0; r < counts; ++r) c += parts.cnt[b * MAX_CLUSTER + r];
      s = __int_as_float(c);
    }
    out[i] = s;
  }
}

// The kernel a width H runs and its dynamic shared memory: H = 128 the
// tensor-core kernel, 256, 384 and 512 the cluster kernel, every other width
// the CUDA-core one.
struct Variant {
  const void* fn;
  size_t smem;
  int cluster;   // CTAs a cluster (1: no cluster)
  int rows;      // students a block (a cluster)
};

Variant variant(int H) {
  if (H == GROUP)
    return {reinterpret_cast<const void*>(deep_link_f32_mma_kernel),
            Mma::SMEM, 1, P};
  if (H == 256)
    return {reinterpret_cast<const void*>(deep_link_f32_cluster_kernel<256>),
            Clu<256>::SMEM, Clu<256>::C, Clu<256>::P};
  if (H == 384)
    return {reinterpret_cast<const void*>(deep_link_f32_cluster_kernel<384>),
            Clu<384>::SMEM, Clu<384>::C, Clu<384>::P};
  if (H == 512)
    return {reinterpret_cast<const void*>(deep_link_f32_cluster_kernel<512>),
            Clu<512>::SMEM, Clu<512>::C, Clu<512>::P};
  if (shared_buf(H))
    return {reinterpret_cast<const void*>(deep_link_f32_kernel<true>),
            Smem(H, true).bytes, 1, P};
  return {reinterpret_cast<const void*>(deep_link_f32_kernel<false>),
          Smem(H, false).bytes, 1, P};
}

// The kernel's shared memory and, for a cluster of more than 8, the
// non-portable cluster size.
cudaError_t set_smem(const Variant& v) {
  cudaError_t err = cudaFuncSetAttribute(
      v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(v.smem));
  if (err == cudaSuccess && v.cluster > 8)
    err = cudaFuncSetAttribute(
        v.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The launch of a variant: clusters of v.cluster CTAs along x. The
// configuration points into this object: use it in place.
struct Launch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Launch(const Variant& v, dim3 grid, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = v.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = v.smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The blocks (clusters, for a cluster variant) the device holds at once.
int resident(const Variant& v, int* slots) {
  cudaError_t err = set_smem(v);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (v.cluster > 1) {
    Launch launch(v, dim3(v.cluster), nullptr);
    err = cudaOccupancyMaxActiveClusters(slots, v.fn, &launch.cfg);
  } else {
    int dev = 0, sms = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) == cudaSuccess &&
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, v.fn, THREADS,
                                                          v.smem);
    *slots = sms * occ;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return *slots < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

// The item splits of the grid whose blocks (clusters) fill the resident
// slots best (the fewest among equals), as csrc/deep_link.cu fills its
// grid. Every split gets at least one item.
int fill_splits(int B, int M, int H, int* splits) {
  const Variant v = variant(H);
  int slots = 0;
  const int rc = resident(v, &slots);
  if (rc != 0) return rc;
  const long long tiles = std::max(1, (B + v.rows - 1) / v.rows);
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

int launch(const float* t1, const float* t2, const float* w2,
           const float* b2, const float* wo, const float* bo,
           const int8_t* pk, float* out, float* sc, int B, int M, int H,
           int splits, cudaStream_t stream) {
  const Variant v = variant(H);
  const int tiles = std::max(1, (B + v.rows - 1) / v.rows);
  const int per = (std::max(M, 1) + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= std::max(M, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(v);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, splits);
  if (H == GROUP) {
    deep_link_f32_mma_kernel<<<grid, THREADS, v.smem, stream>>>(
        t1, t2, w2, b2, wo, bo, pk, sc, B, M, per);
  } else if (v.cluster > 1) {
    Launch l(v, dim3(tiles * v.cluster, splits), stream);
    if (H == 256)
      err = cudaLaunchKernelEx(&l.cfg, deep_link_f32_cluster_kernel<256>, t1,
                               t2, w2, b2, wo, bo, pk, sc, B, M, per);
    else if (H == 384)
      err = cudaLaunchKernelEx(&l.cfg, deep_link_f32_cluster_kernel<384>, t1,
                               t2, w2, b2, wo, bo, pk, sc, B, M, per);
    else
      err = cudaLaunchKernelEx(&l.cfg, deep_link_f32_cluster_kernel<512>, t1,
                               t2, w2, b2, wo, bo, pk, sc, B, M, per);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    Parts parts(sc, B, M, H, tiles, splits);
    const size_t hh = static_cast<size_t>(H) * H;
    transpose_kernel<<<static_cast<int>(std::min<size_t>((hh + 255) / 256,
                                                         1024)),
                       256, 0, stream>>>(w2, parts.w2t, H);
    if (shared_buf(H))
      deep_link_f32_kernel<true><<<grid, THREADS, v.smem, stream>>>(
          t1, t2, w2, b2, wo, bo, pk, sc, B, M, H, per);
    else
      deep_link_f32_kernel<false><<<grid, THREADS, v.smem, stream>>>(
          t1, t2, w2, b2, wo, bo, pk, sc, B, M, H, per);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * (H + 1) +
                       static_cast<size_t>(M) * H +
                       static_cast<size_t>(H) * (H + 2) + 2;
  const int blocks =
      static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  deep_link_f32_reduce_kernel<<<blocks, 256, 0, stream>>>(
      sc, out, B, M, H, tiles, splits, v.cluster > 1 ? v.cluster : 0);
  return static_cast<int>(cudaGetLastError());
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
  const int rc = fill_splits(B, M, H, splits);
  if (rc != 0) return rc;
  const Variant v = variant(H);
  const long long tiles = std::max(1, (B + v.rows - 1) / v.rows);
  *scratch_floats = Parts::floats(B, M, H, tiles, *splits,
                                  H != GROUP && v.cluster == 1, shared_buf(H));
  return 0;
}

// t1 (B, H), t2 (M, H), w2 (H, H), b2 (H), wo (H), bo (1): f32 contiguous;
// pk (B, M) int8 contiguous; out (B + B*H + M*H + H*H + 2H + 2) f32 (the
// layout of deep_link_f32_reduce_kernel: the last word is an int, the f64
// recomputes of the cluster kernel, -1 at the other widths); scratch of the
// size deep_link_f32_plan gives for `splits`.
int deep_link_f32_train(const void* t1, const void* t2, const void* w2,
                        const void* b2, const void* wo, const void* bo,
                        const void* pk, void* out, void* scratch, int B,
                        int M, int H, int splits, void* stream) {
  if (!valid(B, M, H)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(t1), static_cast<const float*>(t2),
                static_cast<const float*>(w2), static_cast<const float*>(b2),
                static_cast<const float*>(wo), static_cast<const float*>(bo),
                static_cast<const int8_t*>(pk), static_cast<float*>(out),
                static_cast<float*>(scratch), B, M, H, splits,
                static_cast<cudaStream_t>(stream));
}

// The kernel a width H runs: ptxas's registers a thread, its local (spill)
// bytes, its resident blocks an SM, its cluster size (1 for a kernel
// without clusters) and the clusters the device holds at once (for a
// kernel without clusters its resident blocks), into out[0..5).
int deep_link_f32_occupancy(int H, int* out) {
  if (!valid(0, 0, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Variant v = variant(H);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, v.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int slots = 0;
  const int rc = resident(v, &slots);
  if (rc != 0) return rc;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, v.fn, THREADS,
                                                      v.smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = v.cluster;
  out[4] = slots;
  return static_cast<int>(err);
}

// The split's hinge at width H: a pre2 within hinge max_k h1_k sum_k |W2_kn|
// of 0 is recomputed in f64 (HINGE at 128, deep_hinge(H) on the cluster
// kernel's widths); 0 at the widths of f32 products, which recompute none.
float deep_link_f32_hinge(int H) {
  if (H == GROUP) return HINGE;
  return variant(H).cluster > 1 ? deep_hinge(H) : 0.0f;
}

}  // extern "C"
