// Fused int8 decode + dual matmul: the ability encoder's first layer.
//
// Replaces the TPU Pallas kernels of vibo_tpu/ops/pallas_encoder.py:
//   first_layer_fwd  <- _fwd_pallas (:142), body _fwd_kernel (:76)
//       h (B, H) f32   = rm @ W_r + m @ W_m
//   first_layer_bwd  <- _bwd_pallas (:167), body _bwd_kernel (:93)
//       dW_r (M, H) f32 = rm^T @ bf16(dh),  dW_m (M, H) f32 = m^T @ bf16(dh)
// where the int8 code c (0 = missing, 1 = wrong, 2 = right) decodes to
// m = min(c, 1) and rm = max(c - 1, 0).
//
// What bounds it on an H100: 4*B*M*H operations on the bf16 tensor cores
// (10.7 GFLOP at B=10240, M=1024, H=256: ~11 us at 989 TFLOP/s) against
// ~23 MB of traffic (~7 us at 3.35 TB/s), so operations bound it.
//
// The simple design: every block owns one (64 x 64) output tile, so there
// are no atomics and the result is deterministic. Per 32-deep chunk the
// block decodes its int8 tile into two bf16 tiles in shared memory (0/1 are
// exact in bf16), rounds the f32 weight (forward) or dh (backward) tile to
// bf16 with round-to-nearest-even, and four warps run nvcuda::wmma 16x16x16
// bf16 products into f32 accumulators, each warp a 32 x 32 sub-tile. This is
// the numerics of the Pallas kernel (operands cast to bf16, f32
// accumulation). The forward loops each block over all items. The backward
// has only (M/64)(H/64) output tiles (64 on the flagship, for 132 SMs), so
// its student loop is split across blocks (grid z): each split writes its
// partial dW to a scratch buffer, and a second kernel sums the splits in
// split order, so the result stays deterministic. Both kernels issue the
// next chunk's global loads into registers before the current chunk's
// products. Plain WMMA from registers: wgmma, TMA and cp.async pipelines
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;      // output rows and columns per block
constexpr int TK = 32;        // contraction chunk staged per iteration
constexpr int THREADS = 128;  // 4 warps in a 2 x 2 grid of 32 x 32 tiles
constexpr int PAD = 8;        // bf16 row padding (keeps ldm % 8 == 0)
constexpr int CPAD = 4;       // f32 row padding of the output staging tile
static_assert(TK * TILE == 16 * THREADS, "16 tile values per thread");

__device__ __forceinline__ void decode(int8_t c, __nv_bfloat16* m,
                                       __nv_bfloat16* rm) {
  float f = static_cast<float>(c);
  *m = __float2bfloat16(fminf(f, 1.f));
  *rm = __float2bfloat16(fmaxf(f - 1.f, 0.f));
}

// Loads 16 consecutive codes of row `row` starting at column `col`, zero
// outside the (rows, cols) matrix.
__device__ __forceinline__ void load16(const int8_t* __restrict__ pk,
                                       int rows, int cols, int row, int col,
                                       bool vec, int8_t out[16]) {
  const int8_t* src = pk + static_cast<size_t>(row) * cols + col;
  if (vec && row < rows && col + 16 <= cols) {
    int4 q = *reinterpret_cast<const int4*>(src);
    const int8_t* v = reinterpret_cast<const int8_t*>(&q);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = v[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = (row < rows && col + i < cols) ? src[i] : int8_t(0);
  }
}

// Loads this thread's 16 values of the (TK x TILE) f32 tile of src
// (row-major, leading dimension cols) at (r0, c0) into registers, zero at
// rows >= rows_end or columns >= cols: four runs of four, each one float4
// when vec. put_bf16 stores them, rounded to bf16 (RNE), at the same places
// of the shared tile.
__device__ __forceinline__ void fetch_f32(const float* __restrict__ src,
                                          int rows_end, int cols, int r0,
                                          int c0, bool vec, float v[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int i = threadIdx.x + j * THREADS;
    int gr = r0 + i / (TILE / 4), gc = c0 + (i % (TILE / 4)) * 4;
    const float* at = src + static_cast<size_t>(gr) * cols + gc;
    if (vec && gr < rows_end && gc + 4 <= cols) {
      float4 q = *reinterpret_cast<const float4*>(at);
      v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z; v[4 * j + 3] = q.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[4 * j + t] = (gr < rows_end && gc + t < cols) ? at[t] : 0.f;
    }
  }
}

__device__ __forceinline__ void put_bf16(const float v[16],
                                         __nv_bfloat16 (*dst)[TILE + PAD]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int i = threadIdx.x + j * THREADS;
    int rr = i / (TILE / 4), cc = (i % (TILE / 4)) * 4;
#pragma unroll
    for (int t = 0; t < 4; ++t) dst[rr][cc + t] = __float2bfloat16(v[4 * j + t]);
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                            wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Writes the block's accumulators through shared memory to out (rows x cols,
// row-major, leading dimension cols) at (r0, c0), masking the ragged edge.
__device__ __forceinline__ void store_tile(FragC acc[2][2],
                                           float (*c_s)[TILE + CPAD],
                                           float* __restrict__ out, int rows,
                                           int cols, int r0, int c0, int wr,
                                           int wc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&c_s[wr + 16 * i][wc + 16 * j], acc[i][j],
                              TILE + CPAD, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    int r = i / TILE, c = i % TILE;
    int gr = r0 + r, gc = c0 + c;
    if (gr < rows && gc < cols) out[static_cast<size_t>(gr) * cols + gc] = c_s[r][c];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
first_layer_fwd_kernel(const int8_t* __restrict__ pk,
                       const float* __restrict__ wr,
                       const float* __restrict__ wm, float* __restrict__ h,
                       int B, int M, int H) {
  __shared__ __align__(128) __nv_bfloat16 rm_s[TILE][TK + PAD];
  __shared__ __align__(128) __nv_bfloat16 m_s[TILE][TK + PAD];
  __shared__ __align__(128) __nv_bfloat16 wr_s[TK][TILE + PAD];
  __shared__ __align__(128) __nv_bfloat16 wm_s[TK][TILE + PAD];
  __shared__ __align__(128) float c_s[TILE][TILE + CPAD];

  const int b0 = blockIdx.x * TILE, h0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wb = (warp / 2) * 32, wh = (warp % 2) * 32;
  const bool vec = (M % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(pk) % 16 == 0);
  const bool wvec = (H % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(wr) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(wm) % 16 == 0);

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // the next chunk's global loads are issued before this chunk's products
  // (register prefetch): int8 tile 64 students x 32 items, 16 codes per
  // thread, and the two 32 x 64 weight tiles
  const int cr = tid >> 1, cc = (tid & 1) * 16;
  int8_t code[16];
  float wrv[16], wmv[16];
  auto fetch = [&](int k0) {
    load16(pk, B, M, b0 + cr, k0 + cc, vec, code);
    fetch_f32(wr, M, H, k0, h0, wvec, wrv);
    fetch_f32(wm, M, H, k0, h0, wvec, wmv);
  };
  if (M > 0) fetch(0);
  for (int k0 = 0; k0 < M; k0 += TK) {
#pragma unroll
    for (int i = 0; i < 16; ++i) decode(code[i], &m_s[cr][cc + i], &rm_s[cr][cc + i]);
    put_bf16(wrv, wr_s);
    put_bf16(wmv, wm_s);
    __syncthreads();
    if (k0 + TK < M) fetch(k0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      FragA ar[2], am[2];
      FragB br[2], bm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ar[i], &rm_s[wb + 16 * i][kk], TK + PAD);
        wmma::load_matrix_sync(am[i], &m_s[wb + 16 * i][kk], TK + PAD);
        wmma::load_matrix_sync(br[i], &wr_s[kk][wh + 16 * i], TILE + PAD);
        wmma::load_matrix_sync(bm[i], &wm_s[kk][wh + 16 * i], TILE + PAD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], ar[i], br[j], acc[i][j]);
          wmma::mma_sync(acc[i][j], am[i], bm[j], acc[i][j]);
        }
    }
    __syncthreads();
  }
  store_tile(acc, c_s, h, B, H, b0, h0, wb, wh);
}

__global__ void __launch_bounds__(THREADS)
first_layer_bwd_kernel(const int8_t* __restrict__ pk,
                       const float* __restrict__ dh,
                       float* __restrict__ dwr, float* __restrict__ dwm,
                       float* __restrict__ part, int B, int M, int H,
                       int rows_per_split) {
  // split z covers students [s_begin, s_end); with a scratch buffer it
  // writes its partial sums to part[z] = (2, M, H), else straight to dW.
  // The decoded tiles are stored [student][item]: read as col-major (item x student)
  // A operands, i.e. the transposes rm^T and m^T
  __shared__ __align__(128) __nv_bfloat16 rm_s[TK][TILE + PAD];
  __shared__ __align__(128) __nv_bfloat16 m_s[TK][TILE + PAD];
  __shared__ __align__(128) __nv_bfloat16 dh_s[TK][TILE + PAD];
  __shared__ __align__(128) float c_s[TILE][TILE + CPAD];

  const int m0 = blockIdx.x * TILE, h0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm0 = (warp / 2) * 32, wh = (warp % 2) * 32;
  const bool vec = (M % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(pk) % 16 == 0);
  const bool dvec = (H % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(dh) % 16 == 0);
  const int s_begin = blockIdx.z * rows_per_split;
  const int s_end = min(B, s_begin + rows_per_split);
  if (part != nullptr) {
    const size_t mh = static_cast<size_t>(M) * H;
    dwr = part + (2 * static_cast<size_t>(blockIdx.z)) * mh;
    dwm = dwr + mh;
  }

  FragC acc_r[2][2], acc_m[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc_r[i][j], 0.f);
      wmma::fill_fragment(acc_m[i][j], 0.f);
    }

  // register prefetch as in the forward: int8 tile 32 students x 64 items,
  // 16 codes per thread, and the 32 x 64 dh tile (rounded to bf16 on store)
  const int cr = tid >> 2, cc = (tid & 3) * 16;
  int8_t code[16];
  float dhv[16];
  auto fetch = [&](int s0) {
    load16(pk, s_end, M, s0 + cr, m0 + cc, vec, code);
    fetch_f32(dh, s_end, H, s0, h0, dvec, dhv);
  };
  if (s_begin < s_end) fetch(s_begin);
  for (int s0 = s_begin; s0 < s_end; s0 += TK) {
#pragma unroll
    for (int i = 0; i < 16; ++i) decode(code[i], &m_s[cr][cc + i], &rm_s[cr][cc + i]);
    put_bf16(dhv, dh_s);
    __syncthreads();
    if (s0 + TK < s_end) fetch(s0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      FragAT ar[2], am[2];
      FragB bd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ar[i], &rm_s[kk][wm0 + 16 * i], TILE + PAD);
        wmma::load_matrix_sync(am[i], &m_s[kk][wm0 + 16 * i], TILE + PAD);
        wmma::load_matrix_sync(bd[i], &dh_s[kk][wh + 16 * i], TILE + PAD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc_r[i][j], ar[i], bd[j], acc_r[i][j]);
          wmma::mma_sync(acc_m[i][j], am[i], bd[j], acc_m[i][j]);
        }
    }
    __syncthreads();
  }
  store_tile(acc_r, c_s, dwr, M, H, m0, h0, wm0, wh);
  store_tile(acc_m, c_s, dwm, M, H, m0, h0, wm0, wh);
}

// dW_r, dW_m (M*H each) = sum over splits z of part[z], in split order.
__global__ void first_layer_bwd_reduce_kernel(const float* __restrict__ part,
                                              float* __restrict__ dwr,
                                              float* __restrict__ dwm,
                                              int splits, size_t mh) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < mh; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float r = 0.f, m = 0.f;
    for (int z = 0; z < splits; ++z) {
      r += part[(2 * static_cast<size_t>(z)) * mh + i];
      m += part[(2 * static_cast<size_t>(z) + 1) * mh + i];
    }
    dwr[i] = r;
    dwm[i] = m;
  }
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h (B, H) = decode(pk) @ (W_r, W_m); all row-major, contiguous.
int first_layer_fwd(const void* pk, const void* wr, const void* wm, void* h,
                    int B, int M, int H, void* stream) {
  if (B == 0 || H == 0) return 0;
  dim3 grid((B + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  first_layer_fwd_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pk), static_cast<const float*>(wr),
      static_cast<const float*>(wm), static_cast<float*>(h), B, M, H);
  return static_cast<int>(cudaGetLastError());
}

// dW_r, dW_m (M, H) = decode(pk)^T @ bf16(dh); all row-major, contiguous.
// The students are cut into `splits` runs of rows_per_split (a multiple of
// 32); with splits > 1, part is a (splits, 2, M, H) f32 scratch buffer and a
// second kernel sums it, with splits == 1 part may be null.
int first_layer_bwd(const void* pk, const void* dh, void* dwr, void* dwm,
                    void* part, int B, int M, int H, int splits,
                    int rows_per_split, void* stream) {
  if (M == 0 || H == 0) return 0;
  if (splits < 1 || rows_per_split % TK != 0 ||
      static_cast<long long>(splits) * rows_per_split < B ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = splits > 1 ? static_cast<float*>(part) : nullptr;
  dim3 grid((M + TILE - 1) / TILE, (H + TILE - 1) / TILE, splits);
  first_layer_bwd_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(pk), static_cast<const float*>(dh),
      static_cast<float*>(dwr), static_cast<float*>(dwm), scratch, B, M, H,
      rows_per_split);
  if (splits > 1) {
    size_t mh = static_cast<size_t>(M) * H;
    int blocks = static_cast<int>(std::min<size_t>((mh + 255) / 256, 4096));
    first_layer_bwd_reduce_kernel<<<blocks, 256, 0, s>>>(
        scratch, static_cast<float*>(dwr), static_cast<float*>(dwm), splits,
        mh);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
