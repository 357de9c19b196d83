// The tile mapping and the item split the one-pass training logliks share
// (loglik_train.cu for the binary links, loglik_categorical.cuh for the
// polytomous families) with the masked loglik's forward and VJP
// (masked_loglik.cu), and the second pass that sums their partials. cp_async16
// serves a tile's table copied a tile ahead (the compile-time GRM's slots).
//
// The grid is (student blocks, item splits; the masked loglik's third
// dimension its samples). Block (x, y) owns the TBS = 64 students x * TBS ..
// and the item tiles y * tps .. (y + 1) * tps - 1 of TMI = 64 items each; the
// host's plan (ops/one_pass.py split_plan) picks the number of splits so that
// a large matrix gives about four blocks an SM (two resident at a time), and
// no split is empty (check_plan refuses any other plan). Before the split, a
// block walked all items and the flagship's 160 blocks left most SMs with one
// block of 8 warps.
//
// Inside a block: NWARP = 16 warps, a warp takes SPT = 4 students, a lane IPT
// = 2 consecutive items, so a warp reads 64 contiguous bytes of each student's
// code row and a thread covers 8 cells a tile. What bounds the blocks an SM
// holds is the register file: the kernels are held to 64 registers a thread at
// small K (two blocks, 32 warps an SM), and keep only a lane's per-item sums
// in registers across a tile. A cell reads its item's a and link constants
// from shared memory in 16-byte loads (load_consts), and a student's dtheta
// and ll, summed over the lane's items, are added into lane-private shared
// slots once a tile (add_student); at the end a warp sums its students' slots
// over the lanes by shuffles into the split's partial (write_dtheta_ll); the
// 2PL training kernel and the masked forward instead keep a lane's item
// constants and each student's sums in registers (loglik_train.cu,
// masked_loglik.cu). The next tile's codes (a 16-bit word a student) and item
// data are loaded into registers a tile ahead, so their latency, the code's
// from device memory above all, hides behind the cells. A tile's per-item sums
// go through shared memory in two barriers (staging visible; per-warp sums
// visible; the 2PL training kernel: one, double buffered), and each column sum
// over the 16 warps is the block's partial for that item: every item sits in
// exactly one split, so that partial is (student blocks, items) as before the
// split.
//
// The second pass (sum_rows_kernel) sums every partial over its rows in a
// fixed order: 32 columns a block, 8 row groups each summing a strided run
// of rows, then the 8 group sums in order. No float atomics: every output is
// deterministic.
//
// K beyond the instantiated widths 1..8 (the wide variant): the kernel is
// instantiated at K = KC and run once for every chunk [k0, k0 + KC) of the
// kt ability dims. Each pass recomputes the whole logit with wide_dot (a
// run-time loop over kt, theta and a read from global memory, where the
// tile's a rows sit in L1), stages and accumulates only its chunk's theta,
// dtheta and da, and writes ll, db and the link's other per-item gradients
// in its first pass (k0 == 0) alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vibo {

constexpr int NWARP = 16;
constexpr int THREADS = NWARP * 32;
constexpr int SPT = 4;                 // students per warp (and per thread)
constexpr int TBS = NWARP * SPT;        // students per block
constexpr int IPT = 2;                  // consecutive items per lane
constexpr int TMI = 32 * IPT;           // items per tile
constexpr int KC = 8;                   // ability dims a wide pass covers

// Blocks an SM the binary links' kernels (loglik_train.cu,
// masked_loglik.cu) are built for: two of 16 warps (64 registers a thread)
// up to K = 4, one above.
template <int K>
constexpr int min_blocks() {
  return K <= 4 ? 2 : 1;
}

// The slot of tile item j in a staged row: lane-major, p * 32 + lane, so a
// warp's reads of its lanes' items never conflict.
__host__ __device__ __forceinline__ int slot_of(int j) {
  return (j % IPT) * 32 + j / IPT;
}

// A plan of the host's: B students in ceil(B / TBS) blocks, the
// ceil(M / TMI) item tiles in nsplit runs of tps (the last may be shorter,
// none empty; M = 0 is one empty split).
__host__ inline bool check_plan(int B, int M, int nblk, int nsplit, int tps) {
  const int ntiles = (M + TMI - 1) / TMI;
  if (nblk != (B + TBS - 1) / TBS || nsplit < 1 || tps < 1) return false;
  if (ntiles == 0) return nsplit == 1;
  return static_cast<long long>(nsplit) * tps >= ntiles &&
         static_cast<long long>(nsplit - 1) * tps < ntiles;
}

// N per-item constants of a slot from shared memory (16-byte aligned when
// N % 4 == 0), read at each use: the volatile loads are neither merged
// across a lane's cells nor hoisted out of its student loop, so the
// constants cost no registers between cells.
template <int N>
__device__ __forceinline__ void load_consts(const float* src,
                                            float (&out)[N]) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(src));
  int x = 0;
#pragma unroll
  for (; x + 4 <= N; x += 4)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(out[x]), "=f"(out[x + 1]), "=f"(out[x + 2]),
                   "=f"(out[x + 3])
                 : "r"(addr + 4 * x));
#pragma unroll
  for (; x < N; ++x)
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(out[x]) : "r"(addr + 4 * x));
}

// 16 bytes from device memory into shared memory without passing through
// registers (cp.async, global and shared addresses 16-byte aligned); the
// thread waits for its copies with cp_async_wait_all, and a barrier after
// that makes them visible to the block.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// theta . a_j over all kt ability dims (the wide variant's logit).
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

// Floats a slot of the staged a takes: K, rounded up to a multiple of 4
// from K = 4 on, so a cell reads its item's a in 16-byte loads.
__host__ __device__ constexpr int a_stride(int K) {
  return K < 4 ? K : (K + 3) / 4 * 4;
}

// The tile's a rows (dims k0 .. k0 + K - 1 of kt) into a_s, a_stride(K)
// floats a slot (slot_of), zero past M and kt.
template <int K>
__device__ __forceinline__ void stage_items(float* a_s, const float* a,
                                            int m0, int M, int k0, int kt) {
  for (int i = threadIdx.x; i < TMI * K; i += THREADS) {
    const int j = i / K, k = i % K, gj = m0 + j;
    a_s[slot_of(j) * a_stride(K) + k] =
        gj < M && k0 + k < kt ? a[static_cast<size_t>(gj) * kt + k0 + k]
                              : 0.f;
  }
}

// This thread's float of a contiguous run of n <= THREADS floats, 0 past
// it: a tile's item data, loaded a tile ahead into one register.
__device__ __forceinline__ float prefetch1(const float* __restrict__ src,
                                          int n) {
  const int i = threadIdx.x;
  return i < n ? __ldg(src + i) : 0.f;
}

// The tile's a (TMI x K, prefetched by prefetch1 from a + m0 * K) into a_s
// as stage_items lays it out; the zeros past M stay zeros.
template <int K>
__device__ __forceinline__ void store_items(float* a_s, float v) {
  static_assert(TMI * K <= THREADS, "one prefetched a value a thread");
  const int i = threadIdx.x;
  if (i < TMI * K) a_s[slot_of(i / K) * a_stride(K) + i % K] = v;
}

// The IPT = 2 codes of student gs at items gj, gj + 1 as one word (byte p
// is item gj + p), 0 outside the (B, M) code; vec: the rows are 2-byte
// aligned (M even). One register a student, so a tile's codes can be
// loaded a tile ahead.
static_assert(IPT == 2, "a code word holds two items");
__device__ __forceinline__ uint32_t load_code_pair(
    const int8_t* __restrict__ pk, int gs, int gj, int B, int M, bool vec) {
  const int8_t* row = pk + static_cast<size_t>(gs) * M + gj;
  if (gs < B && vec && gj + IPT <= M)
    return *reinterpret_cast<const uint16_t*>(row);
  uint32_t w = 0;
  if (gs < B && gj < M) w = static_cast<uint8_t>(row[0]);
  if (gs < B && gj + 1 < M) w |= static_cast<uint32_t>(
      static_cast<uint8_t>(row[1])) << 8;
  return w;
}

__device__ __forceinline__ int code_at(uint32_t w, int p) {
  return static_cast<int8_t>((w >> (8 * p)) & 0xffu);
}

// The warp's SPT students' dtheta (K) and ll accumulate in shared slots,
// acc_w[(q * (K + 1) + c) * LANES + lane] of the warp's SPT * (K + 1) *
// LANES floats: a student's sums over the lane's items are added once a
// tile, so nothing of a student stays in registers past its cells. LANES =
// 32: a slot per lane; LANES = 16: lanes l and l + 16 add their sum first
// (half the shared memory, for the kernels whose reduce rows are large).
template <int K, int LANES = 32>
__device__ __forceinline__ void add_student(float* acc_w, int q,
                                            const float (&dq)[K], float lq) {
  const int lane = threadIdx.x & 31;
  float* row = acc_w + q * (K + 1) * LANES + lane;
#pragma unroll
  for (int c = 0; c <= K; ++c) {
    float v = c < K ? dq[c] : lq;
    if constexpr (LANES == 16) v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (LANES == 32 || lane < 16) row[c * LANES] += v;
  }
}

// Sums each of the warp's SPT students' dtheta and ll over the slots; lane
// 0 writes dtheta into the split's partial part_dth (nsplit, B, kt) at the
// dims k0 .. k0 + K - 1 of kt, and ll into part_llp (nsplit, B) when not
// null. Returns the warp's sum of ll over its students.
template <int K, int LANES = 32>
__device__ __forceinline__ float write_dtheta_ll(
    const float* acc_w, int s_warp, int B, float* part_dth, float* part_llp,
    int k0 = 0, int kt = K) {
  const int lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * B;
  float ll_warp = 0.f;
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int gs = s_warp + q;
#pragma unroll
    for (int c = 0; c <= K; ++c) {
      float v = lane < LANES ? acc_w[(q * (K + 1) + c) * LANES + lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (c == K) ll_warp += v;  // every lane holds the sum
      if (lane != 0 || gs >= B) continue;
      if (c < K) {
        if (k0 + c < kt) part_dth[(row0 + gs) * kt + k0 + c] = v;
      } else if (part_llp != nullptr) {
        part_llp[row0 + gs] = v;
      }
    }
  }
  return ll_warp;
}

// One partial of the second pass: out column i (0 <= i < n) is the sum of
// src[r * n + i] over the rows r = 0 .. rows - 1 in a fixed order, written
// at dst[(i / inner) * d_outer + (i % inner) * d_inner] (a strided
// (n / inner, inner) output, e.g. dtheta through its strides).
struct SumSeg {
  const float* src;
  float* dst;
  long long n;
  int rows, inner;
  long long d_outer, d_inner;
};

constexpr int MAX_SEGS = 6;
constexpr int SUM_COLS = 32, SUM_GROUPS = 8;

struct SumSegs {
  SumSeg seg[MAX_SEGS];
  long long first_block[MAX_SEGS + 1];  // block index where each seg starts
  int nseg;
};

// A block sums SUM_COLS columns of one segment (a segment of one column, a
// scalar, takes one block whose 256 threads split its rows).
__global__ void __launch_bounds__(SUM_COLS * SUM_GROUPS)
sum_rows_kernel(SumSegs segs) {
  __shared__ float part_s[SUM_GROUPS * SUM_COLS];
  const long long bid = blockIdx.x;
  int g = 0;
  while (g + 1 < segs.nseg && bid >= segs.first_block[g + 1]) ++g;
  const SumSeg& sg = segs.seg[g];
  const int tx = threadIdx.x % SUM_COLS, ty = threadIdx.x / SUM_COLS;
  if (sg.n == 1) {  // a scalar: every thread a strided run of rows
    float v = 0.f;
    for (int r = threadIdx.x; r < sg.rows; r += SUM_COLS * SUM_GROUPS)
      v += sg.src[r];
    part_s[threadIdx.x] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int t = 0; t < SUM_COLS * SUM_GROUPS; ++t) s += part_s[t];
      sg.dst[0] = s;
    }
    return;
  }
  const long long i = (bid - segs.first_block[g]) * SUM_COLS + tx;
  float v = 0.f;
  if (i < sg.n)
    for (int r = ty; r < sg.rows; r += SUM_GROUPS) v += sg.src[r * sg.n + i];
  part_s[ty * SUM_COLS + tx] = v;
  __syncthreads();
  if (ty == 0 && i < sg.n) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < SUM_GROUPS; ++y) s += part_s[y * SUM_COLS + tx];
    sg.dst[(i / sg.inner) * sg.d_outer + (i % sg.inner) * sg.d_inner] = s;
  }
}

// Launches a kernel of this mapping (THREADS threads a block) on grid with
// smem bytes of dynamic shared memory, raising the kernel's limit first
// where smem is past the default 48 KB.
template <class... Params, class... Args>
__host__ cudaError_t launch_tiled(void (*kernel)(Params...), dim3 grid,
                                  size_t smem, cudaStream_t stream,
                                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Registers, local (spill) bytes and blocks an SM of the kernel fn of this
// mapping with smem bytes of dynamic shared memory, into out[0..2].
__host__ inline int occupancy_of(const void* fn, size_t smem, int* out) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(err);
}

// Launches the second pass over the segments (nseg <= MAX_SEGS; segments of
// no column are skipped).
__host__ inline cudaError_t launch_sum_rows(const SumSeg* segs, int nseg,
                                            cudaStream_t stream) {
  SumSegs s{};
  long long blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    if (segs[i].n <= 0) continue;
    if (s.nseg == MAX_SEGS) return cudaErrorInvalidValue;
    s.seg[s.nseg] = segs[i];
    s.first_block[s.nseg] = blocks;
    blocks += segs[i].n == 1 ? 1 : (segs[i].n + SUM_COLS - 1) / SUM_COLS;
    ++s.nseg;
  }
  s.first_block[s.nseg] = blocks;
  if (blocks == 0) return cudaSuccess;
  sum_rows_kernel<<<static_cast<unsigned>(blocks), SUM_COLS * SUM_GROUPS, 0,
                    stream>>>(s);
  return cudaGetLastError();
}

}  // namespace vibo
