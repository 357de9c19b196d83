// Fused int8 decode + matmul: the ability encoder's packed first layer, on
// Hopper's warpgroup tensor-core path (wgmma) fed by TMA.
//
// Replaces the TPU Pallas kernels of vibo_tpu/ops/pallas_encoder.py:
//   first_layer_fwd  <- _fwd_pallas (:142), body _fwd_kernel (:76)
//       h (B, H) f32 = rm @ W_r + m @ W_m
//   first_layer_bwd  <- _bwd_pallas (:167), body _bwd_kernel (:93)
//       dW_r (M, H) f32 = rm^T @ dh,  dW_m (M, H) f32 = m^T @ dh
// where the int8 code c (0 = missing, 1 = wrong, 2 = right; graded codes up
// to 1 + 31) decodes to m = min(c, 1) and rm = max(c - 1, 0), both exact in
// bf16. Each is ONE product of depth 2M: h = [rm | m] [W_r ; W_m] and
// [dW_r ; dW_m] = [rm | m]^T dh, so each step has one accumulator and one B
// stream. Two modes, each its own entry point:
//   bf16 (first_layer_fwd, first_layer_bwd): the weights (forward) or dh
//       (backward) rounded to bf16 with round-to-nearest-even, f32 sums: the
//       numerics of the Pallas kernel at compute_dtype=bfloat16;
//   f32 (first_layer_fwd_f32, first_layer_bwd_f32): exact f32 products on
//       the bf16 tensor cores. A finite f32 w splits exactly into three bf16
//       parts hi + mid + lo (split_parts below; its Python twin is
//       ops/pallas_encoder.py:split_bf16x3), and every product of a code
//       value with a part is exact in f32, so A W = A W_hi + A W_mid +
//       A W_lo: three wgmma a decoded A tile.
//
// What bounds it on an H100: 4 B M H operations on the bf16 tensor cores
// (10.7 GFLOP at B = 10,240, M = 1,024, H = 256: 10.9 us at 989 TFLOP/s;
// three times that in the f32 mode, 32.7 us) against ~23 MB of HBM traffic
// (~7 us): operations.
//
// The design.
// * Prologue (per call, a small transposing kernel): the f32 operand that
//   is not the code -- [W_r ; W_m] in the forward, dh in the backward -- is
//   rounded (or split) to bf16 ONCE a call and written transposed, K-major,
//   zero-padded: Wt (NP, Hp, 2 Mp) with the W_r^T block at columns [0, Mp)
//   and W_m^T at [Mp, 2 Mp), or dht (NP, Hp, Bp); Mp, Bp round M, B up to
//   the 64-deep chunk, Hp rounds H up to the 128-wide tile (ragged H and the
//   chunk tails read zeros), NP = 1 (bf16) or 3 (f32). Forward: 2 MB read,
//   1 MB (f32 mode 3 MB) written, where each block used to re-read and round
//   the f32 weights itself (~335 MB through L2 a call at the flagship).
//   Backward: dh is rounded in the prologue, not in the consumer: 10.5 MB
//   read and 5.2 MB written at the flagship (~4.7 us of HBM time; 15.7 MB in
//   the f32 mode), bought for a B operand that TMA can fetch as swizzled
//   K-major tiles.
// * Mainloop: a block of two warpgroups walks the contraction in chunks of
//   64 through a ring of STAGES shared-memory slots. The chunk's B tiles
//   (128 x 64 bf16 each, 128-byte swizzle) come by TMA, their bytes counted
//   on the slot's mbarrier; block thread 0 starts the first STAGES chunks,
//   and after that the second warpgroup to finish with a slot refills it
//   (a per-slot counter; a warpgroup has finished with it once all four of
//   its warps are past their wgmma wait, a barrier of the warpgroup). Each
//   warpgroup copies its own code tile (cp.async
//   of 16 bytes where the code's rows are 16-byte aligned, M % 16 == 0; of
//   4 bytes where M % 4 == 0; else plain byte loads: config 5 has M = 680,
//   the odd test shapes M = 301) and decodes its A fragments straight from
//   it into registers (the RS form of wgmma: no decoded tile is written),
//   then issues the chunk's wgmma m64n128k16 (B from shared memory through
//   a swizzle-128 descriptor). No barrier of the block couples the two
//   warpgroups in the loop, so one's decode overlaps the other's products.
//   Two variants of the loop (consume):
//   - bf16 (LEAN): one accumulator chained over the whole contraction and
//     one set of A fragments, 122 registers a thread, so two blocks (four
//     warpgroups) share an SM and hide one another's decode and loads. The
//     chain's sums stay within 1e-6 of the plain version's (the gate is
//     1e-4).
//   - f32: the tensor cores do not round their f32 accumulation to
//     nearest, so a chain over the whole contraction drifts with its
//     length (the bf16 loop, run in this mode in a probe over up to 20,480
//     students, came within 2x of the mode's 1e-5 gate); each chunk's
//     product goes to a fresh accumulator and is added into the running
//     sum with f32 adds, and the next chunk is decoded while the current
//     one runs. That takes two accumulators and two sets of A fragments
//     (236 registers): one block an SM.
//   No producer warp and no setmaxnreg: 288 threads cap a thread at 168
//   registers (the allocation rounds to whole warpgroups), and a version
//   with a producer warp spilled.
// * Forward tile: 128 students (64 a warpgroup) x 128 columns. At the
//   flagship (10,240 x 256) that is 80 x 2 = 160 tiles; at two blocks an SM
//   (bf16) all are resident at once on 132 SMs, 28 of them holding two.
//   128 x 256 gives 80 tiles, 0.6 of a wave, and 2 x 128 accumulator
//   registers would leave one block an SM; 64 x 128 gives 320 tiles but
//   reads every weight tile twice as often (164 MB through L2 instead of
//   84 MB, and the weight tiles' L2 traffic already bounds the loop more
//   than the tensor cores do). Config 5 (5,520 x 680, H = 256): 44 x 2 =
//   88 tiles, under one wave.
// * Backward tile: 64 items x 128 columns, warpgroup 0 the W_r half and
//   warpgroup 1 the W_m half (they share the dh tile; each copies the code
//   tile). There are only 16 x 2 = 32 such tiles at the flagship, so a
//   thread-block cluster of SPLITS = 8 CTAs splits the students of one tile
//   (256 CTAs, two an SM in the bf16 mode); the CTAs stage their sums in
//   their own shared memory and each sums an eighth of the tile over the
//   cluster's ranks in rank order through distributed shared memory. No
//   partial goes through HBM (the former design wrote and re-read a 19 MB
//   split buffer) and nothing uses float atomics. Both directions, in both
//   modes, give the same bits at every launch on one input
//   (chip_smoke.py launches each FIRST_LAYER_REPEATS times).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from
                   // the driver at run time, so nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;     // two warpgroups
constexpr int BK = 64;           // contraction chunk a stage
constexpr int BN = 128;          // output columns a tile (wgmma N)
constexpr int FWD_BM = 128;      // students a forward tile, 64 a warpgroup
constexpr int BWD_BM = 64;       // items a backward tile (both halves)
constexpr int SPLITS = 8;        // backward cluster: CTAs a tile
constexpr int CODE_LD = 80;      // code tile row stride (bytes): 16-byte
                                 // aligned, conflict-free fragment reads
constexpr int B_TILE = BN * BK * 2;   // one swizzled bf16 B tile (bytes)
constexpr int RED_LD = BN + 4;        // backward staging row stride (floats)

// LEAN (bf16): two blocks an SM, one accumulator chained over the
// contraction; else (f32 mode: 1e-5 of the exact products) a fresh
// accumulator a chunk and one block an SM.
template <int NP>
struct Fwd {
  static constexpr bool LEAN = NP == 1;
  static constexpr int BLOCKS = LEAN ? 2 : 1;   // blocks an SM
  static constexpr int STAGES = 2;
  static constexpr int CODE = FWD_BM * CODE_LD;
  static constexpr int STAGE = 2 * NP * B_TILE + CODE;   // B tiles first
  static constexpr int SMEM = STAGES * STAGE + 1024;     // + 1 KB alignment
  static constexpr uint32_t TX = 2 * NP * B_TILE;        // TMA bytes a stage
  static_assert(STAGE % 1024 == 0, "swizzle-128 tiles need 1 KB alignment");
  static_assert(SMEM * BLOCKS <= 232448 - 1024 * BLOCKS, "shared memory");
};

template <int NP>
struct Bwd {
  static constexpr bool LEAN = NP == 1;
  static constexpr int BLOCKS = LEAN ? 2 : 1;
  static constexpr int STAGES = NP == 1 ? 4 : 3;
  static constexpr int CODE = 2 * BK * CODE_LD;          // a copy a warpgroup
  static constexpr int STAGE = NP * B_TILE + CODE;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static constexpr uint32_t TX = NP * B_TILE;
  static_assert(STAGE % 1024 == 0, "swizzle-128 tiles need 1 KB alignment");
  static_assert(SMEM * BLOCKS <= 232448 - 1024 * BLOCKS, "shared memory");
  static_assert(STAGES * STAGE >= 2 * BWD_BM * RED_LD * 4, "reduce staging");
};

// ---- the exact split (f32 mode) and bf16 rounding (bf16 mode) ----------

__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// NP = 1: x rounded to bf16 (nearest even). NP = 3: the exact three-way
// split of a finite f32, each part cut by truncation (the f32's low 16 bits
// dropped): hi = trunc(x), mid = trunc(x - hi), lo = trunc(x - hi - mid),
// every subtraction exact. x == hi + mid + lo whenever x's lowest set bit
// is at least 2^-133 (bf16's subnormal spacing): every normal |x| >= 2^-110
// and 0; below that the parts drop x's bits under 2^-133. Truncation never
// overflows (f32's largest value keeps a finite hi).
template <int NP>
__device__ __forceinline__ void split_parts(float x, __nv_bfloat16 (&out)[NP]) {
  if constexpr (NP == 1) {
    out[0] = __float2bfloat16_rn(x);
  } else {
    const float hi = trunc_bf16(x), r1 = x - hi;
    const float mid = trunc_bf16(r1), lo = trunc_bf16(r1 - mid);
    out[0] = __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(hi) >> 16));
    out[1] = __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(mid) >> 16));
    out[2] = __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(lo) >> 16));
  }
}

// ---- PTX: mbarriers, TMA, cp.async, wgmma --------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
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
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

// One 2-d TMA box (c0 inner, c1 outer) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(saddr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(saddr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Barrier of the 128 threads of warpgroup wg (ids 1, 2; 0 is the block's).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}


// Matrix descriptor of a K-major bf16 tile of 64-element (128-byte) rows
// written by TMA with 128-byte swizzle, 1 KB aligned: leading offset unused
// (1), stride offset 1,024 bytes (8 rows), layout SWIZZLE_128B. A k step of
// 16 elements adds 32 bytes (2 in 16-byte units) to the start address.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = saddr(tile);
  return ((a >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of r across the
// asynchronous wgmma that reads and writes it.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x 128 f32, the warpgroup's accumulator fragment) = A B + (scale_d ?
// d : 0), A (64 x 16 bf16) in registers (a: this thread's fragment), B
// (16 x 128) K-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The code's halves: rm = max(c - 1, 0) (half 0), m = min(c, 1) (half 1).
__device__ __forceinline__ float decode_code(int c, int half) {
  return static_cast<float>(half ? min(c, 1) : max(c - 1, 0));
}

// A warpgroup's share of a chunk's code tile: ROWS x BK codes of the int8
// code (rows of M bytes) at (row0, col0) into dst (row stride CODE_LD),
// zero at rows >= row_end or columns >= M, copied by the warpgroup's 128
// threads, one cp.async group a thread. The reader is 16 (cp.async of 16
// bytes: rows 16-byte aligned), 4 (cp.async of 4 bytes: rows 4-byte
// aligned) or 1 (byte loads: any M).
template <int ROWS>
__device__ __forceinline__ void load_codes(int8_t* dst,
                                           const int8_t* __restrict__ pk,
                                           long long M, int row0, int row_end,
                                           int col0, int reader) {
  const int tid = threadIdx.x % 128;
  if (reader == 16) {
    for (int i = tid; i < ROWS * (BK / 16); i += 128) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = row0 + r < row_end && col0 + c < M;
      cp_async16(dst + r * CODE_LD + c,
                 ok ? pk + (row0 + r) * M + col0 + c : pk, ok ? 16 : 0);
    }
  } else if (reader == 4) {
    for (int i = tid; i < ROWS * (BK / 4); i += 128) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool ok = row0 + r < row_end && col0 + c < M;
      cp_async4(dst + r * CODE_LD + c,
                ok ? pk + (row0 + r) * M + col0 + c : pk, ok ? 4 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * BK; i += 128) {
      const int r = i / BK, c = i % BK;
      dst[r * CODE_LD + c] = row0 + r < row_end && col0 + c < M
                                 ? __ldg(pk + (row0 + r) * M + col0 + c)
                                 : int8_t(0);
    }
  }
  cp_async_commit();
}

// The ring's aligned base in the dynamic shared memory.
__device__ __forceinline__ unsigned char* ring_base(unsigned char* smem) {
  const uint32_t a = saddr(smem);
  return smem + ((1024 - (a & 1023)) & 1023);
}

// Keeps the A-fragment registers of a register-sourced wgmma allocated up
// to this point, after the wait: ptxas ends a register's live range at its
// last read in the program, the wgmma instruction, and may hand it to the
// next chunk's decode while the tensor cores still read it (on an H100,
// backward sums a few per cent wrong at random without this). An empty asm does not keep it, a
// self-move is deleted; this is a real read under a branch that is never
// taken (decoded codes are non-negative, so no fragment has its sign bits
// set and the OR is never all ones).
template <int NA>
__device__ __forceinline__ void keep_live(uint32_t (&a)[NA]) {
  __shared__ uint32_t sink;
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    reg_fence(a[i]);
    any |= a[i];
  }
  if (any == 0xFFFFFFFFu)
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(saddr(&sink)), "r"(any)
                 : "memory");
}

// The ring's shared state: full[s] completes when the TMA bytes of the
// chunk in slot s have landed; done[s] counts the warpgroups that finished
// with the slot, and the second of each round refills its B tiles.
template <int STAGES>
struct Ring {
  uint64_t full[STAGES];
  uint32_t done[STAGES];
};

// One consumer warpgroup over the nchunks chunks. The two warpgroups share
// the B tiles and run decoupled: no barrier of the block in the loop (a
// warpgroup's own barrier before it releases a slot). Each
// warpgroup copies its own code tiles. LEAN: decode a chunk, run its
// wgmma into acc, wait. Else chunk c + 1 is decoded while the tensor cores
// run chunk c, and each chunk's product goes to a fresh accumulator
// (`part`, the chunk's first wgmma at scale 0) added into acc with f32
// adds.
//   tma(c):        arm full[c % STAGES] and start chunk c's B tiles;
//   codes(c):      copy this warpgroup's code tile of chunk c (one
//                  cp.async group a thread, empty past the last chunk);
//   decode(c, a):  chunk c's NA A-fragment registers from its code tile;
//   mma(c, a, d, fresh): issue chunk c's wgmma into d (fresh: its first
//                  overwrites d).
// The block's thread 0 starts the first STAGES chunks' B tiles before the
// block barrier that precedes this loop.
template <bool LEAN, int STAGES, int NA, class Tma, class Codes,
          class Decode, class Mma>
__device__ __forceinline__ void consume(Ring<STAGES>& ring, int nchunks,
                                        Tma&& tma, Codes&& codes,
                                        Decode&& decode, Mma&& mma,
                                        float (&acc)[64]) {
  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;
  if constexpr (LEAN) {
    // one accumulator chained over the whole contraction and one set of A
    // fragments: few enough registers for two blocks an SM, whose four
    // warpgroups overlap one another's decode and products
    uint32_t a[NA];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int c = 0; c < STAGES; ++c) codes(c);
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<STAGES - 1>();  // chunk c's codes: this thread's
      wg_sync(wg);                  // and the warpgroup's
      mbar_wait(&ring.full[c % STAGES], (c / STAGES) & 1);
      decode(c, a);
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
      wgmma_fence();
      mma(c, a, acc, false);
      wgmma_commit();
      wgmma_wait0();
      keep_live(a);
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
      wg_sync(wg);  // every warp's share of chunk c done (see below)
      codes(c + STAGES);
      if (leader && c + STAGES < nchunks &&
          atomicAdd(&ring.done[c % STAGES], 1u) % 2 == 1)
        tma(c + STAGES);
    }
    return;
  }
  float part[64];
  uint32_t a[NA], an[NA];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int c = 0; c < STAGES; ++c) codes(c);
  if (nchunks == 0) return;
  cp_async_wait<STAGES - 1>();  // chunk 0's codes: this thread's
  wg_sync(wg);                  // and the warpgroup's
  mbar_wait(&ring.full[0], 0);
  decode(0, a);
#pragma unroll
  for (int i = 0; i < 64; ++i) reg_fence(part[i]);
  wgmma_fence();
  mma(0, a, part, true);
  wgmma_commit();
  for (int c = 0; c < nchunks; ++c) {
    const bool more = c + 1 < nchunks;
    if (more) {  // chunk c + 1, decoded while chunk c runs
      cp_async_wait<STAGES - 2>();
      wg_sync(wg);
      mbar_wait(&ring.full[(c + 1) % STAGES], ((c + 1) / STAGES) & 1);
      decode(c + 1, an);
    }
    wgmma_wait0();
    keep_live(a);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      reg_fence(part[i]);
      acc[i] += part[i];
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < NA; ++i) a[i] = an[i];
      wgmma_fence();
      mma(c + 1, a, part, true);
      wgmma_commit();
    }
    // slot c % STAGES: a warp's wgmma wait covers its own 16 rows only, so
    // the warpgroup's barrier makes sure all four warps' shares of chunk c
    // have completed (and read the slot's B tiles) before the leader
    // counts the warpgroup done with them; else a lagging warp's last
    // wgmma may read a tile the next chunk's TMA is overwriting. Then
    // refill this warpgroup's code tile, and the B tiles once both
    // warpgroups are done with them
    wg_sync(wg);
    codes(c + STAGES);
    if (leader && c + STAGES < nchunks &&
        atomicAdd(&ring.done[c % STAGES], 1u) % 2 == 1)
      tma(c + STAGES);
  }
}

// h (B, H) = [rm | m] (B, 2M) x Wt^T, Wt (NP, Hp, 2 Mp) bf16 through wmap.
template <int NP>
__global__ void __launch_bounds__(THREADS, Fwd<NP>::BLOCKS)
first_layer_fwd_kernel(const __grid_constant__ CUtensorMap wmap,
                       const int8_t* __restrict__ pk, float* __restrict__ h,
                       int B, int M, int H, int Mp, int Hp, int reader) {
  using C = Fwd<NP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) Ring<C::STAGES> bars;
  unsigned char* ring = ring_base(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int b0 = blockIdx.x * FWD_BM, n0 = blockIdx.y * BN;
  const int nchunks = Mp / BK;

  auto slot = [&](int c) { return ring + (c % C::STAGES) * C::STAGE; };
  auto tma = [&](int c) {
    uint64_t* bar = &bars.full[c % C::STAGES];
    mbar_expect_tx(bar, C::TX);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(slot(c) + (half * NP + p) * B_TILE, &wmap, bar,
                 half * Mp + c * BK, p * Hp + n0);
  };
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&bars.full[s], 1);
      bars.done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < C::STAGES && c < nchunks; ++c) tma(c);
  }
  __syncthreads();

  // this warpgroup's 64 rows of the code tile
  auto codes = [&](int c) {
    if (c < nchunks)
      load_codes<64>(reinterpret_cast<int8_t*>(slot(c) + 2 * NP * B_TILE) +
                         wg * 64 * CODE_LD,
                     pk, M, b0 + wg * 64, B, c * BK, reader);
    else
      cp_async_commit();
  };
  // A fragments of both halves for the chunk's 4 k steps, a[(kk*2+half)*4
  // + r]: rows g, g + 8 of the warp's 16, columns 2t, 2t + 1 (r = 0, 1) and
  // 2t + 8, 2t + 9 (r = 2, 3) of each 16
  auto decode = [&](int c, uint32_t(&a)[32]) {
    const int8_t* code =
        reinterpret_cast<const int8_t*>(slot(c) + 2 * NP * B_TILE) +
        (wg * 64 + wq * 16 + g) * CODE_LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int8_t* q = code + kk * 16;
      const char2 v0 = *reinterpret_cast<const char2*>(q);
      const char2 v1 = *reinterpret_cast<const char2*>(q + 8 * CODE_LD);
      const char2 v2 = *reinterpret_cast<const char2*>(q + 8);
      const char2 v3 = *reinterpret_cast<const char2*>(q + 8 * CODE_LD + 8);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t* f = a + (kk * 2 + half) * 4;
        f[0] = pack_bf16(decode_code(v0.x, half), decode_code(v0.y, half));
        f[1] = pack_bf16(decode_code(v1.x, half), decode_code(v1.y, half));
        f[2] = pack_bf16(decode_code(v2.x, half), decode_code(v2.y, half));
        f[3] = pack_bf16(decode_code(v3.x, half), decode_code(v3.y, half));
      }
    }
  };
  // fresh: the chunk's first wgmma overwrites d
  auto mma = [&](int c, const uint32_t(&a)[32], float(&d)[64], bool fresh) {
    unsigned char* st = slot(c);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs(d, a + (kk * 2 + half) * 4,
                   desc_sw128(st + (half * NP + p) * B_TILE) + 2 * kk,
                   !fresh || kk + half + p > 0);
  };
  float acc[64];
  consume<C::LEAN, C::STAGES, 32>(bars, nchunks, tma, codes, decode, mma,
                                  acc);

  // accumulator fragment: value 4i + 2hh + e at row g + 8hh, column
  // 8i + 2t + e of the warp's 16 x 128
  const bool vec = H % 2 == 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = n0 + 8 * i + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = b0 + wg * 64 + wq * 16 + g + 8 * hh;
      if (row >= B || col >= H) continue;
      float* dst = h + static_cast<size_t>(row) * H + col;
      if (vec) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      } else {
        dst[0] = acc[4 * i + 2 * hh];
        if (col + 1 < H) dst[1] = acc[4 * i + 2 * hh + 1];
      }
    }
  }
}

// [dW_r ; dW_m] tile (items i0 .., columns n0 ..) = [rm | m]^T dh over the
// cluster's students: CTA z of the cluster takes students [z rows_per_split,
// (z + 1) rows_per_split); dht (NP, Hp, Bp) bf16 through dmap.
template <int NP>
__global__ void __cluster_dims__(1, 1, SPLITS)
    __launch_bounds__(THREADS, Bwd<NP>::BLOCKS)
first_layer_bwd_kernel(const __grid_constant__ CUtensorMap dmap,
                       const int8_t* __restrict__ pk, float* __restrict__ dwr,
                       float* __restrict__ dwm, int B, int M, int H, int Hp,
                       int rows_per_split, int reader) {
  using C = Bwd<NP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) Ring<C::STAGES> bars;
  unsigned char* ring = ring_base(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int i0 = blockIdx.x * BWD_BM, n0 = blockIdx.y * BN;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int s_begin = rank * rows_per_split;
  const int s_end = min(B, s_begin + rows_per_split);
  const int nchunks = s_begin < s_end ? (s_end - s_begin + BK - 1) / BK : 0;

  auto slot = [&](int c) { return ring + (c % C::STAGES) * C::STAGE; };
  auto tma = [&](int c) {
    uint64_t* bar = &bars.full[c % C::STAGES];
    mbar_expect_tx(bar, C::TX);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(slot(c) + p * B_TILE, &dmap, bar, s_begin + c * BK,
               p * Hp + n0);
  };
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&bars.full[s], 1);
      bars.done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < C::STAGES && c < nchunks; ++c) tma(c);
  }
  __syncthreads();

  // this warpgroup's own copy of the chunk's code tile (both decode all of
  // it, each its half)
  auto code_tile = [&](int c) {
    return reinterpret_cast<int8_t*>(slot(c) + NP * B_TILE) +
           wg * BK * CODE_LD;
  };
  auto codes = [&](int c) {
    if (c < nchunks)
      load_codes<BK>(code_tile(c), pk, M, s_begin + c * BK, s_end, i0,
                     reader);
    else
      cp_async_commit();
  };
  // A = the code tile transposed: A[item r][student k] = code[k][r], item
  // rows g, g + 8 of the warp's 16, students 2t, 2t + 1, 2t + 8, 2t + 9 of
  // each 16, a[kk*4 + r]; warpgroup wg decodes its half
  auto decode = [&](int c, uint32_t(&a)[16]) {
    const int8_t* code = code_tile(c) + 2 * t * CODE_LD + wq * 16 + g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int8_t* q = code + kk * 16 * CODE_LD;
      a[kk * 4 + 0] = pack_bf16(decode_code(q[0], wg),
                                decode_code(q[CODE_LD], wg));
      a[kk * 4 + 1] = pack_bf16(decode_code(q[8], wg),
                                decode_code(q[CODE_LD + 8], wg));
      a[kk * 4 + 2] = pack_bf16(decode_code(q[8 * CODE_LD], wg),
                                decode_code(q[9 * CODE_LD], wg));
      a[kk * 4 + 3] = pack_bf16(decode_code(q[8 * CODE_LD + 8], wg),
                                decode_code(q[9 * CODE_LD + 8], wg));
    }
  };
  // fresh: the chunk's first wgmma overwrites d
  auto mma = [&](int c, const uint32_t(&a)[16], float(&d)[64], bool fresh) {
    unsigned char* st = slot(c);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs(d, a + kk * 4, desc_sw128(st + p * B_TILE) + 2 * kk,
                 !fresh || kk + p > 0);
  };
  float acc[64];
  consume<C::LEAN, C::STAGES, 16>(bars, nchunks, tma, codes, decode, mma,
                                  acc);

  // every CTA stages its sums [half][item][column] in its own ring (all its
  // TMA loads have landed and been read), then sums an eighth of the tile
  // over the cluster's ranks in rank order
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* dst = red + (wg * BWD_BM + wq * 16 + g + 8 * hh) * RED_LD +
                   8 * i + 2 * t;
      dst[0] = acc[4 * i + 2 * hh];
      dst[1] = acc[4 * i + 2 * hh + 1];
    }
  cluster.sync();
  constexpr int PER = 2 * BWD_BM * BN / SPLITS;
  for (int e = rank * PER + tid; e < (rank + 1) * PER; e += THREADS) {
    const int half = e / (BWD_BM * BN), r = (e / BN) % BWD_BM, n = e % BN;
    const int off = (half * BWD_BM + r) * RED_LD + n;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < SPLITS; ++q) sum += cluster.map_shared_rank(red, q)[off];
    const int item = i0 + r, col = n0 + n;
    if (item < M && col < H)
      (half ? dwm : dwr)[static_cast<size_t>(item) * H + col] = sum;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// dst[p][c][off + r] = part p of src[r][c] (src (R, C) f32 row-major), zero
// at r >= R or c >= C, for r < 32 gridDim.x and c < 32 gridDim.y; dst is
// (NP, Cp, ld) bf16. Grid z picks src0 (off 0) or src1 (off off1).
template <int NP>
__global__ void prep_kernel(const float* __restrict__ src0,
                            const float* __restrict__ src1,
                            __nv_bfloat16* __restrict__ dst, int R, int C,
                            int Cp, long long ld, long long off1) {
  __shared__ float tile[32][33];
  const float* src = blockIdx.z ? src1 : src0;
  const long long off = blockIdx.z ? off1 : 0;
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int y = threadIdx.y; y < 32; y += blockDim.y) {
    const int r = r0 + y, c = c0 + threadIdx.x;
    tile[y][threadIdx.x] =
        r < R && c < C ? src[static_cast<size_t>(r) * C + c] : 0.f;
  }
  __syncthreads();
  for (int y = threadIdx.y; y < 32; y += blockDim.y) {
    const int c = c0 + y, r = r0 + threadIdx.x;
    __nv_bfloat16 parts[NP];
    split_parts<NP>(tile[threadIdx.x][y], parts);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      dst[(static_cast<size_t>(p) * Cp + c) * ld + off + r] = parts[p];
  }
}

// ---- host ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (outer, inner) bf16 matrix read in (BN x BK) boxes
// with 128-byte swizzle. inner % 64 == 0 keeps the rows 16-byte aligned.
cudaError_t make_map(CUtensorMap* map, const void* base, long long inner,
                     long long outer) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The code reader is valid for these rows: 16 and 4 need rows aligned.
bool reader_ok(const void* pk, int M, int reader) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(pk);
  if (reader == 16) return M % 16 == 0 && a % 16 == 0;
  if (reader == 4) return M % 4 == 0 && a % 4 == 0;
  return reader == 1;
}

template <int NP>
int fwd_entry(const void* pk, const void* wr, const void* wm, void* wt,
              void* h, int B, int M, int H, int reader, void* stream) {
  if (B < 0 || M < 0 || H < 0 || !reader_ok(pk, M, reader) ||
      reinterpret_cast<uintptr_t>(wt) % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0)
    return static_cast<int>(cudaMemsetAsync(
        h, 0, static_cast<size_t>(B) * H * sizeof(float), s));
  const int Mp = round_up(M, BK), Hp = round_up(H, BN);
  prep_kernel<NP><<<dim3(Mp / 32, Hp / 32, 2), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(wr), static_cast<const float*>(wm),
      static_cast<__nv_bfloat16*>(wt), M, H, Hp, 2LL * Mp, Mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  if ((err = make_map(&map, wt, 2LL * Mp, static_cast<long long>(NP) * Hp)) !=
      cudaSuccess)
    return static_cast<int>(err);
  auto kernel = first_layer_fwd_kernel<NP>;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Fwd<NP>::SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  kernel<<<dim3((B + FWD_BM - 1) / FWD_BM, Hp / BN), THREADS, Fwd<NP>::SMEM,
           s>>>(map, static_cast<const int8_t*>(pk), static_cast<float*>(h), B,
                M, H, Mp, Hp, reader);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int bwd_entry(const void* pk, const void* dh, void* dht, void* dwr, void* dwm,
              int B, int M, int H, int rows_per_split, int reader,
              void* stream) {
  if (B < 0 || M < 0 || H < 0 || !reader_ok(pk, M, reader) ||
      reinterpret_cast<uintptr_t>(dht) % 128 != 0 || rows_per_split < BK ||
      rows_per_split % BK != 0 ||
      static_cast<long long>(SPLITS) * rows_per_split < B)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) {
    const size_t bytes = static_cast<size_t>(M) * H * sizeof(float);
    cudaError_t err = cudaMemsetAsync(dwr, 0, bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dwm, 0, bytes, s);
    return static_cast<int>(err);
  }
  const int Bp = round_up(B, BK), Hp = round_up(H, BN);
  prep_kernel<NP><<<dim3(Bp / 32, Hp / 32, 1), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(dh), nullptr,
      static_cast<__nv_bfloat16*>(dht), B, H, Hp, Bp, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  if ((err = make_map(&map, dht, Bp, static_cast<long long>(NP) * Hp)) !=
      cudaSuccess)
    return static_cast<int>(err);
  auto kernel = first_layer_bwd_kernel<NP>;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Bwd<NP>::SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  kernel<<<dim3((M + BWD_BM - 1) / BWD_BM, Hp / BN, SPLITS), THREADS,
           Bwd<NP>::SMEM, s>>>(map, static_cast<const int8_t*>(pk),
                               static_cast<float*>(dwr),
                               static_cast<float*>(dwm), B, M, H, Hp,
                               rows_per_split, reader);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vibo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h (B, H) f32 = decode(pk) @ (W_r, W_m); pk (B, M) int8, wr and wm (M, H)
// f32, row-major and contiguous; wt a bf16 scratch of NP * Hp * 2 Mp
// elements (NP = 1, Mp = M rounded up to 64, Hp = H rounded up to 128),
// 128-byte aligned; reader 16, 4 or 1 (the code reader, valid for pk).
int first_layer_fwd(const void* pk, const void* wr, const void* wm, void* wt,
                    void* h, int B, int M, int H, int reader, void* stream) {
  return fwd_entry<1>(pk, wr, wm, wt, h, B, M, H, reader, stream);
}

// As first_layer_fwd with exact f32 products (NP = 3 in wt).
int first_layer_fwd_f32(const void* pk, const void* wr, const void* wm,
                        void* wt, void* h, int B, int M, int H, int reader,
                        void* stream) {
  return fwd_entry<3>(pk, wr, wm, wt, h, B, M, H, reader, stream);
}

// dW_r, dW_m (M, H) f32 = decode(pk)^T @ bf16(dh); dh (B, H) f32; dht a
// bf16 scratch of NP * Hp * Bp elements (Bp = B rounded up to 64), 128-byte
// aligned; the students are cut into 8 runs of rows_per_split (a multiple
// of 64, 8 runs covering B), one a CTA of the cluster.
int first_layer_bwd(const void* pk, const void* dh, void* dht, void* dwr,
                    void* dwm, int B, int M, int H, int rows_per_split,
                    int reader, void* stream) {
  return bwd_entry<1>(pk, dh, dht, dwr, dwm, B, M, H, rows_per_split, reader,
                      stream);
}

// As first_layer_bwd with exact f32 products (NP = 3 in dht).
int first_layer_bwd_f32(const void* pk, const void* dh, void* dht, void* dwr,
                        void* dwm, int B, int M, int H, int rows_per_split,
                        int reader, void* stream) {
  return bwd_entry<3>(pk, dh, dht, dwr, dwm, B, M, H, rows_per_split, reader,
                      stream);
}

}  // extern "C"
