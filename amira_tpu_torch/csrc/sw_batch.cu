// Banded two-piece-affine Smith-Waterman for a batch of DNA alignment jobs:
// the DP (sw_dp) and the traceback walk (sw_traceback), hand-written for
// Hopper (sm_90a) and bound to PyTorch through a plain C interface (ctypes,
// see amira_tpu_torch/ops/sw_batch.py, which also holds the plain PyTorch
// versions both kernels are tested against).
//
// sw_dp replaces the TPU kernel `_sw_batch_kernel_body` of
// amira_tpu/ops/pallas_sw_batch.py (launched by `_pallas_sw_core`), which is
// bit-identical to the XLA scan `_banded_sw_batch_core` of
// amira_tpu/ops/align.py. sw_traceback replaces `_traceback_batch`
// (amira_tpu/ops/align.py) as the Pallas path's `_traceback_stage` ran it.
//
// Semantics (all exact integer arithmetic, identical to the JAX package):
//   scores MATCH 2, MISMATCH -4; gaps are two-piece affine: a gap of g costs
//   min(6 + 2(g-1), 25 + (g-1)). Band lane w of query row i is reference
//   column j = i + dlo + w; the reference byte sits at
//   rs[b, i + dlo + W + Lq + w] (the caller pads the reference by W + Lq on
//   the left with code 4). Code 4 means "no reference here".
//   One traceback byte per cell: bits 0-2 M predecessor (0 local start,
//   1 M, 2 I, 3 D, 4 I2, 5 D2), bits 3-6 extend flags of I/D/I2/D2, bit 7
//   query==reference.
//   Best cell: strictly greater score than every earlier row; within a row
//   the first (lowest) lane with the row maximum.
//
// sw_dp design: one warp per job, no block barrier and no shared memory.
//   * A block holds kDpWarps = 4 independent warps, the fastest of 1, 2 and
//     4 on an H100 at the main path's large launches, (B, Lq) = (980, 1024)
//     and (490, 1024), and at B = 128..2048, Lq = 2048 (PERF.md). Lane l owns
//     the strip of band lanes w = l*S + s, s < S = W/32 (W = 64 to 512),
//     and keeps its previous-row state in registers. The row loop stops at
//     the job's query length: rows past it are dead (all-NEG) in the
//     reference, can neither raise the best nor be reached by the
//     traceback, and are not written. A ragged last block's spare warps
//     return at once.
//   * The row-state choice of row i (the first of M, I, D, I2, D2 holding
//     the cell's maximum, the nested `>=` of the reference) is the diagonal
//     input of row i+1 (its value and M-predecessor code), so it runs once
//     per cell. It is the max of five unsigned codes
//     max(x, 0) << (log2 W + 3) | priority, lane bits (W-1-w) << 3 added
//     after: clamping at 0 is exact because M >= 0 in the reference. That
//     code is carried to the next row and is also the cell's row-max key.
//   * Insertions read band lane w+1 of the previous row: the thread's own
//     element s+1, or lane l+1's element 0 through one __shfl_down_sync per
//     carried quantity (M - OPEN, M - OPEN2, I - EXT, I2 - EXT2); each max
//     with its extend bit is __vibmax_s32.
//   * Deletions: D[w] = max_{w0<w} M[w0] - OPEN - (w-1-w0)*EXT, clamped to
//     NEG, on the masked M and the unmasked D (the sequential form
//     D[w] = max(D[w-1] - EXT, M[w-1] - OPEN, NEG) is the same, as the
//     clamp commutes: NEG - EXT < NEG). Each cell takes the max of the
//     carry from earlier lanes, an exclusive max of M + w*EXT from a 5-step
//     __shfl_up_sync scan of the strips' maxima, and its candidate from
//     earlier elements of its own strip (a running max computed before the
//     scan), one __viaddmax_s32 each: no chain along the strip after the
//     scan. D2 likewise with its constants.
//   * The row maximum is one __reduce_max_sync over the cell codes: the
//     largest holds the row maximum at its lowest lane, which is the
//     reference's tie rule, with that cell's state. A row whose maximum is
//     0 can never raise `best` (it starts at 0 and only a strictly greater
//     value replaces it). The wrapper refuses 2*Lq >= 2^(29 - log2 W),
//     where the score field could overflow (2^21 at W = 256).
//   * The reference window slides one byte per row: each strip shifts by
//     one code, takes lane l+1's old first code by shuffle, and lane 31
//     loads one new byte, prefetched a row ahead with the query byte.
//   * Each thread packs its S traceback bytes into one store, so a warp
//     writes one coalesced W-byte row of the (B, Lq, W) uint8 layout.
//   * At W = 512 (S = 16, the assembly's polishing band) a thread keeps 16
//     lanes of each carried quantity in registers, twice W = 256's; ptxas's
//     report (chip_smoke.py phase 1) says whether that instance spills.
//
// What bounds sw_dp on this card: at (B, Lq, W) = (512, 2048, 256) with
// query lengths 1536-2048 it has about 233 M live cells. Writing one
// traceback byte per cell is 0.070 ms at 3.35 TB/s; the recurrence needs 39
// int32 operations per cell, counted from the plain version with a DPX
// operation as one (chip_smoke.py SW_DP_OPS_PER_CELL), 0.54 ms at 132 SMs x
// 64 int32 lanes x 1.98 GHz. So it is bound by integer issue. This kernel
// issues more: its row-state codes cost about 16 operations per cell, and
// ptxas emits about 73 instructions per cell (a max with its predicate is a
// compare and a select), nearly all on the integer pipe. Against the earlier
// block-per-job kernel (thread = band lane) this design removes the three
// __syncthreads per row, the shared-memory round trips for neighbouring
// lanes, the per-cell scan and the warp-total pass (the scan now runs once
// per strip), and the second pass of the state chain (shared by the row
// state and the next row's diagonal).
//
// sw_traceback walks each job's traceback bytes from the best cell, emitting
// =/X/I/D as 2-bit codes packed 4 per byte in step order (the JAX walk's
// layout), and zero-fills the rest of its row. A step reads the byte of its
// cell and moves by the current state alone: M to (i-1, w), I and I2 to
// (i-1, w+1), D and D2 to (i, w-1); the byte gives the next state. Reads
// are clamped to the band (row min(i, Lq-1), lane clamp(w, 0, W-1)).
//
// What bounds sw_traceback on this card: its bytes and operations are tiny
// (about 1,000 steps per job at Lq = 1024; under a microsecond at the
// roofline). Each job is one serial chain of steps, and where a step reads
// depends on the step before, so the time is set by the longest walk. The
// earlier kernel (one thread per job) paid a device-memory latency per step
// (0.69 ms at (B, Lq) = (980, 1024) on an H100, PERF.md): the DP has just
// written a band several times the size of the L2.
//
// sw_traceback design: one warp per job (kTbWarps = 4 per block, so the main
// path's B = 980 spreads over every SM), the walk's bytes in shared memory,
// and a run of steps at a time.
//   * A run: while the walk keeps its state, every step moves the same way
//     (M down a lane, I and I2 down and one lane up, D and D2 one lane
//     down). Lane j reads the cell of step n + j as if the state held, from
//     shared memory; two ballots find the first cell outside the staged
//     tile (not taken) and the first that leaves the state (M through a
//     predecessor other than 1, 6, 7; a gap state through a clear extend
//     bit; taken, and its byte gives the next state). So one iteration takes
//     up to 32 steps: about 16 on the main path's walks, whose runs end at
//     indels and at tile edges.
//   * A tile is kTbRows query rows by a window of kTbWin band lanes around
//     the walk's lane, aligned to 16 bytes and clipped to the band, copied
//     by the warp with 16-byte cp.async copies, one commit group per tile.
//     Each warp has a ring of kTbTiles tiles: the one the walk reads and the
//     next rows below it, same window, in flight. A walk that leaves its
//     tile through the bottom enters the oldest tile in flight and starts
//     the copy of the next one into the slot it left. A walk that leaves the window
//     sideways (a long run of insertions or deletions) stages the ring anew
//     at its (i, w) and waits for the first tile: a re-stage, counted in a
//     device counter (sw_traceback_restages()). A cell outside the band
//     (w < 0, w >= W, i >= Lq) is one step on the clamped cell, read from
//     device memory. The result is exact in every case; only speed depends
//     on where the walk goes.
//   * Each step's 2-bit op goes into a ring of kTbOps bytes in shared
//     memory; every 256 steps (and at the end, masked past the walk) 16
//     lanes pack 16 ops each into one word of the output row. The warp then
//     zero-fills the rest of the row.
//   * No __syncthreads: only __syncwarp, the ballots and the copy waits.
//   The constants were chosen by timing on an H100 at the main path's
//   (B, Lq) = (980, 1024) and (490, 1024) and at (512, 2048) (PERF.md): a
//   ring of 2, 4, 8, 16 tiles, 16 to 128 rows, 16 to 64 lanes, 2 to 8
//   warps per block. It is now bound by the slowest walk's chain of
//   dependent iterations (about 100-130 at Lq = 1024 for a gappy walk), not
//   by memory: the same walk over a band already in L2 is no faster.
//
// Neither kernel allocates or synchronises; both launch on the stream they
// are given, and each launcher returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kMatch = 2;
constexpr int kMismatch = -4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 2;
constexpr int kGapOpen2 = 25;
constexpr int kGapExt2 = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDpWarps = 4;  // jobs (warps) per block of sw_dp
constexpr int kTbWarps = 4;   // jobs (warps) per block of sw_traceback
constexpr int kTbRows = 64;   // query rows per traceback tile
constexpr int kTbWin = 32;    // band lanes per traceback tile (at most W)
constexpr int kTbTiles = 4;   // tiles per warp: the walk's, and those below it in flight
constexpr int kTbOps = 512;   // ops staged per warp before packing: two blocks of 256

constexpr int kOpEq = 0;
constexpr int kOpX = 1;
constexpr int kOpI = 2;
constexpr int kOpD = 3;

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// max(a, b) and the predicate a >= b (DPX)
__device__ __forceinline__ int bmax(int a, int b, bool& ge) {
  return __vibmax_s32(a, b, &ge);
}

// the cell-state code of one component: max(x, 0) << V | priority
template <int V>
__device__ __forceinline__ unsigned enc(int x, unsigned prio) {
  return (unsigned)__vimax_s32_relu(x, 0) * (1u << V) + prio;
}

template <int S>
__global__ void __launch_bounds__(kDpWarps * 32)
    sw_dp_kernel(const uint8_t* __restrict__ qs, const uint8_t* __restrict__ rs,
                 const int32_t* __restrict__ qlens,
                 const int32_t* __restrict__ dlos, int B, int Lq, int Lr,
                 uint8_t* __restrict__ tb, int32_t* __restrict__ best_out,
                 int32_t* __restrict__ bi_out, int32_t* __restrict__ bw_out,
                 int32_t* __restrict__ bs_out) {
  constexpr int W = 32 * S;
  constexpr int kVal = log2i(W) + 3;     // score field of an encoded cell
  constexpr unsigned kPos = 1u << kVal;  // encoded cells >= kPos score > 0

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kDpWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a ragged last block's spare warps
  const int qlen = min(max(qlens[b], 0), Lq);
  const int dlo = dlos[b];
  const uint8_t* q = qs + (size_t)b * Lq;
  const uint8_t* r = rs + (size_t)b * Lr;
  const int w0 = lane * S;
  uint8_t* tbl = tb + (size_t)b * Lq * W + w0;

  // Previous-row state of the strip: rc the reference codes of the current
  // row; e the encoded row state (0 for virtual row -1 and for cells out of
  // the reference, whose score and predecessor can never count); the
  // insertion inputs the next row reads (M - OPEN, M - OPEN2, I - EXT,
  // I2 - EXT2, masked).
  int rc[S], mo[S], mo2[S], ie[S], i2e[S];
  unsigned e[S];
  const long long rbase = (long long)dlo + W + Lq + w0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long ri = rbase + s;
    rc[s] = (ri >= 0 && ri < Lr) ? r[ri] : 4;
    e[s] = 0;
    mo[s] = -kGapOpen;
    mo2[s] = -kGapOpen2;
    ie[s] = kNeg - kGapExt;
    i2e[s] = kNeg - kGapExt2;
  }
  // deletion carry offsets of the strip's first lane, scan bases, key base
  const int c0 = -kGapOpen - (w0 - 1) * kGapExt;
  const int c02 = -kGapOpen2 - (w0 - 1) * kGapExt2;
  const int abase = w0 * kGapExt, a2base = w0 * kGapExt2;
  const unsigned lbase = (unsigned)(W - 1 - w0) << 3;
  const long long rlast = (long long)dlo + W + Lq + (W - 1);  // lane W-1, row 0
  int best = 0, bi = -1, bw = -1, bs = 0;
  int qc = qlen > 0 ? q[0] : 0;

  for (int i = 0; i < qlen; ++i) {
    // prefetch of row i+1's query byte and the band's new reference byte
    const int qn = i + 1 < Lq ? q[i + 1] : 0;
    const long long rn_idx = rlast + i + 1;
    int rn = 4;
    if (lane == 31 && rn_idx >= 0 && rn_idx < Lr) rn = r[rn_idx];

    // insertion inputs of element S-1: lane l+1's element 0 (band lane
    // W-1 reads M = I = I2 = NEG)
    int mo_u = __shfl_down_sync(kFull, mo[0], 1);
    int mo2_u = __shfl_down_sync(kFull, mo2[0], 1);
    int ie_u = __shfl_down_sync(kFull, ie[0], 1);
    int i2e_u = __shfl_down_sync(kFull, i2e[0], 1);
    if (lane == 31) {
      mo_u = kNeg - kGapOpen;
      mo2_u = kNeg - kGapOpen2;
      ie_u = kNeg - kGapExt;
      i2e_u = kNeg - kGapExt2;
    }

    // pass 1: diagonal (M) and vertical (I, I2) moves; within the strip the
    // deletion candidates from earlier elements (t) and the strip maxima of
    // A = M + w*EXT for the scan
    int Mc[S], Iv[S], I2v[S], t[S], t2[S];
    unsigned bits[S];
    int pre = 0, pre2 = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool in_ref = rc[s] != 4;
      const bool eq = rc[s] == qc;
      // max(prev_best, 0) + score
      const int mdiag = (int)(e[s] >> kVal) + (eq ? kMatch : kMismatch);
      const unsigned mbits = (e[s] >= kPos && mdiag > 0) ? (~e[s] & 7u) : 0u;
      Mc[s] = in_ref ? max(mdiag, 0) : kNeg;
      const int mou = s + 1 < S ? mo[s + 1] : mo_u;
      const int mo2u = s + 1 < S ? mo2[s + 1] : mo2_u;
      const int ieu = s + 1 < S ? ie[s + 1] : ie_u;
      const int i2eu = s + 1 < S ? i2e[s + 1] : i2e_u;
      bool ib, i2b;
      Iv[s] = bmax(ieu, mou, ib);
      I2v[s] = bmax(i2eu, mo2u, i2b);
      ie[s] = in_ref ? Iv[s] - kGapExt : kNeg - kGapExt;
      i2e[s] = in_ref ? I2v[s] - kGapExt2 : kNeg - kGapExt2;
      mo[s] = Mc[s] - kGapOpen;
      mo2[s] = Mc[s] - kGapOpen2;
      bits[s] = mbits | (ib ? 8u : 0u) | (i2b ? 32u : 0u) | (eq ? 128u : 0u);
      if (s == 0) {
        t[0] = kNeg;
        t2[0] = kNeg;
        pre = Mc[0];
        pre2 = Mc[0];
      } else {
        t[s] = __viaddmax_s32(pre, -kGapOpen - (s - 1) * kGapExt, kNeg);
        t2[s] = __viaddmax_s32(pre2, -kGapOpen2 - (s - 1) * kGapExt2, kNeg);
        pre = __viaddmax_s32(Mc[s], s * kGapExt, pre);
        pre2 = __viaddmax_s32(Mc[s], s * kGapExt2, pre2);
      }
    }

    // exclusive prefix max of A (and A2) over the lanes before this strip
    int a = pre + abase, a2 = pre2 + a2base;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      // lanes below `off` get their own value back: max is unchanged
      a = max(a, __shfl_up_sync(kFull, a, off));
      a2 = max(a2, __shfl_up_sync(kFull, a2, off));
    }
    int ea = __shfl_up_sync(kFull, a, 1);
    int ea2 = __shfl_up_sync(kFull, a2, 1);
    if (lane == 0) {
      ea = kNeg;
      ea2 = kNeg;
    }
    const int x0 = ea + c0, x02 = ea2 + c02;

    // pass 2: deletions (unmasked D, D2), each cell from the carry and its
    // strip candidate; the encoded row state and the strip's best key
    unsigned key = 0;
    int Dp = 0, D2p = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int D = __viaddmax_s32(x0, -s * kGapExt, t[s]);
      const int D2 = __viaddmax_s32(x02, -s * kGapExt2, t2[s]);
      if (s > 0) {
        bits[s] |= (Dp - kGapExt >= mo[s - 1] ? 16u : 0u) |
                   (D2p - kGapExt2 >= mo2[s - 1] ? 64u : 0u);
      }
      Dp = D;
      D2p = D2;
      // max(x, 0) << kVal | priority: the largest code is the largest
      // score, ties to M, I, D, I2, D2 in that order (the nested `>=`).
      // Clamping at 0 is exact: M >= 0 in the reference, so a cell's
      // maximum is >= 0, and at 0 it is M's.
      const unsigned eM = (unsigned)Mc[s] * (1u << kVal) + 6u;
      const unsigned eI = enc<kVal>(Iv[s], 5u);
      const unsigned eD = enc<kVal>(D, 4u);
      const unsigned eI2 = enc<kVal>(I2v[s], 3u);
      const unsigned eD2 = enc<kVal>(D2, 2u);
      const unsigned ec = max(max(eM, eI), max(eD, max(eI2, eD2)));
      e[s] = rc[s] != 4 ? ec + (lbase - 8u * s) : 0u;
      key = max(key, e[s]);
    }
    // deletion bits of element 0 compare against lane l-1's element S-1
    // (band lane 0 reads D = M = NEG: both bits set)
    const int Dl = __shfl_up_sync(kFull, Dp, 1);
    const int D2l = __shfl_up_sync(kFull, D2p, 1);
    const int Ml = __shfl_up_sync(kFull, Mc[S - 1], 1);
    const bool db0 = lane == 0 || Dl - kGapExt >= Ml - kGapOpen;
    const bool d2b0 = lane == 0 || D2l - kGapExt2 >= Ml - kGapOpen2;
    bits[0] |= (db0 ? 16u : 0u) | (d2b0 ? 64u : 0u);

    // one store of the strip's S traceback bytes
    uint8_t* row = tbl + (size_t)i * W;
    if constexpr (S == 2) {
      *reinterpret_cast<uint16_t*>(row) = (uint16_t)(bits[0] | (bits[1] << 8));
    } else {
      uint32_t words[S / 4];
#pragma unroll
      for (int g = 0; g < S / 4; ++g)
        words[g] = bits[4 * g] | (bits[4 * g + 1] << 8) |
                   (bits[4 * g + 2] << 16) | (bits[4 * g + 3] << 24);
      if constexpr (S == 4) {
        *reinterpret_cast<uint32_t*>(row) = words[0];
      } else if constexpr (S == 8) {
        *reinterpret_cast<uint2*>(row) = make_uint2(words[0], words[1]);
      } else {
        *reinterpret_cast<uint4*>(row) = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }

    // row maximum: the largest key holds the best score at its lowest lane,
    // with that cell's state
    const unsigned rk = __reduce_max_sync(kFull, key);
    const int rv = (int)(rk >> kVal);
    if (rv > best) {
      best = rv;
      bi = i;
      bw = W - 1 - (int)((rk >> 3) & (W - 1));
      bs = 6 - (int)(rk & 7u);
    }

    // slide the reference window one column for row i+1
    const int rin = __shfl_down_sync(kFull, rc[0], 1);
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) rc[s] = rc[s + 1];
    rc[S - 1] = lane == 31 ? rn : rin;
    qc = qn;
  }
  if (lane == 0) {
    best_out[b] = best;
    bi_out[b] = bi;
    bw_out[b] = bw;
    bs_out[b] = bs;
  }
}

// 16-byte asynchronous copy from device to shared memory, and its groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// first band lane of the tile window that holds lane w (0 <= w < W): kWin
// lanes around w, aligned to 16 bytes, inside the band
template <int W, int kWin>
__device__ __forceinline__ int tile_window(int w) {
  return min(max((w - kWin / 2 + 8) & ~15, 0), W - kWin);
}

// The warp's copies of one tile: rows base .. base + kTbRows - 1 (those
// >= 0) of band lanes c0 .. c0 + kWin - 1, row base + k at tile + k * kWin.
template <int W, int kWin>
__device__ __forceinline__ void stage_tile(uint8_t* tile, const uint8_t* t,
                                           int base, int c0, int lane) {
  constexpr int kChunks = kWin / 16;  // 16-byte chunks per row
  static_assert(kWin % 16 == 0 && kTbRows * kChunks % 32 == 0,
                "whole 16-byte chunks, the same count for every lane");
#pragma unroll
  for (int j = 0; j < kTbRows * kChunks / 32; ++j) {
    const int k = j * 32 + lane;
    const int r = base + k / kChunks;
    if (r >= 0) cp_async16(tile + k * 16, t + (size_t)r * W + c0 + (k % kChunks) * 16);
  }
}

// the four 2-bit ops in the low bits of the four bytes of x, as one byte
// (the bytes' other bits may be anything: a staged op past the walk's end)
__device__ __forceinline__ unsigned pack4(unsigned x) {
  x &= 0x03030303u;
  return (x | x >> 6 | x >> 12 | x >> 18) & 0xffu;
}

// Packs block `blk` (256 steps) of a walk's staged ops into 16 words of its
// packed row, with zeros for steps at or past n. Whole warp.
__device__ __forceinline__ void flush_ops(uint32_t* out, const uint8_t* ops,
                                          int blk, int n, int n_words,
                                          int lane) {
  __syncwarp();
  if (lane < 16) {
    const int p = blk * 256 + lane * 16;  // the word's first step
    const uint4 v = *reinterpret_cast<const uint4*>(ops + (p & (kTbOps - 1)));
    unsigned word = pack4(v.x) | pack4(v.y) << 8 | pack4(v.z) << 16 | pack4(v.w) << 24;
    if (p + 16 > n) word &= n > p ? (1u << (2 * (n - p))) - 1u : 0u;
    if (blk * 16 + lane < n_words) out[blk * 16 + lane] = word;
  }
  __syncwarp();
}

// re-stages of all sw_traceback launches (see sw_traceback_restages)
__device__ unsigned long long g_tb_restages = 0;

template <int W>
__global__ void __launch_bounds__(kTbWarps * 32)
    sw_traceback_kernel(const uint8_t* __restrict__ tb,
                        const int32_t* __restrict__ best,
                        const int32_t* __restrict__ bi,
                        const int32_t* __restrict__ bw,
                        const int32_t* __restrict__ bs,
                        const int32_t* __restrict__ dlos, int B, int Lq,
                        int max_steps, uint8_t* __restrict__ packed,
                        int32_t* __restrict__ n_steps, int32_t* __restrict__ q0,
                        int32_t* __restrict__ r0) {
  constexpr int kWin = kTbWin < W ? kTbWin : W;
  constexpr int kTile = kTbRows * kWin;
  static_assert((kTbTiles & (kTbTiles - 1)) == 0 && kTbTiles >= 2, "a ring of 2^k tiles");
  extern __shared__ __align__(16) uint8_t tb_smem[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kTbWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a ragged last block's spare warps
  uint8_t* tiles = tb_smem + (threadIdx.x >> 5) * (kTbTiles * kTile + kTbOps);
  uint8_t* ops = tiles + kTbTiles * kTile;
  const uint8_t* t = tb + (size_t)b * Lq * W;
  uint32_t* out = reinterpret_cast<uint32_t*>(packed + (size_t)b * (max_steps / 4));
  const int n_words = max_steps / 16;

  int i = bi[b], w = bw[b], state = bs[b];
  int n = 0;
  if (best[b] > 0 && i >= 0 && max_steps > 0) {
    // The walk reads tile `cur` (slot cur % kTbTiles): rows base .. base +
    // kTbRows - 1 of lanes c0 .. c0 + kWin - 1. Tiles cur + 1 .. cur +
    // kTbTiles - 1 (the rows below, same lanes) are in flight, one copy
    // group each, oldest first.
    int cur = 0, base = INT_MIN, c0 = 0;
    bool staged = false;
    for (;;) {
      const bool is_m = state == 0;
      const bool is_i = state == 1 || state == 3;
      const int di = is_m || is_i ? 1 : 0;
      const int dw = is_i ? 1 : (state == 2 || state == 4) ? -1 : 0;
      // Lane j reads the cell of step n + j if the walk stays in this state
      // until then: (i - j*di, w + j*dw), when it is in the tile.
      const int ij = i - lane * di;
      const unsigned ri = (unsigned)ij - (unsigned)base;
      const unsigned wi = (unsigned)(w + lane * dw) - (unsigned)c0;
      const bool inside = ri < (unsigned)kTbRows && wi < (unsigned)kWin && ij >= 0 &&
                          n + lane < max_steps;
      const int byte = inside ? tiles[(cur & (kTbTiles - 1)) * kTile + ri * kWin + wi] : 0;
      const int pred = byte & 7;
      const int ebit = is_m ? 7 : state == 1 ? 3 : state == 2 ? 4 : state == 3 ? 5 : 6;
      const int e = (byte >> ebit) & 1;
      // M stays M through predecessors 1, 6 and 7; a gap state while its
      // extend bit is set. The run ends at the first cell outside the tile
      // (not taken) or the first that leaves the state (taken).
      const bool stays = is_m ? pred == 1 || pred >= 6 : e != 0;
      const unsigned outside = __ballot_sync(kFull, !inside);
      const unsigned leaves = __ballot_sync(kFull, inside && !stays);
      const unsigned stops = outside | leaves;
      const int first = stops ? __ffs(stops) - 1 : 32;
      const bool left = (leaves & stops & (0u - stops)) != 0;
      const int k = first + (left ? 1 : 0);  // steps taken
      int op = is_m ? (byte >> 7 ? kOpEq : kOpX) : is_i ? kOpI : kOpD;
      int nstate = state;
      bool done = false;
      if (k > 0) {
        const int lpred = __shfl_sync(kFull, pred, first & 31);
        if (left) {
          nstate = is_m ? ((unsigned)(lpred - 1) < 5u ? lpred - 1 : 0) : 0;
          done = is_m && lpred == 0;
        }
        if (lane < k) ops[(n + lane) & (kTbOps - 1)] = (uint8_t)op;
      } else if (i < Lq && (unsigned)w < (unsigned)W) {
        // The walk's cell is not in its tile: enter the tile below, or
        // stage anew at (i, w) when the walk left the window (or starts).
        if (staged && (unsigned)i - ((unsigned)base - kTbRows) < (unsigned)kTbRows &&
            (unsigned)w - (unsigned)c0 < (unsigned)kWin) {
          cp_async_wait<kTbTiles - 2>();
          __syncwarp();
          ++cur;
          base -= kTbRows;
          // the slot just left takes the tile kTbTiles - 1 below
          stage_tile<W, kWin>(tiles + ((cur - 1) & (kTbTiles - 1)) * kTile, t,
                              base - (kTbTiles - 1) * kTbRows, c0, lane);
          cp_async_commit();
        } else {
          if (staged && lane == 0) atomicAdd(&g_tb_restages, 1ull);
          staged = true;
          cp_async_wait<0>();
          __syncwarp();
          cur = 0;
          base = i - kTbRows + 1;
          c0 = tile_window<W, kWin>(w);
#pragma unroll 1
          for (int s = 0; s < kTbTiles; ++s) {
            stage_tile<W, kWin>(tiles + s * kTile, t, base - s * kTbRows, c0, lane);
            cp_async_commit();
          }
          cp_async_wait<kTbTiles - 1>();
        }
        __syncwarp();
        continue;
      } else {
        // a cell outside the band: one step on the clamped cell, read from
        // device memory
        const int gb = t[(size_t)min(i, Lq - 1) * W + min(max(w, 0), W - 1)];
        const int gpred = gb & 7;
        const int ge = (gb >> ebit) & 1;
        op = is_m ? (gb >> 7 ? kOpEq : kOpX) : is_i ? kOpI : kOpD;
        nstate = is_m ? ((unsigned)(gpred - 1) < 5u ? gpred - 1 : 0) : (ge ? state : 0);
        done = is_m && gpred == 0;
        if (lane == 0) ops[n & (kTbOps - 1)] = (uint8_t)op;
      }
      const int steps = k > 0 ? k : 1;
      const int n0 = n;
      i -= steps * di;
      w += steps * dw;
      n += steps;
      state = nstate;
      if ((n0 >> 8) != (n >> 8)) flush_ops(out, ops, n0 >> 8, n, n_words, lane);
      if (done || i < 0 || n >= max_steps) break;
    }
  }
  // the last partial block of ops, then zeros to the end of the row
  if (n & 255) flush_ops(out, ops, n >> 8, n, n_words, lane);
  for (int j = ((n + 255) >> 8) * 16 + lane; j < n_words; j += 32) out[j] = 0;
  if (lane == 0) {
    n_steps[b] = n;
    q0[b] = i + 1;
    r0[b] = i + 1 + dlos[b] + w;
  }
  cp_async_wait<0>();  // tiles fetched ahead may still be in flight
}

template <int W>
int launch_traceback(const void* tb, const void* best, const void* bi,
                     const void* bw, const void* bs, const void* dlos, int B,
                     int Lq, int max_steps, void* packed, void* n_steps,
                     void* q0, void* r0, cudaStream_t st) {
  constexpr int kWin = kTbWin < W ? kTbWin : W;
  constexpr int smem = kTbWarps * (kTbTiles * kTbRows * kWin + kTbOps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sw_traceback_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kTbWarps - 1) / kTbWarps;
  sw_traceback_kernel<W><<<blocks, kTbWarps * 32, smem, st>>>(
      (const uint8_t*)tb, (const int32_t*)best, (const int32_t*)bi,
      (const int32_t*)bw, (const int32_t*)bs, (const int32_t*)dlos, B, Lq,
      max_steps, (uint8_t*)packed, (int32_t*)n_steps, (int32_t*)q0,
      (int32_t*)r0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sw_dp_launch(const void* qs, const void* rs, const void* qlens,
                 const void* dlos, int B, int Lq, int Lr, int W, void* tb,
                 void* best, void* bi, void* bw, void* bs, void* stream) {
  const int blocks = (B + kDpWarps - 1) / kDpWarps;
  const dim3 threads(kDpWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* q = (const uint8_t*)qs;
  const uint8_t* r = (const uint8_t*)rs;
  const int32_t* ql = (const int32_t*)qlens;
  const int32_t* dl = (const int32_t*)dlos;
  uint8_t* t = (uint8_t*)tb;
  int32_t *o0 = (int32_t*)best, *o1 = (int32_t*)bi, *o2 = (int32_t*)bw,
          *o3 = (int32_t*)bs;
  switch (W) {
    case 64:
      sw_dp_kernel<2><<<blocks, threads, 0, st>>>(q, r, ql, dl, B, Lq, Lr, t,
                                                  o0, o1, o2, o3);
      break;
    case 128:
      sw_dp_kernel<4><<<blocks, threads, 0, st>>>(q, r, ql, dl, B, Lq, Lr, t,
                                                  o0, o1, o2, o3);
      break;
    case 256:
      sw_dp_kernel<8><<<blocks, threads, 0, st>>>(q, r, ql, dl, B, Lq, Lr, t,
                                                  o0, o1, o2, o3);
      break;
    case 512:
      sw_dp_kernel<16><<<blocks, threads, 0, st>>>(q, r, ql, dl, B, Lq, Lr, t,
                                                   o0, o1, o2, o3);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sw_traceback_launch(const void* tb, const void* best, const void* bi,
                        const void* bw, const void* bs, const void* dlos,
                        int B, int Lq, int W, int max_steps, void* packed,
                        void* n_steps, void* q0, void* r0, void* stream) {
  if (max_steps % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 64:
      return launch_traceback<64>(tb, best, bi, bw, bs, dlos, B, Lq, max_steps,
                                  packed, n_steps, q0, r0, st);
    case 128:
      return launch_traceback<128>(tb, best, bi, bw, bs, dlos, B, Lq, max_steps,
                                   packed, n_steps, q0, r0, st);
    case 256:
      return launch_traceback<256>(tb, best, bi, bw, bs, dlos, B, Lq, max_steps,
                                   packed, n_steps, q0, r0, st);
    case 512:
      return launch_traceback<512>(tb, best, bi, bw, bs, dlos, B, Lq, max_steps,
                                   packed, n_steps, q0, r0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Reads sw_traceback's re-stage count into *out (synchronous), and resets
// it to 0 if `reset`.
int sw_traceback_restages(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_tb_restages, sizeof *out);
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_tb_restages, &zero, sizeof zero);
  }
  return (int)err;
}

}  // extern "C"
