// Split ScoreMLP forward for Hopper (sm_90a): the whole forward in one
// launch, the two halves of the TPU split as two warpgroups that overlap one's
// GroupNorm/SiLU with the other's products.
//
// Replaces tools/bench_kernel.py:108 `fwd_split` (body `_kernel_split`), an
// experiment on the TPU kernel zedo_tpu/ops/pallas/score_kernel.py:214: the
// same function (pre-dense, GroupNorm, SiLU, two residual blocks of
// (dense, GroupNorm, SiLU) x 2 plus the skip, post-dense) on the same packed
// weights, with each row tile cut into two halves whose chains are
// independent, so that one half's GroupNorm/SiLU can overlap the other
// half's products. The plain version is
// ops/kernels/score_kernel_split.py:fused_score_forward_split_reference.
//
// What bounds it: the work of the six-launch kernel (score_mlp.cu),
// 2*B*(51*H + 4*H*H + H*51) operations on bf16 weights: 0.385 ms of
// tensor-core time at 44,300 x 1024 on an H100, bound by operations. Fused,
// only x, the output, the weights and the f32 residual stream cross device
// memory, so no per-layer traffic floor stands above that bound. What stands
// in its way is the weight stream: every block has to take in every weight,
// 8.65 MB at H = 1024, for as many rows as it can keep on chip: 56 operations
// per byte taken in where the six-launch kernel's 128 x 128 tiles have 64.
// Measured on an H100 (tools/probe_tma.py, a kernel that only streams): one
// thread starts at most one TMA box per ~190 ns whatever the box's size up to
// 8 KB and however deep the ring; several threads of one block reach 65 GB/s
// an SM on these tiles (64 rows of 128 bytes, 2 KB apart). That is 0.8 ms
// for the 52 MB an SM takes in at 44,300 rows, twice the operations bound.
// With the stream at that pace (four producer threads) the consumers set the
// time: a tile's products (16 steps of four small wgmma, each step with a
// barrier wait, a commit and a wait_group) and its GroupNorm/SiLU/residual
// take turns on two warpgroups, and the epilogue is the longer of the two.
//
// What the design does about it:
//   * Rows on N, channels on M. wgmma's M is 64 rows, and a fused block's
//     rows are a free choice only on N (any multiple of 8), so each layer
//     computes out^T[channels, rows] = W^T * act^T with m64n56k16 (bf16 x
//     bf16 -> f32): A is a weight tile [64 k, 64 channels] as TMA lands it
//     from the unrepacked [K, N] weights (channel-contiguous: the MN-major
//     form of the A descriptor), B the activations [rows, K], K-contiguous.
//   * One activation buffer. A layer's input stays in shared memory as bf16
//     (2*H bytes a row); its output waits in registers, as bf16 pairs, until
//     every tile of the layer has read the input, and then overwrites it. Two
//     buffers (input and output, 4*H bytes a row) left room for 48 rows and
//     a ring of 4 tiles at H = 1024; one leaves room for 56 rows, which is
//     exactly six blocks for each of the 132 SMs at the 44,300 rows of the
//     H36M solve, and a ring of 13. The price is registers: 8 tiles x 14
//     pairs = 112 of a consumer's 232 (setmaxnreg; the producer's warpgroup
//     gives up its own), which is what limits the width to 1024.
//   * One weight ring: four producer threads (one in each warp of the
//     producer's warpgroup, each owning every fourth stage: one thread alone
//     starts a tile per ~240 ns here, and the forward is a fifth slower) keep
//     as many TMA tile loads in flight under the 128-byte swizzle as shared
//     memory has room for, `full`/`empty` mbarriers per stage; the stream
//     runs ahead across tile and layer boundaries (weights do not depend on
//     activations). No block-wide sync in the main loop.
//   * The two halves of the TPU split are two consumer warpgroups that take
//     the channel tiles of the stream in turn, each against all the rows (one
//     read of the A tile serves every row): while one runs a tile's products
//     the other finishes its tile (GroupNorm, SiLU, residual), which is the
//     overlap the TPU split was after. Each has its own `full` barrier per
//     stage: with one for both, a warpgroup that passes over the other's
//     tile can be two phases ahead of the barrier, and a parity wait then
//     answers for the phase before last. Only at a layer's end do the two
//     meet (a 256-thread barrier before and after the write-back).
//   * The tile's code is kept small. The loop over a layer's tiles is not
//     unrolled, though a layer's output waits in registers that only constant
//     indices reach: a tile's result goes to its place through a copy that is
//     unrolled instead (`cur`, `held`). Unrolled eight times, with the
//     GroupNorm group size a run-time value, the kernel was 0.8 MB of
//     instructions and ran at the pace of instruction fetch: 2.0 ms where it
//     now takes 1.45. The group size is a template argument for the same
//     reason (the branches not taken were a third of the tile's code).
//   * GroupNorm, SiLU and the residual run on the accumulators in
//     registers. With channels on M a thread of warp w, lane l holds channels
//     16w + l/4 and + 8 of the tile at rows 8j + 2(l%4) and + 1: a group's sum
//     of squares is an in-thread add, shuffles over lanes 4, 8 and 16, and
//     for groups of 32 or 64 channels one exchange between the warps through
//     a few hundred bytes of shared memory. `vec`, `gn_scale` and `gn_bias`
//     are per channel: two of each a thread and tile, loaded before the
//     tile's products, as are the residual values (the thread that reads them
//     wrote them itself, two layers before).
//   * The write-back is the next layer's B operand: bf16 straight from
//     registers at the address the 128-byte swizzle gives
//     (hopper::swizzle128); nothing but this kernel writes that buffer.
//   * The first layer's input is staged by the block itself (x cast to bf16,
//     zero-padded to 64 columns), the post layer is one tile of 64 channels
//     with f32 stores of the first c.
//   * The f32 residual stream lives in a scratch laid out for this kernel,
//     [block][channel][row]: a thread's two rows are one 8-byte pair and a
//     quad fills a 32-byte sector. The second residual block's sum is not
//     stored: only the post layer follows, and it reads the bf16 copy.
//
// Built, measured on an H100 and not kept (forward at 44,300 x 1024). A
// cluster of 2 or 4 blocks that walk the same weight stream, each loading
// its share of a tile's k rows into every block's ring at once
// (`.multicast::cluster`), a stage refilled only when the warps that read it
// have released it in all blocks (remote mbarrier arrives with the default
// `.release.cta` ordering: a `.release.cluster` arrive per warp and stage cost
// more than the rest of the kernel together): 1.523 and 1.794 ms against 1.498
// without. Multicast halves and quarters the L2 reads and buys nothing, since
// L2 is not the limit (and the card holds only 30 clusters of 4: 120 of its
// 132 SMs). The others (all but the last three against this design at
// 1.95-2.0 ms, while the tile's code was still unrolled and instruction fetch
// set the pace, so each may read otherwise now): the two halves as two row
// halves of 24 rows with an
// input and an output buffer each and both reading every weight tile (48
// rows a block: 2.41 ms; at 32 rows a block and a ring of 8 or 12 tiles
// slower still); 64 rows a block (as many blocks an SM as 56 rows at that row
// count, each longer: a fifth slower); the two warpgroups' tiles with their
// k blocks in turn in the stream (both compute at once, none finishes under
// the other: a third slower); two sums a tile, even and odd k blocks (a
// seventh slower, and still a tenth slower with the tile's code small);
// walking a tile's k blocks from a rotated start as well (slower); a lone
// producer warp with setmaxnreg (faults: it takes a whole warpgroup);
// streaming hints on the residual (no change); two or four weight tiles to
// one commit group (a fifth and a third slower: the stages a consumer holds
// are missing from the ring); releasing a stage two or three steps later (the
// same); blocks that start each layer at a different channel tile (worth 15%
// while the ring held 4 tiles, 2-3% slower with a ring of 13 and four
// producers).
//
// SiLU is x * (0.5 * tanh(x / 2) + 0.5) with `tanh.approx.f32`
// (hopper::silu), as in score_mlp.cu's wgmma kernel; the plain version uses
// the precise tanh, and the kernel is held against it within the same
// tolerance.
//
// GroupNorm statistics in the two modes of the TPU kernel's `gn_dtype`, as
// in score_mlp.cu: f32, or bf16 (squares rounded to bf16 and summed in f32
// times bf16(1/group); rsqrt rounded to bf16 times bf16(scale)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE_M = 64;                   // channels of a weight tile: wgmma's M
constexpr int BK = 64;                       // depth of a weight tile: one 128-byte row of B
constexpr int TILE_BYTES = BK * TILE_M * 2;  // 8 KB
constexpr int MIN_STAGES = 4;                // weight tiles in flight: at least, and
constexpr int MAX_STAGES = 16;               // at most (what is left of shared memory)
constexpr int CONSUMERS = 256;               // two warpgroups, each every other channel tile
constexpr int THREADS = CONSUMERS + 128;     // and the producer's warpgroup, of which
constexpr int PRODUCERS = 4;                 // one thread a warp works
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // of a thread, after the launch's 168
constexpr int ROWS = 56;                     // rows of a block: the N of wgmma_m64n56k16_tn
constexpr int MAX_TILES = 16;                // channel tiles of a hidden layer: hidden <= 1024
constexpr int N_LAYERS = 6;
constexpr float GN_EPS = 1e-5f;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of an H100 block

// Shared memory of a block at hidden width h: slack to align the ring to
// 1024 bytes (the swizzle's period), the ring, one bf16 activation buffer
// (2 * h bytes a row), the warps' exchange of GroupNorm sums (two buffers in
// turn for each warpgroup) and the barriers (a stage's `full` for each
// warpgroup, and its `empty`).
constexpr int smem_bytes(int h, int stages) {
  return 1024 + stages * TILE_BYTES + 2 * h * ROWS + 2 * 2 * 4 * ROWS * 4 + 3 * MAX_STAGES * 8;
}

// Rows of a block at hidden width h, 0 for a width the kernel does not take:
// a layer's output waits in registers, 8 channel tiles a warpgroup, and its
// input has to fit shared memory beside a ring of MIN_STAGES.
// (score_kernel_split.tile_rows mirrors it.)
constexpr int tile_rows(int h) {
  return h % TILE_M == 0 && h / TILE_M <= MAX_TILES && smem_bytes(h, MIN_STAGES) <= SMEM_LIMIT
             ? ROWS
             : 0;
}

// Stages of the ring: what is left of a block's shared memory.
constexpr int ring_stages(int h) {
  const int stages = (SMEM_LIMIT - smem_bytes(h, 0)) / TILE_BYTES;
  return stages < MAX_STAGES ? stages : MAX_STAGES;
}

struct Maps {
  CUtensorMap m[N_LAYERS];  // the layers' weights, boxes of [BK, TILE_M]
};

// A chain of n_gn GroupNorm layers and one output layer. The forward has
// n_gn = 5; n_gn = 0 is the product alone (zedo_score_mlp_split_product).
struct SplitArgs {
  const float* x;         // [M, c] f32 input rows
  float* out;             // [M, ldo] f32
  float* resid;           // [blocks][H][ROWS] f32 scratch
  const float* vecs;      // [n_gn, H]
  const float* gn_scale;  // [n_gn, H]
  const float* gn_bias;   // [n_gn, H]
  const float* bias;      // [out_cols] of the output layer
  int M, c;               // rows, and the columns of x that hold data
  int k0;                 // c rounded up to BK: depth of the first layer
  int H;                  // hidden width
  int n_gn;
  int out_cols, ldo;      // channels of the output layer that are stored
  int stages;             // of the weight ring
};

struct LayerShape {
  int kblocks, tiles;
};

__device__ __forceinline__ LayerShape layer_shape(const SplitArgs& p, int l) {
  return {(l == 0 ? p.k0 : p.H) / BK,
          l == p.n_gn ? (p.out_cols + TILE_M - 1) / TILE_M : p.H / TILE_M};
}

// barrier of the 128 threads of one warpgroup (ids 1 and 2) and of all
// consumers (id 3); 0 is __syncthreads
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Producer thread q of PRODUCERS: every weight tile of the chain in order. A
// stage belongs to one thread (stage % PRODUCERS), which loads every tile
// that lands there, so no thread can be a phase ahead of another at a
// stage's barriers.
__device__ __forceinline__ void produce(const Maps& maps, const SplitArgs& p, uint32_t ring,
                                        uint32_t full, uint32_t empty, int q) {
  int stage = 0;
  uint32_t phase = 0;
  for (int l = 0; l <= p.n_gn; ++l) {
    const LayerShape ls = layer_shape(p, l);
    const CUtensorMap* map = &maps.m[l];
    for (int i = 0; i < ls.tiles; ++i) {
      for (int kb = 0; kb < ls.kblocks; ++kb) {
        if (stage % PRODUCERS == q) {
          // the warpgroup that read this stage has released it
          mbar_wait(empty + 8 * stage, phase ^ 1);
          // The stage's `full` barrier of the warpgroup that takes this tile
          // (the tiles in turn). One barrier for both would let a warpgroup
          // that passes over the other's tile run two phases ahead of the
          // barrier, where a parity wait answers for the phase before last.
          const uint32_t bar = full + 8 * ((i & 1) * MAX_STAGES + stage);
          mbar_arrive_expect_tx(bar, TILE_BYTES);
          tma_load_2d(ring + stage * TILE_BYTES, map, bar, i * TILE_M, kb * BK);
        }
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

template <int GN>
__device__ __forceinline__ float square(float v) {
  return GN == 1 ? round_bf16(v * v) : v * v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The consumers: the block's rows through every layer, the two warpgroups
// taking the channel tiles of the stream in turn. GN: GroupNorm statistics
// mode (1 bf16, 0 f32); G: channels of a GroupNorm group (4, 8, 16, 32 or 64;
// at compile time: the branches not taken are a third of the tile's code).
template <int GN, int G>
__device__ __forceinline__ void consume(const SplitArgs& p, uint32_t ring, uint32_t act,
                                        unsigned char* act_ptr, float* xch, uint32_t full,
                                        uint32_t empty, int tid) {
  constexpr int NJ = ROWS / 8;    // 8-row blocks
  constexpr int REGS = ROWS / 2;  // accumulators of a thread
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  constexpr int kblock_bytes = ROWS * 128;
  const int row0 = blockIdx.x * ROWS;

  // the block's rows of x as bf16 into the buffer, zero past column c and
  // past row M
  for (int i = tid; i < ROWS * p.k0; i += CONSUMERS) {
    const int r = i / p.k0, col = i % p.k0;
    const int gr = row0 + r;
    const float v = (gr < p.M && col < p.c) ? p.x[(size_t)gr * p.c + col] : 0.f;
    *reinterpret_cast<__nv_bfloat16*>(act_ptr + (col / BK) * kblock_bytes +
                                      swizzle128(r * 128 + (col % BK) * 2)) =
        __float2bfloat16(v);
  }
  fence_proxy_async();
  consumer_sync();

  // this thread's accumulators: channels ca and ca + 8 of a tile at the rows
  // 8j + rq and + 1. Where they go in the next layer's B operand: row r,
  // 16-byte chunk (channel / 8) ^ (r % 8), two bytes a channel.
  const int ca = 16 * w + (lane >> 2), rq = 2 * (lane & 3);
  uint32_t dst[2][2];  // [channel a, b][row rq, rq + 1]
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int e = 0; e < 2; ++e) dst[b][e] = swizzle128((rq + e) * 128 + (ca + 8 * b) * 2);
  float* const resid = p.resid + (size_t)blockIdx.x * p.H * ROWS + rq;
  constexpr float inv_group = 1.f / G;  // a power of two: exact, in bf16 too
  float* const xch_wg = xch + wg * 2 * 4 * ROWS;  // this warpgroup's two exchange buffers

  // A layer's output waits here, as bf16 pairs (rows rq, rq + 1), until every
  // tile of the layer has read the layer's input: [tile of this warpgroup]
  // [j][channel a, b].
  uint32_t held[MAX_TILES / 2][NJ][2];

  int stage = 0, xbuf = 0, prev = -1;
  // bit s: the parity of this warpgroup's next wait at its `full` barrier of
  // stage s (it flips each time the warpgroup takes the stage)
  uint32_t parity = 0;
  const uint32_t my_full = full + 8 * wg * MAX_STAGES;
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(empty + 8 * s);
  };
  // pass over the stages of a tile that the other warpgroup reads
  auto skip = [&](int n) { stage = (stage + n) % p.stages; };

  for (int l = 0; l <= p.n_gn; ++l) {
    const LayerShape ls = layer_shape(p, l);
    const bool last = l == p.n_gn;
    // layers 2, 4, .. add the residual stream; a layer starts or updates it
    // when a later one reads it
    const bool add_resid = !last && l >= 2 && l % 2 == 0;
    const bool store_resid = !last && l % 2 == 0 && l + 2 < p.n_gn;
    const float* const vec = p.vecs + (size_t)l * p.H;
    const float* const scale = p.gn_scale + (size_t)l * p.H;
    const float* const bias = p.gn_bias + (size_t)l * p.H;

    // Not unrolled: with eight copies of this body the kernel was 0.8 MB of
    // instructions, which no instruction cache holds; `held` stays in
    // registers all the same (see `cur` below).
#pragma unroll 1
    for (int ii = 0; ii < MAX_TILES / 2; ++ii) {
      // positions 2 ii and 2 ii + 1 of the stream: one for each warpgroup,
      // which passes over the other's stages
      if (wg == 1 && 2 * ii < ls.tiles) skip(ls.kblocks);
      if (2 * ii + wg < ls.tiles) {
        // channel tile 2 ii + wg; this thread's channels: ch and ch + 8
        const int ch = (2 * ii + wg) * TILE_M + ca;
        // per-channel vectors, asked for before the products so that they
        // arrive under them
        float va = 0.f, vb = 0.f, sa = 0.f, sb = 0.f, ba = 0.f, bb = 0.f;
        if (!last) {
          va = __ldg(vec + ch), vb = __ldg(vec + ch + 8);
          sa = __ldg(scale + ch), sb = __ldg(scale + ch + 8);
          ba = __ldg(bias + ch), bb = __ldg(bias + ch + 8);
          if (GN == 1) sa = round_bf16(sa), sb = round_bf16(sb);
        } else {
          if (ch < p.out_cols) va = __ldg(p.bias + ch);
          if (ch + 8 < p.out_cols) vb = __ldg(p.bias + ch + 8);
        }

        // and the residual values (this thread wrote them itself, two layers
        // before)
        float* const res_a = resid + (size_t)ch * ROWS;
        float* const res_b = resid + (size_t)(ch + 8) * ROWS;
        float2 pa[NJ], pb[NJ];
        if (add_resid) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            pa[j] = *reinterpret_cast<const float2*>(res_a + 8 * j);
            pb[j] = *reinterpret_cast<const float2*>(res_b + 8 * j);
          }
        }

        float acc[REGS];
        for (int kb = 0; kb < ls.kblocks; ++kb) {
          mbar_wait(my_full + 8 * stage, (parity >> stage) & 1);
          parity ^= 1u << stage;
          // A: MN-major rows of 64 channels, one row per k, 8-k groups 1024
          // bytes apart; 16 k = 2048 bytes. B: K-major rows of 128 bytes,
          // 8-row groups 1024 bytes apart; 16 k = 32 bytes along a row.
          const uint64_t da = smem_desc(ring + stage * TILE_BYTES, TILE_BYTES, 1024);
          const uint64_t db = smem_desc(act + kb * kblock_bytes, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < BK / 16; ++k)
            wgmma_m64n56k16_tn(acc, da + ((k * 2048) >> 4), db + ((k * 32) >> 4),
                               (kb | k) != 0);
          wgmma_commit();
          // The products of the step before have finished: release its stage.
          // (At once, wgmma.wait_group 0, or two or three steps later: the
          // same. Two or four tiles to a step and a commit: a fifth and a
          // third slower, the stages they hold are missing from the ring.)
          if (prev >= 0) {
            wgmma_wait<1>();
            release(prev);
          }
          prev = stage;
          if (++stage == p.stages) stage = 0;
        }
        wgmma_wait<0>();
        if (prev >= 0) release(prev);
        prev = -1;
        accumulator_fence(acc);

        if (last) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gr = row0 + 8 * j + rq + e;
              if (gr < p.M) {
                if (ch < p.out_cols) p.out[(size_t)gr * p.ldo + ch] = acc[4 * j + e] + va;
                if (ch + 8 < p.out_cols)
                  p.out[(size_t)gr * p.ldo + ch + 8] = acc[4 * j + 2 + e] + vb;
              }
            }
        } else {
          // GroupNorm (given the sums of squares of the rows 8j + rq and + 1,
          // for channel a's group and channel b's), SiLU and the residual of
          // this thread's four values of block j; the result goes to `cur`
          uint32_t cur[NJ][2];
          auto finish = [&](int j, float ssa0, float ssa1, float ssb0, float ssb1) {
            auto rstd = [&](float ss) {
              const float r = rsqrtf(ss * inv_group + GN_EPS);
              return GN == 1 ? round_bf16(r) : r;
            };
            float ya0 = silu(acc[4 * j] * (rstd(ssa0) * sa) + ba);
            float ya1 = silu(acc[4 * j + 1] * (rstd(ssa1) * sa) + ba);
            float yb0 = silu(acc[4 * j + 2] * (rstd(ssb0) * sb) + bb);
            float yb1 = silu(acc[4 * j + 3] * (rstd(ssb1) * sb) + bb);
            if (add_resid) ya0 += pa[j].x, ya1 += pa[j].y, yb0 += pb[j].x, yb1 += pb[j].y;
            if (store_resid) {
              *reinterpret_cast<float2*>(res_a + 8 * j) = make_float2(ya0, ya1);
              *reinterpret_cast<float2*>(res_b + 8 * j) = make_float2(yb0, yb1);
            }
            cur[j][0] = pack_bf16(ya0, ya1);
            cur[j][1] = pack_bf16(yb0, yb1);
          };

#pragma unroll
          for (int i = 0; i < REGS; i += 4) {
            acc[i] += va, acc[i + 1] += va;
            acc[i + 2] += vb, acc[i + 3] += vb;
          }
          if (G >= 16) {
            // channels a and b are in one group: a row's sum over this
            // thread's two channels, then over the lanes that hold the
            // warp's other 14 (lanes 4, 8 and 16 apart)
            float ss[NJ][2];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float v = square<GN>(acc[4 * j + e]) + square<GN>(acc[4 * j + 2 + e]);
                v += __shfl_xor_sync(0xffffffffu, v, 4);
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                ss[j][e] = v;
              }
            if (G >= 32) {
              // a group spans two warps (32 channels) or all four (64): the
              // warps swap their sums through shared memory, in one of two
              // buffers in turn, so one barrier a tile is enough
              float* const all = xch_wg + xbuf * 4 * ROWS;
              xbuf ^= 1;
              if ((lane >> 2) == 0) {
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                  *reinterpret_cast<float2*>(all + w * ROWS + 8 * j + rq) =
                      make_float2(ss[j][0], ss[j][1]);
              }
              warpgroup_sync(wg);
#pragma unroll
              for (int j = 0; j < NJ; ++j) {
                const float* row = all + 8 * j + rq;
                float2 s;
                if (G == 32) {
                  const float2 s0 = *reinterpret_cast<const float2*>(row + (w & 2) * ROWS);
                  const float2 s1 = *reinterpret_cast<const float2*>(row + ((w & 2) + 1) * ROWS);
                  s = make_float2(s0.x + s1.x, s0.y + s1.y);
                } else {
                  s = make_float2(0.f, 0.f);
#pragma unroll
                  for (int ww = 0; ww < 4; ++ww) {
                    const float2 sw = *reinterpret_cast<const float2*>(row + ww * ROWS);
                    s.x += sw.x;
                    s.y += sw.y;
                  }
                }
                ss[j][0] = s.x;
                ss[j][1] = s.y;
              }
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) finish(j, ss[j][0], ss[j][1], ss[j][0], ss[j][1]);
          } else {
            // groups of 4 or 8 channels: a and b are in different groups,
            // each within the warp (lanes 4 and 8 apart hold a group of 4)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              float s[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                s[i] = square<GN>(acc[4 * j + i]);
                s[i] += __shfl_xor_sync(0xffffffffu, s[i], 4);
                s[i] += __shfl_xor_sync(0xffffffffu, s[i], 8);
                if (G == 8) s[i] += __shfl_xor_sync(0xffffffffu, s[i], 16);
              }
              finish(j, s[0], s[1], s[2], s[3]);
            }
          }
          // The tile's result waits in held[ii]. Written with every index a
          // constant (one of these copies runs), so that `held` is registers
          // and not local memory.
#pragma unroll
          for (int k = 0; k < MAX_TILES / 2; ++k)
            if (k == ii) {
#pragma unroll
              for (int j = 0; j < NJ; ++j) held[k][j][0] = cur[j][0], held[k][j][1] = cur[j][1];
            }
        }
      }
      if (wg == 0 && 2 * ii + 1 < ls.tiles) skip(ls.kblocks);
    }
    if (last) break;

    // Every tile's products have read the layer's input: its output goes
    // into the buffer, as the next layer's B operand, visible to wgmma
    // before that layer starts.
    consumer_sync();
#pragma unroll
    for (int ii = 0; ii < MAX_TILES / 2; ++ii)
      if (2 * ii + wg < ls.tiles) {
        unsigned char* const out_tile = act_ptr + (2 * ii + wg) * kblock_bytes;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&held[ii][j][b]);
            // 8 rows on: one 1024-byte atom of the swizzle
            *reinterpret_cast<__nv_bfloat16*>(out_tile + j * 1024 + dst[b][0]) = v.x;
            *reinterpret_cast<__nv_bfloat16*>(out_tile + j * 1024 + dst[b][1]) = v.y;
          }
      }
    fence_proxy_async();
    consumer_sync();
  }
}

template <int GN, int G>
__global__ void __launch_bounds__(THREADS, 1)
score_mlp_split(const __grid_constant__ Maps maps, const SplitArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: the ring and the
  // activation buffer start on such a boundary
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  const int ring_bytes = p.stages * TILE_BYTES;
  float* const xch = reinterpret_cast<float*>(ring_ptr + ring_bytes + 2 * p.H * ROWS);
  const uint32_t full = smem_u32(xch + 2 * 2 * 4 * ROWS);  // [warpgroup][stage]
  const uint32_t empty = full + 2 * MAX_STAGES * 8;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's arrive.expect_tx
      mbar_init(full + 8 * (MAX_STAGES + s), 1);
      mbar_init(empty + 8 * s, 4);  // the warps of one warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Twelve warps are launched with 168 registers each. The producer's
  // warpgroup needs few; the consumers hold a layer's output in 128 and take
  // what the producer gives up.
  if (tid >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if ((tid & 31) == 0 && (tid - CONSUMERS) / 32 < PRODUCERS)
      produce(maps, p, ring, full, empty, (tid - CONSUMERS) / 32);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<GN, G>(p, ring, ring + ring_bytes, ring_ptr + ring_bytes, xch, full, empty, tid);
  }
}

// One box of a [rows, 64] bf16 matrix by TMA under the 128-byte swizzle
// beside the same matrix written through swizzle128; both copies of shared
// memory go out as they lie.
__global__ void swizzle_check(const __grid_constant__ CUtensorMap map,
                              const __nv_bfloat16* __restrict__ src, int rows,
                              __nv_bfloat16* by_tma, __nv_bfloat16* by_function) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const tma_ptr = smem_raw + (base - smem_u32(smem_raw));
  unsigned char* const fn_ptr = tma_ptr + rows * 128;
  __shared__ __align__(8) uint64_t bar_storage;
  const uint32_t bar = smem_u32(&bar_storage);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, rows * 128);
    tma_load_2d(base, &map, bar, 0, 0);
  }
  for (int i = threadIdx.x; i < rows * 64; i += blockDim.x)
    *reinterpret_cast<__nv_bfloat16*>(fn_ptr + swizzle128((i / 64) * 128 + (i % 64) * 2)) = src[i];
  mbar_wait(bar, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * 64; i += blockDim.x) {
    by_tma[i] = reinterpret_cast<const __nv_bfloat16*>(tma_ptr)[i];
    by_function[i] = reinterpret_cast<const __nv_bfloat16*>(fn_ptr)[i];
  }
}

using Kernel = void (*)(const Maps, const SplitArgs);

template <int GN>
Kernel kernel_for_group(int group) {
  switch (group) {
    case 4: return score_mlp_split<GN, 4>;
    case 8: return score_mlp_split<GN, 8>;
    case 16: return score_mlp_split<GN, 16>;
    case 32: return score_mlp_split<GN, 32>;
    case 64: return score_mlp_split<GN, 64>;
    default: return nullptr;
  }
}

// null for a group size the kernel is not built for
Kernel kernel_for(int gn_bf16, int group) {
  return gn_bf16 ? kernel_for_group<1>(group) : kernel_for_group<0>(group);
}

// p.H, p.M and the weights `w` ([w_rows[l], w_cols[l]] bf16) of the n_gn + 1
// layers: encodes (or finds) the maps and launches.
cudaError_t launch(SplitArgs p, int gn_bf16, int group, const void* const* w, const int* w_rows,
                   const int* w_cols, size_t resid_floats, cudaStream_t stream) {
  const Kernel kernel = kernel_for(gn_bf16, group);
  if (tile_rows(p.H) == 0 || kernel == nullptr) return cudaErrorInvalidValue;
  const int blocks = (p.M + ROWS - 1) / ROWS;  // the row tiles
  if (resid_floats < (size_t)blocks * ROWS * p.H * (p.n_gn > 0)) return cudaErrorInvalidValue;
  Maps maps;
  for (int l = 0; l <= p.n_gn; ++l)
    if (!cached_bf16_map(&maps.m[l], w[l], w_rows[l], w_cols[l], BK, TILE_M))
      return cudaErrorNotSupported;  // libcuda refused the map or lacks the call
  for (int l = p.n_gn + 1; l < N_LAYERS; ++l) maps.m[l] = maps.m[0];
  p.stages = ring_stages(p.H);
  const int smem = smem_bytes(p.H, p.stages);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of a block's tile at hidden width h (0: the kernel does not take the
// width), the stages of its weight ring, the dynamic shared memory of such a
// block, and the most a block may have.
int zedo_score_mlp_split_tile_rows(int h) { return tile_rows(h); }
int zedo_score_mlp_split_stages(int h) { return ring_stages(h); }
int zedo_score_mlp_split_smem_bytes(int h) { return smem_bytes(h, ring_stages(h)); }
int zedo_score_mlp_split_smem_limit() { return SMEM_LIMIT; }

// One fused forward in one launch: x [m, c] f32 -> out [m, c] f32, c <=
// io_pad. Weights bf16 input-major: w_pre [io_pad, h], w_b* [h, h], w_post
// [h, io_pad]; vecs, gn_scale, gn_bias [5, h] f32; bias_post [io_pad] f32;
// resid: f32 scratch of resid_floats >= blocks * tile_rows(h) * h values,
// blocks being the row tiles. tile_rows(h) > 0; group 4, 8, 16, 32 or 64;
// gn_bf16: GroupNorm statistics mode (1 bf16, 0 f32). Returns the launch's
// CUDA error, or 0.
int zedo_score_mlp_split_forward(const float* x, int m, int c, int io_pad, int h, int group,
                                 int gn_bf16, const void* w_pre, const void* w_b1,
                                 const void* w_b2, const void* w_b3, const void* w_b4,
                                 const void* w_post, const float* vecs,
                                 const float* gn_scale, const float* gn_bias,
                                 const float* bias_post, float* out, float* resid,
                                 long long resid_floats, void* stream) {
  if (m <= 0) return 0;
  if (h % 128 != 0 || io_pad % BK != 0 || c <= 0 || c > io_pad || group <= 0 ||
      h % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs p{};
  p.x = x; p.out = out; p.resid = resid;
  p.vecs = vecs; p.gn_scale = gn_scale; p.gn_bias = gn_bias; p.bias = bias_post;
  p.M = m; p.c = c; p.k0 = (c + BK - 1) / BK * BK; p.H = h; p.n_gn = N_LAYERS - 1;
  p.out_cols = c; p.ldo = c;
  const void* w[N_LAYERS] = {w_pre, w_b1, w_b2, w_b3, w_b4, w_post};
  const int w_rows[N_LAYERS] = {io_pad, h, h, h, h, h};
  const int w_cols[N_LAYERS] = {h, h, h, h, h, io_pad};
  return static_cast<int>(launch(p, gn_bf16, group, w, w_rows, w_cols,
                                 static_cast<size_t>(resid_floats),
                                 static_cast<cudaStream_t>(stream)));
}

// out [m, n] f32 = a [m, k] f32 (rounded to bf16 as the kernel stages it) @
// w [k, n] bf16 through the forward kernel's ring, descriptors, accumulator
// layout and output layer alone: the transposed product, for checks against
// a matrix product. k and n multiples of 64 up to 1024; zero_bias [n] f32
// zeros.
int zedo_score_mlp_split_product(const float* a, int m, int k, const void* w, int n,
                                 const float* zero_bias, float* out, void* stream) {
  if (m <= 0) return 0;
  if (n % TILE_M != 0 || n / TILE_M > MAX_TILES) return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs p{};
  p.x = a; p.out = out; p.bias = zero_bias;
  p.M = m; p.c = k; p.k0 = k; p.H = k; p.n_gn = 0;
  p.out_cols = n; p.ldo = n;
  const void* ws[1] = {w};
  return static_cast<int>(launch(p, 1, 32, ws, &k, &n, 0, static_cast<cudaStream_t>(stream)));
}

// src [rows, 64] bf16 (rows a multiple of 8 up to 128) as one TMA box under
// the 128-byte swizzle and through hopper::swizzle128: both images of shared
// memory, [rows * 64] bf16 each.
int zedo_swizzle_check(const void* src, int rows, void* by_tma, void* by_function,
                       void* stream) {
  if (rows <= 0 || rows % 8 != 0 || rows > 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (!hopper::encode_bf16_map(&map, src, rows, 64, rows, 64))
    return static_cast<int>(cudaErrorNotSupported);
  swizzle_check<<<1, 128, 1024 + 2 * rows * 128, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const __nv_bfloat16*>(src), rows,
      static_cast<__nv_bfloat16*>(by_tma), static_cast<__nv_bfloat16*>(by_function));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
