// How fast an SM of a Hopper card takes tiles in through TMA: a kernel that
// does nothing else. Each block keeps a ring of TMA box loads of a bf16
// matrix in flight (boxes of box_rows x 64 columns, 128-byte rows under the
// 128-byte swizzle, as the score kernels load their weight tiles); a consumer
// thread waits for each box and hands its stage back. No product, no
// epilogue, no store: the time of a launch is the time the boxes take to
// arrive. tools/probe_tma.py times it over box sizes, ring depths, producer
// threads, blocks per SM, and over what the blocks read (all the same region,
// as the split score kernel's blocks read the same weights, or each its own).
//
// Not part of any forward: the score kernels' designs are argued from what
// this measures (csrc/score_mlp_split.cu's header).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_STAGES = 64;
constexpr int MAX_PRODUCERS = 4;
// warp 0 consumes, one thread of each other warp produces
constexpr int THREADS = 32 * (1 + MAX_PRODUCERS);
constexpr int BOX_COLS = 64;                       // 128 bytes: the widest row the swizzle takes

struct ProbeArgs {
  int box_rows;        // rows of a box
  int stages;          // boxes of the ring
  int producers;       // threads that start the loads, box i by thread i % producers
  int boxes;           // boxes a block takes in
  int region_rows;     // rows of the region a block walks, box_rows at a time, column tile by tile
  int private_region;  // 1: block b walks the rows from b * region_rows; 0: all blocks the same
  int col_tiles;       // 64-column tiles of the matrix
  int stagger;         // 1: block b starts at column tile b % col_tiles
};

constexpr int smem_needed(int box_rows, int stages) {
  return 1024 + stages * box_rows * BOX_COLS * 2 + 2 * MAX_STAGES * 8;
}

// TIMED: the first producer thread also sums the clock cycles it spends
// waiting for a free stage, announcing the bytes, and in the TMA instruction
// itself, and block b writes them to cycles[4 b .. 4 b + 2] (and its whole
// loop to 4 b + 3).
template <bool TIMED>
__global__ void __launch_bounds__(THREADS)
tma_stream(const __grid_constant__ CUtensorMap map, const ProbeArgs p, long long* cycles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int box_bytes = p.box_rows * BOX_COLS * 2;
  const uint32_t full = ring + p.stages * box_bytes;
  const uint32_t empty = full + 8 * MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0 && lane == 0) {
    // the consumer: every box in order; the last wait outlives every load
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < p.boxes; ++i) {
      mbar_wait(full + 8 * s, phase);
      mbar_arrive(empty + 8 * s);
      if (++s == p.stages) s = 0, phase ^= 1;
    }
  } else if (warp >= 1 && warp <= p.producers && lane == 0) {
    const int kblocks = p.region_rows / p.box_rows;
    const int row0 = p.private_region ? blockIdx.x * p.region_rows : 0;
    long long t_wait = 0, t_expect = 0, t_tma = 0;
    const long long t_start = TIMED ? clock64() : 0;
    // every thread walks all boxes (counters only: no division in the loop)
    // and loads those whose turn is its own
    int s = 0, kb = 0, tile = p.stagger ? blockIdx.x % p.col_tiles : 0, turn = 0;
    uint32_t phase = 0;
    for (int i = 0; i < p.boxes; ++i) {
      if (turn == warp - 1) {
        const long long t0 = TIMED ? clock64() : 0;
        mbar_wait(empty + 8 * s, phase ^ 1);
        const long long t1 = TIMED ? clock64() : 0;
        mbar_arrive_expect_tx(full + 8 * s, box_bytes);
        const long long t2 = TIMED ? clock64() : 0;
        tma_load_2d(ring + s * box_bytes, &map, full + 8 * s, tile * BOX_COLS,
                    row0 + kb * p.box_rows);
        if (TIMED) {
          const long long t3 = clock64();
          t_wait += t1 - t0, t_expect += t2 - t1, t_tma += t3 - t2;
        }
      }
      if (++turn == p.producers) turn = 0;
      if (++s == p.stages) s = 0, phase ^= 1;
      if (++kb == kblocks) {
        kb = 0;
        if (++tile == p.col_tiles) tile = 0;
      }
    }
    if (TIMED && warp == 1) {
      long long* const out = cycles + 4 * blockIdx.x;
      out[0] = t_wait, out[1] = t_expect, out[2] = t_tma, out[3] = clock64() - t_start;
    }
  }
  __syncthreads();
}

using Probe = void (*)(const CUtensorMap, const ProbeArgs, long long*);

Probe probe_for(bool timed) { return timed ? tma_stream<true> : tma_stream<false>; }

}  // namespace

extern "C" {

// Blocks of the probe an SM holds at a time when each asks for smem_bytes of
// dynamic shared memory; 0 on error.
int zedo_tma_probe_blocks_per_sm(int smem_bytes) {
  int blocks = 0;
  if (cudaFuncSetAttribute(probe_for(false), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_for(false), THREADS,
                                                    smem_bytes) != cudaSuccess)
    return 0;
  return blocks;
}

// One launch of `blocks` blocks, each taking in `boxes` boxes of box_rows x
// 64 of the bf16 matrix w [rows, cols] (cols a multiple of 64) through a ring
// of `stages` boxes fed by `producers` threads. A block walks region_rows
// rows (a multiple of box_rows) column tile by column tile, again and again:
// every block the first region_rows rows, or, with private_region, block b
// the rows from b * region_rows. smem_bytes: dynamic shared memory a block
// asks for, at least what its ring needs; more keeps fewer blocks on an SM.
// cycles: null, or [blocks, 4] where each block's first producer thread leaves the clock
// cycles it spent waiting for a free stage, announcing the bytes, in the TMA
// instruction, and in its whole loop. Returns the launch's CUDA error, or 0.
int zedo_tma_probe(const void* w, int rows, int cols, int box_rows, int stages, int producers,
                   int boxes, int region_rows, int private_region, int stagger,
                   int blocks, int smem_bytes, long long* cycles, void* stream) {
  const bool ok = box_rows > 0 && box_rows <= 256 && box_rows % 8 == 0 && stages > 0 &&
                  stages <= MAX_STAGES && producers > 0 && producers <= MAX_PRODUCERS &&
                  boxes > 0 && blocks > 0 && cols % BOX_COLS == 0 && region_rows > 0 &&
                  region_rows % box_rows == 0 &&
                  (private_region ? (long long)blocks * region_rows : region_rows) <= rows &&
                  smem_bytes >= smem_needed(box_rows, stages);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (!hopper::encode_bf16_map(&map, w, rows, cols, box_rows, BOX_COLS))
    return static_cast<int>(cudaErrorNotSupported);
  const Probe kernel = probe_for(cycles != nullptr);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ProbeArgs p{box_rows,    stages,         producers,       boxes,
              region_rows, private_region, cols / BOX_COLS, stagger};
  kernel<<<blocks, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(map, p, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
