// Building blocks of the Hopper (sm_90a) kernels: mbarriers, TMA tile loads
// through tensor maps, wgmma (warpgroup matrix multiply) on bf16 operands in
// 128-byte-swizzled shared memory, the swizzle's address function, the
// epilogues' shared arithmetic, and the host calls that encode and cache
// tensor maps. Inline PTX only; no library is linked beyond the CUDA runtime
// (cuTensorMapEncodeTiled is looked up in libcuda, which the runtime has
// already loaded).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <mutex>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- arithmetic the epilogues share ---------------------------------------

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// x * sigmoid(x) as x * (0.5 * tanh(x / 2) + 0.5) with `tanh.approx.f32`: one
// MUFU operation, relative error about 2^-11, an eighth of a bf16 rounding
// step
__device__ __forceinline__ float silu(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.5f * x));
  return x * (0.5f * t + 0.5f);
}

// the same with the precise tanhf (the wmma kernel's and the plain version's
// form)
__device__ __forceinline__ float silu_precise(float x) {
  return x * (0.5f * tanhf(0.5f * x) + 0.5f);
}

// ---- the 128-byte swizzle -------------------------------------------------
// Where the byte at `offset` of a tile of 128-byte rows lands under
// CU_TENSOR_MAP_SWIZZLE_128B, both counted from the tile's 1024-byte-aligned
// start: within each 1024-byte atom (8 rows) the index of the 16-byte chunk
// is XORed with the row's index in the atom. A permutation of each atom that
// keeps 16-byte chunks whole. (score_kernel_split.swizzle128 mirrors it.)
__host__ __device__ __forceinline__ uint32_t swizzle128(uint32_t offset) {
  return offset ^ (((offset >> 7) & 7u) << 4);
}

// makes shared-memory writes of ordinary stores visible to the asynchronous
// proxy (wgmma and TMA read through it); follow with the barrier that
// orders the readers after the writers
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- registers --------------------------------------------------------------
// A whole warpgroup (four warps) gives up registers (a producer that only
// starts copies) or takes more than the launch gave it (consumers), in a
// branch that never meets the other role's again. A lone warp in place of a
// warpgroup faults.

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- mbarrier -----------------------------------------------------------
// A barrier starts in phase 0. wait(parity) returns once the barrier's
// phase differs from `parity`: a consumer waits with its own phase bit, a
// producer with the flipped bit, so its first wait on a fresh barrier passes.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// makes the initialised barriers visible to the TMA unit; follow with a
// block-wide sync before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A wait that has spun for seconds is a deadlock (these kernels run for
// milliseconds): it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  constexpr long long DEADLOCK_CYCLES = 8000000000ll;
  uint32_t done, spins = 0;
  long long start = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (++spins & 1023u) == 0) {
      if (start == 0) start = clock64();
      else if (clock64() - start > DEADLOCK_CYCLES) __trap();
    }
  } while (!done);
}

// ---- TMA ----------------------------------------------------------------

// One box of a 2-D tensor map to shared memory; (c0, c1) are the element
// coordinates of the box's corner, innermost dimension first. Rows and
// columns outside the tensor arrive as zeros. Completion is reported to
// `bar` as the box's full byte count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a bf16 operand under the 128-byte
// swizzle (the layout a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes;
// the tile must start on a 1024-byte boundary). All offsets in bytes.
//   K-major operand (rows of 64 k-values = 128 bytes): lbo is not read,
//     sbo is the distance between 8-row groups (8 * 128).
//   MN-major operand (rows of 64 m- or n-values, one row per k): lbo is the
//     distance between two 64-wide column blocks, sbo between 8-row (8 k)
//     groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// before the first wgmma that reads registers other operations have written
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulators across a wait
template <int REGS>
__device__ __forceinline__ void accumulator_fence(float (&d)[REGS]) {
#pragma unroll
  for (int i = 0; i < REGS; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x128] += a[64x16] * b[16x128]: a K-major, b MN-major (n contiguous),
// both bf16 in shared memory, d f32 in registers. In d a thread of warp w
// (of the warpgroup's four) and lane l holds, for j = 0..15, rows
// 16w + l/4 (d[4j], d[4j+1]) and 16w + l/4 + 8 (d[4j+2], d[4j+3]) at the
// columns 8j + 2(l%4) and 8j + 2(l%4) + 1.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"  // scale-d, +a, +b, a K-major, b MN-major
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 operands, f32 sums, one warp
// (mma.sync). Lane l holds a as four words of two bf16 (the lower half the
// lower column): rows l/4 (a[0]) and l/4 + 8 (a[1]) at the columns 2(l%4),
// 2(l%4) + 1, and the same rows 8 columns on (a[2], a[3]); b as two words:
// rows 2(l%4), 2(l%4) + 1 (b0) and 8 rows on (b1) of column l/4; d rows l/4
// (d[0], d[1]) and l/4 + 8 (d[2], d[3]) at the columns 2(l%4), 2(l%4) + 1.
// The layout of a and d is that of 16 columns of a wgmma accumulator.
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[64 x 56] (+)= a[64 x 16] * b[16 x 56] with the operands the other way
// round: a MN-major (m contiguous: a [k, m] tile as TMA lands it from a
// row-major [K, M] matrix), b K-major (rows of n, k contiguous), both bf16
// in shared memory, d f32 in registers, 28 of them a thread. accumulate = 0
// overwrites d. In d a thread of warp w and lane l holds, for j = 0..6, rows
// (of m) 16w + l/4 (d[4j], d[4j+1]) and 16w + l/4 + 8 (d[4j+2], d[4j+3]) at
// the columns (of n) 8j + 2(l%4) and 8j + 2(l%4) + 1. (N is any multiple of
// 8 up to 256: another N is this wrapper with N/2 registers.)
__device__ __forceinline__ void wgmma_m64n56k16_tn(float (&d)[28], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27}, "
      "%28, %29, p, 1, 1, 1, 0;\n"  // scale-d, +a, +b, a MN-major, b K-major
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---- tensor maps (host) -------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, which the CUDA runtime has loaded; null
// when that library lacks it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return libcuda ? reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"))
                   : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major bf16 matrix [rows, cols] (cols contiguous, a
// multiple of 8) cut into boxes of box_rows x box_cols (box_cols * 2 = 128
// bytes) that land in shared memory under the 128-byte swizzle. Encoding is
// host arithmetic only: no device call, no allocation.
inline bool encode_bf16_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                            uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_bf16_map through a cache keyed by (base, rows, cols, box): a map is
// a pure function of its key, so a hit can never be stale. For the weights'
// maps, which stay for the life of the packed weights; maps of buffers that
// are allocated anew each forward are encoded directly. The table is small
// and replaces its entries in turn.
inline bool cached_bf16_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                            uint32_t box_rows, uint32_t box_cols) {
  struct Slot {
    const void* base;
    uint64_t rows, cols;
    uint32_t box_rows, box_cols;
    CUtensorMap map;
  };
  constexpr int SLOTS = 64;
  static Slot slots[SLOTS];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Slot& s = slots[i];
    if (s.base == base && s.rows == rows && s.cols == cols && s.box_rows == box_rows &&
        s.box_cols == box_cols) {
      *map = s.map;
      return true;
    }
  }
  if (!encode_bf16_map(map, base, rows, cols, box_rows, box_cols)) return false;
  int slot = used;
  if (used < SLOTS) {
    ++used;
  } else {
    slot = next;
    next = (next + 1) % SLOTS;
  }
  slots[slot] = Slot{base, rows, cols, box_rows, box_cols, *map};
  return true;
}

// A kernel's dynamic shared memory limit, raised to `bytes` on the current
// device at most once per size: `limits` is the kernel's own table of what
// each device was last set to. A launch that finds its size set makes no
// attribute call, so a launch under CUDA graph capture (after a warm-up
// launch) makes none.
constexpr int MAX_DEVICES = 64;
template <typename Kernel>
inline cudaError_t raise_smem_limit(int (&limits)[MAX_DEVICES], Kernel kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  if (limits[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) limits[dev] = bytes;
  return err;
}

}  // namespace hopper
