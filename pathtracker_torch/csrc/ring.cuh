// The pieces of the InT cell's ring kernels, shared by csrc/int_cell.cu
// (k2_inhibition forward) and csrc/int_cell_bwd.cu (K1, K2 and K3
// backward). Its definitions sit in an anonymous namespace, so each library
// keeps its own copy; ops/_native.py hashes the header into the library name
// of every source that includes it.
//
// A ring kernel gives each warp 16 rows at a time (the M of
// mma.sync.m16n8k16) and works in the accumulator fragment's layout: lane
// (g, t) = (lane / 4, lane % 4) holds channels 8n + 2t, 8n + 2t + 1 (n =
// 0..3) of rows g and g + 8. Read from the staged rows in that layout, an
// f32 input rounds straight into the A fragment of x @ W (two adjacent n8
// tiles are one k16 step) and a bf16 input is one already. Every warp fills
// its own ring of stages in dynamic shared memory with cp.async, 16 bytes a
// lane, a tile ahead of the one it computes; the 16-byte chunks of a staged
// row are XOR-swizzled by the row so that the fragment-layout reads hit
// every bank once. Outputs are written over the staged input of the same
// type and position and copied out 16 bytes a lane.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int C = 32;
constexpr int MROWS = 16;            // rows of a warp's tile: the M of the mma
constexpr int NT = C / 8;            // n8 tiles across the channels
constexpr int KS = C / 16;           // k16 steps across the channels
constexpr int F32_SLOT = MROWS * C;  // floats of one staged f32 input
constexpr int B16_SLOT = MROWS * C / 2;  // 32-bit words of one staged bf16 input
constexpr int FRAGS = KS * NT * 32;  // uint2 entries of one matrix as B fragments

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// A gate's sigmoid: the accurate expf, a 2-ulp quotient.
__device__ __forceinline__ float gate_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + expf(-x));
}

// c += a @ b: m16n8k16, bf16 operands, f32 accumulation. Lane (g, t):
//   a[0] rows g, k 2t..2t+1 | a[1] rows g+8 | a[2], a[3] the same at k + 8
//   b0 k 2t..2t+1, column g | b1 the same at k + 8
//   c[0..1] row g, columns 2t..2t+1 | c[2..3] row g+8
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An 8x8 bf16 block held one register a lane (lane (g, t): row g, columns
// 2t..2t+1) -> its transpose in the same layout.
__device__ __forceinline__ unsigned transpose_8x8(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// 16 bytes global -> shared, asynchronously; zeros where `valid` is false.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this lane's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where logical 16-byte chunk j of row r sits within its staged row: 8
// chunks an f32 row, 4 a bf16 row. Rows r and r + 8 swizzle alike.
template <int CHUNKS>
__device__ __forceinline__ int swizzle(int r, int j) {
  return CHUNKS == 8 ? j ^ (((r & 3) << 1) | ((r >> 2) & 1)) : j ^ ((r >> 1) & 3);
}

// The warp's 16 rows from `row0` of a [rows, 32] array -> a staged slot.
template <int CHUNKS>
__device__ __forceinline__ void stage_in(void* slot, const void* src, long long row0,
                                         long long rows, int lane) {
  const char* base = static_cast<const char*>(src);
  char* dst = static_cast<char*>(slot);
#pragma unroll
  for (int i = lane; i < MROWS * CHUNKS; i += 32) {
    const int r = i / CHUNKS, j = i % CHUNKS;
    const bool in = row0 + r < rows;
    cp_async_16(dst + (r * CHUNKS + swizzle<CHUNKS>(r, j)) * 16,
                in ? base + ((row0 + r) * CHUNKS + j) * 16 : base, in);
  }
}

// A staged slot -> the warp's rows of a [rows, 32] array, 16 bytes a lane.
template <int CHUNKS>
__device__ __forceinline__ void stage_out(void* dst, const void* slot, long long row0,
                                          long long rows, int lane) {
  char* base = static_cast<char*>(dst);
  const char* src = static_cast<const char*>(slot);
#pragma unroll
  for (int i = lane; i < MROWS * CHUNKS; i += 32) {
    const int r = i / CHUNKS, j = i % CHUNKS;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(base + ((row0 + r) * CHUNKS + j) * 16) =
          *reinterpret_cast<const uint4*>(src + (r * CHUNKS + swizzle<CHUNKS>(r, j)) * 16);
  }
}

// A [C, C] bf16 matrix as the mma's B fragments, by the whole block:
// frag[(ks * NT + nt) * 32 + lane] is lane's (b0, b1) for k step ks and n
// tile nt of B[k][n] = w[k][n] (x @ w), or of B[k][n] = w[n][k] (d @ w^T).
template <bool TRANSPOSED>
__device__ __forceinline__ void load_b_fragments(const bf16* __restrict__ w, uint2* frag) {
  for (int i = threadIdx.x; i < FRAGS; i += blockDim.x) {
    const int lane = i & 31, nt = (i >> 5) % NT, ks = i / (32 * NT);
    const int n = nt * 8 + (lane >> 2), k = ks * 16 + 2 * (lane & 3);
    unsigned r[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = k + 8 * j;
      const unsigned lo = __bfloat16_as_ushort(TRANSPOSED ? w[n * C + kk] : w[kk * C + n]);
      const unsigned hi =
          __bfloat16_as_ushort(TRANSPOSED ? w[n * C + kk + 1] : w[(kk + 1) * C + n]);
      r[j] = lo | (hi << 16);
    }
    frag[i] = make_uint2(r[0], r[1]);
  }
}

// A warp's walk over its tiles of 16 rows (tile i of the warp is item
// blockIdx.x * WARPS + warp + i * gridDim.x * WARPS) through its ring of
// STAGES stages: load(stage, item) issues a tile's cp.async copies into a
// stage, STAGES - 1 tiles ahead; tile(stage, item) runs once that tile has
// landed, computes it and copies its outputs out. cp.async.wait_group and
// __syncwarp are the only synchronisation: a warp's stages are its own.
template <int WARPS, int STAGES, typename Load, typename Tile>
__device__ __forceinline__ void ring_loop(long long rows, int warp, Load load, Tile tile) {
  const long long items = (rows + MROWS - 1) / MROWS;
  const long long stride = (long long)gridDim.x * WARPS;
  long long item = (long long)blockIdx.x * WARPS + warp;
  long long next = item;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (next < items) load(s, next);
    cp_async_commit();
    next += stride;
  }
  int stage = 0;
  for (; item < items; item += stride) {
    // Refill the stage the previous tile left, then wait for this tile's.
    const int refill = stage == 0 ? STAGES - 1 : stage - 1;
    if (next < items) load(refill, next);
    cp_async_commit();
    next += stride;
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    tile(stage, item);
    __syncwarp();  // the stage is free for the next refill
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

// Where lane (g, t) finds its channel pair of row g in a staged slot, per n
// tile: a float index (f32 slot) and a word index (bf16 slot). Row g + 8 is
// 8 * C floats, or 4 * C words, further on.
struct LaneOffsets {
  int f32[NT], b16[NT];
  __device__ __forceinline__ LaneOffsets(int g, int t) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      f32[nt] = g * C + swizzle<8>(g, 2 * nt + (t >> 1)) * 4 + 2 * (t & 1);
      b16[nt] = g * (C / 2) + swizzle<4>(g, nt) * 4 + t;
    }
  }
};

// The index of (n tile, row half) in an A fragment built from values in the
// accumulator layout: [nt / 2] is the k step, this the register.
__device__ __forceinline__ constexpr int a_reg(int nt, int half) { return (nt & 1) * 2 + half; }

// Resident blocks of `warps` warps for the ring kernel `kernel` with `smem`
// bytes of dynamic shared memory, which it is allowed here, once (each
// kernel has a signature of its own); capped at the blocks that have a tile
// for every warp. Returns the grid, or minus the CUDA error.
template <typename K>
int ring_grid_for(K kernel, int warps, int smem, long long rows) {
  static long long resident = 0;
  if (resident == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -(int)err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
    if (per_sm <= 0) return -(int)cudaErrorLaunchOutOfResources;
    resident = (long long)(sms > 0 ? sms : 1) * per_sm;
  }
  const long long tiles = (rows + MROWS * warps - 1) / (MROWS * warps);
  return (int)(tiles < resident ? tiles : resident);
}

bool aligned_16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return false;
  return true;
}

}  // namespace
