// Backward halves of the InT cell's three fused elementwise/gate phases,
// hand-written for Hopper (sm_90a).
//
// Replaces (Pallas kernels of pathtracker_tpu/ops/int_fused.py):
//   k1_attention_bwd   <- _k1_bwd, pallas_call at :206 (_k1_bwd_kernel :160-175)
//   k2_inhibition_bwd  <- _k2_bwd, pallas_call at :332 (_k2_bwd_kernel :254-297)
//   k3_excitation_bwd  <- _k3_bwd, pallas_call at :467 (_k3_bwd_kernel :388-435)
// The plain PyTorch versions are pathtracker_torch/ops/int_fused.py::*_bwd_plain.
//
// Each kernel recomputes its phase's forward from the phase's inputs, then
// writes the row cotangents and every cross-row reduction: the [32, 32]
// weight gradients (x^T @ dpre) and the per-channel column sums. No float
// atomics anywhere: a block's rows, the order in which its warps are summed
// and the order of the sum over blocks are all fixed, so two launches on the
// same inputs give the same bits.
//
// Layout: as csrc/int_cell.cu — channels-last rows [R, 32], [32, 32] bf16
// gate matrices w[k][c] (k = input channel), [32] f32 vectors.
//
// Bound: device-memory bytes. K1 moves 14 B per row element (18 B with a
// cotangent for the attention map), K2 24 B, K3 36 B, against 3, 3 and 6
// 32-term products per element. On the f32 CUDA cores those products alone
// (192-384 FLOP and 8-14 FLOP/B) cost more instruction slots and shared-memory
// wavefronts than the bytes cost time, so K2 and K3, the two largest, run
// them on the tensor cores, where they are ~3 instructions a row. What is
// left (scripts/torch_bwd_probe.py, NVIDIA H100 80GB HBM3, 700 W): K3 is
// bound by moving its bytes, reads and writes together at ~2.65 TB/s; K2
// by its transcendentals (3 expf, 2 log1pf, 3 quotients an element), which
// 8 warps an SM do not hide.
//
// K1 (k1_bwd_kernel) keeps the first design:
//   * A block of 8 warps takes tiles of 32 rows, 4 rows per warp; lane c owns
//     channel c; every global access is a warp-wide contiguous row segment.
//     A warp's rows are its own, so staging a row in shared memory needs
//     __syncwarp only.
//   * The gate matrix sits in shared memory as f32, padded to 33 floats a
//     row; every product runs k-outer over the warp's 4 rows on the CUDA
//     cores; lane c keeps its column of the weight gradient in 32 registers.
//   * One partial per block of each reduction goes to a [blocks, ...] f32
//     workspace that the wrapper sums over the block axis.
//
// K2 and K3 (k2_bwd_kernel, k3_bwd_kernel), for the bound:
//   * Products: mma.sync.m16n8k16, bf16 operands, f32 accumulation. A warp
//     owns 16 rows. Everything elementwise works in the accumulator
//     fragment's layout: lane (g, t) = (lane / 4, lane % 4) holds channels
//     8n + 2t, 8n + 2t + 1 (n = 0..3) of rows g and g + 8. Read from the
//     staged rows in that layout, an f32 input rounds straight into the A
//     fragment of x @ W (two adjacent n8 tiles are one k16 step) and a bf16
//     input is one already; dgpre, rounded to bf16 once, is the A fragment
//     of dgpre @ W^T in the same way. The weight gradient x^T @ dgpre has
//     the rows as its K dimension: both operands are the same registers
//     transposed 8x8 block by block with movmatrix, and the [32, 32] f32 sum
//     stays in 32 accumulator registers a matrix across all of a warp's
//     tiles. The gate matrices are turned into B fragments for W and for
//     W^T once per block and read back from shared memory, one conflict-free
//     8-byte load a fragment. wgmma is not used: all products together are
//     ~1.6 GFLOP, microseconds at a fraction of the tensor cores' rate.
//   * Loads in flight while a tile is computed: every warp has its own ring
//     of two stages in dynamic shared memory and fills it with cp.async, 16
//     bytes a lane, one tile ahead of the one it works on (80 KB in flight
//     an SM for K3); cp.async.wait_group and __syncwarp are the only
//     synchronisation in the loop, no block barrier. The 16-byte chunks of a
//     row are stored XOR-swizzled by the row so that the fragment-layout
//     reads (8 bytes of an f32 row, 4 of a bf16 row, 8 rows a warp) hit
//     every bank once.
//   * Stores: each lane writes its outputs over the staged input of the same
//     type and position (dconv over conv, dinh over inh, ...), and the warp
//     then copies the finished rows out 16 bytes a lane, fully coalesced.
//   * Rows past the end are zero-filled by cp.async (source size 0) with a
//     zero cotangent, which makes every one of their cotangents and
//     reduction terms exactly zero; they are not copied out.
//   * Reductions finished inside the launch: a block sums its warps' weight
//     gradients and column sums through the idle ring in warp order and
//     writes one f32 partial to the wrapper's [blocks, ...] workspace; the C
//     function then launches finish_kernel on the same stream, which sums
//     the partials in a fixed order, rounds the weight gradients to bf16
//     once and writes the final [32, 32] and [7, 32] results.
//   * Transcendentals: softplus and sigmoid of one argument share one
//     exponential, and the sigmoids divide with __fdividef; computed apiece
//     with IEEE quotients they, not the bytes, bounded K2.
//   * One block of 8 warps an SM, so that a thread may take 255 registers:
//     32 (K2) or 64 (K3) of weight gradient and 40 of column sums live
//     across the tile loop. More warps an SM spill and run slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int C = 32;
constexpr int LD = C + 1;  // padded leading dimension of a matrix in smem
constexpr int WARPS = 8;  // K1: warps a block
constexpr int RPW = 4;    // K1: rows per warp
constexpr int TILE = WARPS * RPW;
constexpr int THREADS = WARPS * 32;
constexpr int NRED = 7;  // per-channel column sums of K2 and K3

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Row-major [C, C] bf16 matrix -> padded f32 smem copy, by the whole block.
__device__ __forceinline__ void load_matrix(const bf16* __restrict__ w, float* s_w) {
  for (int i = threadIdx.x; i < C * C; i += THREADS)
    s_w[(i / C) * LD + (i % C)] = __bfloat162float(w[i]);
}

// out[i] += sum_k rows[i][k] * w[k][lane] for the warp's RPW staged rows.
__device__ __forceinline__ void dot_cols(const float (*rows)[C], const float* s_w,
                                         int lane, float (&out)[RPW]) {
#pragma unroll
  for (int k = 0; k < C; k += 4) {
    const float w0 = s_w[k * LD + lane], w1 = s_w[(k + 1) * LD + lane],
                w2 = s_w[(k + 2) * LD + lane], w3 = s_w[(k + 3) * LD + lane];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(&rows[i][k]);
      out[i] = fmaf(v.x, w0, out[i]);
      out[i] = fmaf(v.y, w1, out[i]);
      out[i] = fmaf(v.z, w2, out[i]);
      out[i] = fmaf(v.w, w3, out[i]);
    }
  }
}

// out[i] += sum_j rows[i][j] * w[lane][j]: the product with w transposed.
__device__ __forceinline__ void dot_rows(const float (*rows)[C], const float* s_w,
                                         int lane, float (&out)[RPW]) {
#pragma unroll
  for (int j = 0; j < C; j += 4) {
    const float w0 = s_w[lane * LD + j], w1 = s_w[lane * LD + j + 1],
                w2 = s_w[lane * LD + j + 2], w3 = s_w[lane * LD + j + 3];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(&rows[i][j]);
      out[i] = fmaf(v.x, w0, out[i]);
      out[i] = fmaf(v.y, w1, out[i]);
      out[i] = fmaf(v.z, w2, out[i]);
      out[i] = fmaf(v.w, w3, out[i]);
    }
  }
}

// acc[k] += sum_i rows[i][k] * d[i]: this lane's column of x^T @ d.
__device__ __forceinline__ void outer_acc(const float (*rows)[C], const float (&d)[RPW],
                                          float (&acc)[C]) {
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&rows[i][k]);
      acc[k] = fmaf(v.x, d[i], acc[k]);
      acc[k + 1] = fmaf(v.y, d[i], acc[k + 1]);
      acc[k + 2] = fmaf(v.z, d[i], acc[k + 2]);
      acc[k + 3] = fmaf(v.w, d[i], acc[k + 3]);
    }
  }
}

// Sum acc[0..N) over the block's 8 warps in a fixed tree (8 -> 4 -> 2 -> 1)
// through s_part[WARPS / 2][N][C]; warp 0 then writes out[k * C + lane].
template <int N>
__device__ __forceinline__ void block_reduce_store(float (&acc)[N], float* s_part,
                                                   float* __restrict__ out, int lane,
                                                   int warp) {
#pragma unroll
  for (int half = WARPS / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int k = 0; k < N; ++k) s_part[((warp - half) * N + k) * C + lane] = acc[k];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] += s_part[(warp * N + k) * C + lane];
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k * C + lane] = acc[k];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
k1_bwd_kernel(const float* __restrict__ exc, const bf16* __restrict__ att_x,
              const bf16* __restrict__ a_u, const float* __restrict__ a_u_b,
              const bf16* __restrict__ dgated, const float* __restrict__ datt,
              float* __restrict__ dexc, bf16* __restrict__ dattx,
              float* __restrict__ ws_dau, float* __restrict__ ws_db, long long rows) {
  __shared__ float s_w[C * LD];
  __shared__ __align__(16) float s_x[TILE][C];  // bf16-rounded exc rows
  __shared__ __align__(16) float s_d[TILE][C];  // bf16-rounded dpre rows
  __shared__ float s_part[(WARPS / 2) * C * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_matrix(a_u, s_w);
  const float b = a_u_b[lane];
  float acc_w[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc_w[k] = 0.0f;
  float acc_b[1] = {0.0f};
  __syncthreads();
  const float(*my_x)[C] = &s_x[warp * RPW];
  const float(*my_d)[C] = &s_d[warp * RPW];
  const long long tiles = (rows + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float x[RPW], ax[RPW], dg[RPW], da[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      const bool in = row < rows;
      const long long idx = row * C + lane;
      x[i] = in ? exc[idx] : 0.0f;
      ax[i] = in ? __bfloat162float(att_x[idx]) : 0.0f;
      dg[i] = in ? __bfloat162float(dgated[idx]) : 0.0f;
      da[i] = (in && datt != nullptr) ? datt[idx] : 0.0f;
      s_x[warp * RPW + i][lane] = bf16_round(x[i]);
    }
    __syncwarp();
    float pre[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) pre[i] = 0.0f;
    dot_cols(my_x, s_w, lane, pre);
    float att[RPW], dpre_bf[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      att[i] = sigmoid(ax[i] + pre[i] + b);
      const float dpre = (dg[i] * x[i] + da[i]) * att[i] * (1.0f - att[i]);
      acc_b[0] += dpre;
      dpre_bf[i] = bf16_round(dpre);
      s_d[warp * RPW + i][lane] = dpre_bf[i];
    }
    __syncwarp();
    float back[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) back[i] = 0.0f;
    dot_rows(my_d, s_w, lane, back);
    outer_acc(my_x, dpre_bf, acc_w);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      if (row < rows) {
        dexc[row * C + lane] = dg[i] * att[i] + back[i];
        dattx[row * C + lane] = __float2bfloat16_rn(dpre_bf[i]);
      }
    }
    __syncwarp();  // the next tile overwrites the staged rows
  }
  block_reduce_store<C>(acc_w, s_part, ws_dau + (long long)blockIdx.x * C * C, lane, warp);
  block_reduce_store<1>(acc_b, s_part, ws_db + (long long)blockIdx.x * C, lane, warp);
}

// ---- K2 and K3 backward: tensor-core products, one cp.async ring a warp ----

// Warps a block and stages a warp (one block an SM). Measured alternatives
// (scripts/torch_bwd_probe.py, 131,072 rows, NVIDIA H100 80GB HBM3 at 700 W):
// K2 with 3 stages, K3 with 7 warps of 3 stages gain nothing; 10 or 12
// warps lose to the smaller register budget.
constexpr int K2_WARPS = 8, K2_STAGES = 2;
constexpr int K3_WARPS = 8, K3_STAGES = 2;
constexpr int MROWS = 16;                   // rows of a warp's tile: the M of the mma
constexpr int NT = C / 8;                   // n8 tiles across the channels
constexpr int KS = C / 16;                  // k16 steps across the channels
constexpr int F32_SLOT = MROWS * C;         // floats of one staged f32 input
constexpr int B16_SLOT = MROWS * C / 2;     // 32-bit words of one staged bf16 input
constexpr int FRAGS = KS * NT * 32;         // uint2 entries of one matrix as B fragments
constexpr int NVEC = 7;                     // per-channel vectors kept in shared memory
constexpr int NSUM = 5;                     // per-channel sums a lane accumulates
constexpr int K2_STAGE_BYTES = (2 * F32_SLOT + 3 * B16_SLOT) * 4;  // inh dnew | conv inp gi_x
constexpr int K3_STAGE_BYTES = (4 * F32_SLOT + 2 * B16_SLOT) * 4;  // new_inh inh exc dnew | conv gated
constexpr int K2_PARTIAL = C * C + NRED * C;      // floats of a block's partial: di_u, sums
constexpr int K3_PARTIAL = 2 * C * C + NRED * C;  // de_w, de_u, sums
constexpr int K2_SMEM = 2 * FRAGS * 8 + NVEC * C * 4 + K2_WARPS * K2_STAGES * K2_STAGE_BYTES;
constexpr int K3_SMEM = 4 * FRAGS * 8 + NVEC * C * 4 + K3_WARPS * K3_STAGES * K3_STAGE_BYTES;
static_assert(K2_PARTIAL * 4 <= K2_STAGES * K2_STAGE_BYTES &&
              K3_PARTIAL * 4 <= K3_STAGES * K3_STAGE_BYTES,
              "the block's reduction reuses the ring");
static_assert(K2_SMEM <= 232448 && K3_SMEM <= 232448, "227 KB of shared memory a block");
constexpr int FINISH_GROUPS = 8;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// jax.nn.softplus(x) = max(x, 0) + log1p(exp(-|x|)) and sigmoid(x) = (x >= 0
// ? 1 : e) / (1 + e) from one exponential, e = exp(-|x|): the
// transcendentals, not the bytes, bound K2 while each was computed alone.
// expf and log1pf stay the accurate ones (the approximate __expf/__logf
// triple the bf16 flips of dgpre); the quotient is 2 ulp.
__device__ __forceinline__ void softplus_sigmoid(float x, float& sp, float& sg) {
  const float e = expf(-fabsf(x));
  sp = fmaxf(x, 0.0f) + log1pf(e);
  sg = __fdividef(x >= 0.0f ? 1.0f : e, 1.0f + e);
}

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

// acc[mt][nt] += x^T @ d over the tile's 16 rows: x, d as A fragments of the
// row-major products (x[ks], d via dt[nt] = its transposed blocks).
__device__ __forceinline__ void wgrad_acc(float (&acc)[2][NT][4], const unsigned (&x)[KS][4],
                                          const unsigned (&dt)[NT][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const unsigned xt[4] = {transpose_8x8(x[mt][0]), transpose_8x8(x[mt][2]),
                            transpose_8x8(x[mt][1]), transpose_8x8(x[mt][3])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], xt, dt[nt][0], dt[nt][1]);
  }
}

// A warp's [32, 32] weight-gradient accumulators -> part[k * C + c].
__device__ __forceinline__ void store_wgrad(const float (&acc)[2][NT][4], float* part, int g,
                                            int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = part + (mt * 16 + g) * C + nt * 8 + 2 * t;
      p[0] = acc[mt][nt][0];
      p[1] = acc[mt][nt][1];
      p[8 * C] = acc[mt][nt][2];
      p[8 * C + 1] = acc[mt][nt][3];
    }
}

// A warp's per-channel sums (each lane: its channel pairs, rows g and g+8 of
// every tile), summed over the 8 row groups in a fixed butterfly, -> the
// NRED sums of the interface, part[i * C + c]. A lane accumulates
//   [dgpre, dlin * x, dlin, dbn, dbn * (conv - mean)]
// (x the state that lin scales) and, with dxn = dbn * scale and xn =
// (conv - mean) * rstd, the batch-norm sums follow per channel:
//   dmean = sum(-dxn) * rstd, drstd = sum(dxn * (conv - mean)),
//   dscale = sum(dbn * xn), dbias = sum(dbn).
__device__ __forceinline__ void store_sums(const float (&red)[NT][2][NSUM], const float* vec,
                                           float* part, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v[NSUM];
#pragma unroll
      for (int i = 0; i < NSUM; ++i) {
        v[i] = red[nt][e][i];
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 4);
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 8);
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 16);
      }
      if (g == 0) {
        const int c = nt * 8 + 2 * t + e;
        const float rstd = vec[1 * C + c], scale = vec[2 * C + c];
        part[0 * C + c] = v[0];
        part[1 * C + c] = v[1];
        part[2 * C + c] = v[2];
        part[3 * C + c] = -(v[3] * scale) * rstd;
        part[4 * C + c] = v[4] * scale;
        part[5 * C + c] = v[4] * rstd;
        part[6 * C + c] = v[3];
      }
    }
}

// Sum the warps' partials (part[warp][n], in the idle ring) in warp order
// into this block's row of the workspace.
template <int WARPS>
__device__ __forceinline__ void block_partial(const float* part, int n, float* __restrict__ ws) {
  for (int e = threadIdx.x; e < n; e += WARPS * 32) {
    float s = part[e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += part[w * n + e];
    ws[(long long)blockIdx.x * n + e] = s;
  }
}

__global__ void __launch_bounds__(K2_WARPS * 32, 1)
k2_bwd_kernel(const bf16* __restrict__ conv_i, const float* __restrict__ mean0,
              const float* __restrict__ rstd0, const float* __restrict__ scale0,
              const float* __restrict__ bias0, const bf16* __restrict__ inp,
              const bf16* __restrict__ gi_x, const float* __restrict__ inh,
              const bf16* __restrict__ i_u, const float* __restrict__ i_u_b,
              const float* __restrict__ alpha, const float* __restrict__ mu,
              const float* __restrict__ dnew, bf16* __restrict__ dconv,
              bf16* __restrict__ dinp, bf16* __restrict__ dgix, float* __restrict__ dinh,
              float* __restrict__ ws, long long rows) {
  extern __shared__ uint4 dyn_smem[];
  uint2* frag = reinterpret_cast<uint2*>(dyn_smem);        // i_u, i_u^T
  float* vec = reinterpret_cast<float*>(frag + 2 * FRAGS);  // [NVEC][C]
  char* ring = reinterpret_cast<char*>(vec + NVEC * C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  load_b_fragments<false>(i_u, frag);
  load_b_fragments<true>(i_u, frag + FRAGS);
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    vec[0 * C + c] = mean0[c];
    vec[1 * C + c] = rstd0[c];
    vec[2 * C + c] = scale0[c];
    vec[3 * C + c] = bias0[c];
    vec[4 * C + c] = i_u_b[c];
    vec[5 * C + c] = alpha[c];
    vec[6 * C + c] = mu[c];
  }
  __syncthreads();

  const LaneOffsets at(g, t);
  float acc_w[2][NT][4];
  float red[NT][2][NSUM];  // [dgpre, dlin*inh, dlin, dbn0, dbn0*(conv-mean)]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_w[0][nt][i] = acc_w[1][nt][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NSUM; ++i) red[nt][0][i] = red[nt][1][i] = 0.0f;
  }

  char* my_ring = ring + warp * (K2_STAGES * K2_STAGE_BYTES);
  auto load = [&](int stage, long long item) {
    float* f = reinterpret_cast<float*>(my_ring + stage * K2_STAGE_BYTES);
    unsigned* h = reinterpret_cast<unsigned*>(f + 2 * F32_SLOT);
    const long long row0 = item * MROWS;
    stage_in<8>(f, inh, row0, rows, lane);
    stage_in<8>(f + F32_SLOT, dnew, row0, rows, lane);
    stage_in<4>(h, conv_i, row0, rows, lane);
    stage_in<4>(h + B16_SLOT, inp, row0, rows, lane);
    stage_in<4>(h + 2 * B16_SLOT, gi_x, row0, rows, lane);
  };
  const long long items = (rows + MROWS - 1) / MROWS;
  const long long stride = (long long)gridDim.x * K2_WARPS;
  long long item = (long long)blockIdx.x * K2_WARPS + warp;
  long long next = item;
#pragma unroll
  for (int s = 0; s < K2_STAGES - 1; ++s) {
    if (next < items) load(s, next);
    cp_async_commit();
    next += stride;
  }
  int stage = 0;
  for (; item < items; item += stride) {
    // Refill the stage the previous tile left, then wait for this tile's.
    const int refill = stage == 0 ? K2_STAGES - 1 : stage - 1;
    if (next < items) load(refill, next);
    cp_async_commit();
    next += stride;
    cp_async_wait<K2_STAGES - 1>();
    __syncwarp();

    float* s_h = reinterpret_cast<float*>(my_ring + stage * K2_STAGE_BYTES);
    float* s_dn = s_h + F32_SLOT;
    unsigned* s_cv = reinterpret_cast<unsigned*>(s_dn + F32_SLOT);
    unsigned* s_in = s_cv + B16_SLOT;
    unsigned* s_gx = s_in + B16_SLOT;

    // Gate pre-activation inh @ i_u; inh rounds to bf16 into the A fragment.
    unsigned ha[KS][4];
    float gpre[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 h = *reinterpret_cast<const float2*>(&s_h[at.f32[nt] + half * 8 * C]);
        ha[nt / 2][a_reg(nt, half)] = pack_bf16(h.x, h.y);
        gpre[nt][2 * half] = gpre[nt][2 * half + 1] = 0.0f;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = frag[(ks * NT + nt) * 32 + lane];
        mma_bf16(gpre[nt], ha[ks], b.x, b.y);
      }

    // Elementwise, in the accumulator layout. `back` starts as the direct
    // part of dinh and takes dgpre @ i_u^T on top.
    unsigned da[KS][4];
    float back[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c0 = nt * 8 + 2 * t;
      const float2 mean = *reinterpret_cast<const float2*>(&vec[0 * C + c0]);
      const float2 rstd = *reinterpret_cast<const float2*>(&vec[1 * C + c0]);
      const float2 scale = *reinterpret_cast<const float2*>(&vec[2 * C + c0]);
      const float2 bias = *reinterpret_cast<const float2*>(&vec[3 * C + c0]);
      const float2 b = *reinterpret_cast<const float2*>(&vec[4 * C + c0]);
      const float2 al = *reinterpret_cast<const float2*>(&vec[5 * C + c0]);
      const float2 m = *reinterpret_cast<const float2*>(&vec[6 * C + c0]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int fo = at.f32[nt] + half * 8 * C, bo = at.b16[nt] + half * 4 * C;
        const float2 h2 = *reinterpret_cast<const float2*>(&s_h[fo]);
        const float2 dn2 = *reinterpret_cast<const float2*>(&s_dn[fo]);
        const float2 cv2 = unpack_bf16(s_cv[bo]);
        const float2 in2 = unpack_bf16(s_in[bo]);
        const float2 gx2 = unpack_bf16(s_gx[bo]);
        float dconv_[2], dinp_[2], dgpre_[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float h = e ? h2.y : h2.x, dn = e ? dn2.y : dn2.x, cv = e ? cv2.y : cv2.x,
                      in_ = e ? in2.y : in2.x, gx = e ? gx2.y : gx2.x;
          const float mean_ = e ? mean.y : mean.x, rstd_ = e ? rstd.y : rstd.x,
                      scale_ = e ? scale.y : scale.x, bias_ = e ? bias.y : bias.x,
                      b_ = e ? b.y : b.x, al_ = e ? al.y : al.x, m_ = e ? m.y : m.x;
          const float cm = cv - mean_;
          const float xn = cm * rstd_;
          const float bn0 = xn * scale_ + bias_;
          const float lin = al_ * h + m_;
          const float t1 = bn0 * lin;
          float sp_t1, sg_t1, inh_hat, sg_pre2;
          softplus_sigmoid(t1, sp_t1, sg_t1);
          const float pre2 = in_ - sp_t1;
          softplus_sigmoid(pre2, inh_hat, sg_pre2);
          const float gate = gate_sigmoid(gx + gpre[nt][2 * half + e] + b_);
          const float dg = dn * (inh_hat - h);
          const float dgpre = dg * gate * (1.0f - gate);
          const float dpre2 = (dn * gate) * sg_pre2;
          const float dt1 = -dpre2 * sg_t1;
          const float dbn0 = dt1 * lin;
          const float dlin = dt1 * bn0;
          const float dxn = dbn0 * scale_;
          float(&r)[NSUM] = red[nt][e];
          r[0] += dgpre;
          r[1] += dlin * h;
          r[2] += dlin;
          r[3] += dbn0;
          r[4] += dbn0 * cm;
          back[nt][2 * half + e] = dn * (1.0f - gate) + dlin * al_;
          dconv_[e] = dxn * rstd_;
          dinp_[e] = dpre2;
          dgpre_[e] = dgpre;
        }
        const unsigned d = pack_bf16(dgpre_[0], dgpre_[1]);  // dgpre rounds once, here
        da[nt / 2][a_reg(nt, half)] = d;
        s_cv[bo] = pack_bf16(dconv_[0], dconv_[1]);
        s_in[bo] = pack_bf16(dinp_[0], dinp_[1]);
        s_gx[bo] = d;
      }
    }

    // dinh = direct + dgpre @ i_u^T, over the staged inh.
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = frag[FRAGS + (ks * NT + nt) * 32 + lane];
        mma_bf16(back[nt], da[ks], b.x, b.y);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(&s_h[at.f32[nt] + half * 8 * C]) =
            make_float2(back[nt][2 * half], back[nt][2 * half + 1]);

    // di_u += inh^T @ dgpre.
    unsigned dt[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      dt[nt][0] = transpose_8x8(da[nt / 2][a_reg(nt, 0)]);
      dt[nt][1] = transpose_8x8(da[nt / 2][a_reg(nt, 1)]);
    }
    wgrad_acc(acc_w, ha, dt);

    __syncwarp();  // every lane's outputs are staged
    const long long row0 = item * MROWS;
    stage_out<8>(dinh, s_h, row0, rows, lane);
    stage_out<4>(dconv, s_cv, row0, rows, lane);
    stage_out<4>(dinp, s_in, row0, rows, lane);
    stage_out<4>(dgix, s_gx, row0, rows, lane);
    __syncwarp();  // the stage is free for the next refill
    stage = stage + 1 == K2_STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp has left its ring

  float* part = reinterpret_cast<float*>(ring);
  store_wgrad(acc_w, part + warp * K2_PARTIAL, g, t);
  store_sums(red, vec, part + warp * K2_PARTIAL + C * C, g, t);
  __syncthreads();
  block_partial<K2_WARPS>(part, K2_PARTIAL, ws);
}

__global__ void __launch_bounds__(K3_WARPS * 32, 1)
k3_bwd_kernel(const bf16* __restrict__ conv_e, const float* __restrict__ mean1,
              const float* __restrict__ rstd1, const float* __restrict__ scale1,
              const float* __restrict__ bias1, const float* __restrict__ new_inh,
              const float* __restrict__ inh, const bf16* __restrict__ gated,
              const float* __restrict__ exc, const bf16* __restrict__ e_w,
              const float* __restrict__ e_w_b, const bf16* __restrict__ e_u,
              const float* __restrict__ e_u_b, const float* __restrict__ kappa,
              const float* __restrict__ gamma, const float* __restrict__ dnew,
              bf16* __restrict__ dconv, float* __restrict__ dninh,
              float* __restrict__ dinh, bf16* __restrict__ dgated,
              float* __restrict__ dexc, float* __restrict__ ws, long long rows) {
  extern __shared__ uint4 dyn_smem[];
  uint2* frag = reinterpret_cast<uint2*>(dyn_smem);        // e_w, e_u, e_w^T, e_u^T
  float* vec = reinterpret_cast<float*>(frag + 4 * FRAGS);  // [NVEC][C]
  char* ring = reinterpret_cast<char*>(vec + NVEC * C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  load_b_fragments<false>(e_w, frag);
  load_b_fragments<false>(e_u, frag + FRAGS);
  load_b_fragments<true>(e_w, frag + 2 * FRAGS);
  load_b_fragments<true>(e_u, frag + 3 * FRAGS);
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    vec[0 * C + c] = mean1[c];
    vec[1 * C + c] = rstd1[c];
    vec[2 * C + c] = scale1[c];
    vec[3 * C + c] = bias1[c];
    vec[4 * C + c] = e_w_b[c] + e_u_b[c];
    vec[5 * C + c] = kappa[c];
    vec[6 * C + c] = gamma[c];
  }
  __syncthreads();

  const LaneOffsets at(g, t);
  float acc_w[2][NT][4], acc_u[2][NT][4];
  float red[NT][2][NSUM];  // [dgpre, dlin*new_inh, dlin, dbn1, dbn1*(conv-mean)]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc_w[0][nt][i] = acc_w[1][nt][i] = acc_u[0][nt][i] = acc_u[1][nt][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NSUM; ++i) red[nt][0][i] = red[nt][1][i] = 0.0f;
  }

  char* my_ring = ring + warp * (K3_STAGES * K3_STAGE_BYTES);
  auto load = [&](int stage, long long item) {
    float* f = reinterpret_cast<float*>(my_ring + stage * K3_STAGE_BYTES);
    unsigned* h = reinterpret_cast<unsigned*>(f + 4 * F32_SLOT);
    const long long row0 = item * MROWS;
    stage_in<8>(f, new_inh, row0, rows, lane);
    stage_in<8>(f + F32_SLOT, inh, row0, rows, lane);
    stage_in<8>(f + 2 * F32_SLOT, exc, row0, rows, lane);
    stage_in<8>(f + 3 * F32_SLOT, dnew, row0, rows, lane);
    stage_in<4>(h, conv_e, row0, rows, lane);
    stage_in<4>(h + B16_SLOT, gated, row0, rows, lane);
  };
  const long long items = (rows + MROWS - 1) / MROWS;
  const long long stride = (long long)gridDim.x * K3_WARPS;
  long long item = (long long)blockIdx.x * K3_WARPS + warp;
  long long next = item;
#pragma unroll
  for (int s = 0; s < K3_STAGES - 1; ++s) {
    if (next < items) load(s, next);
    cp_async_commit();
    next += stride;
  }
  int stage = 0;
  for (; item < items; item += stride) {
    // Refill the stage the previous tile left, then wait for this tile's.
    const int refill = stage == 0 ? K3_STAGES - 1 : stage - 1;
    if (next < items) load(refill, next);
    cp_async_commit();
    next += stride;
    cp_async_wait<K3_STAGES - 1>();
    __syncwarp();

    float* s_ni = reinterpret_cast<float*>(my_ring + stage * K3_STAGE_BYTES);
    float* s_h = s_ni + F32_SLOT;
    float* s_e = s_h + F32_SLOT;
    float* s_dn = s_e + F32_SLOT;
    unsigned* s_cv = reinterpret_cast<unsigned*>(s_dn + F32_SLOT);
    unsigned* s_ge = s_cv + B16_SLOT;

    // Gate pre-activation inh @ e_w + gated @ e_u in one accumulator; inh
    // rounds to bf16 into its A fragment, gated is bf16 already.
    unsigned ha[KS][4], ga[KS][4];
    float gpre[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 h = *reinterpret_cast<const float2*>(&s_h[at.f32[nt] + half * 8 * C]);
        ha[nt / 2][a_reg(nt, half)] = pack_bf16(h.x, h.y);
        ga[nt / 2][a_reg(nt, half)] = s_ge[at.b16[nt] + half * 4 * C];
        gpre[nt][2 * half] = gpre[nt][2 * half + 1] = 0.0f;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 bw = frag[(ks * NT + nt) * 32 + lane];
        mma_bf16(gpre[nt], ha[ks], bw.x, bw.y);
        const uint2 bu = frag[FRAGS + (ks * NT + nt) * 32 + lane];
        mma_bf16(gpre[nt], ga[ks], bu.x, bu.y);
      }

    // Elementwise, in the accumulator layout.
    unsigned da[KS][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c0 = nt * 8 + 2 * t;
      const float2 mean = *reinterpret_cast<const float2*>(&vec[0 * C + c0]);
      const float2 rstd = *reinterpret_cast<const float2*>(&vec[1 * C + c0]);
      const float2 scale = *reinterpret_cast<const float2*>(&vec[2 * C + c0]);
      const float2 bias = *reinterpret_cast<const float2*>(&vec[3 * C + c0]);
      const float2 b = *reinterpret_cast<const float2*>(&vec[4 * C + c0]);
      const float2 ka = *reinterpret_cast<const float2*>(&vec[5 * C + c0]);
      const float2 gm = *reinterpret_cast<const float2*>(&vec[6 * C + c0]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int fo = at.f32[nt] + half * 8 * C, bo = at.b16[nt] + half * 4 * C;
        const float2 ni2 = *reinterpret_cast<const float2*>(&s_ni[fo]);
        const float2 e2 = *reinterpret_cast<const float2*>(&s_e[fo]);
        const float2 dn2 = *reinterpret_cast<const float2*>(&s_dn[fo]);
        const float2 cv2 = unpack_bf16(s_cv[bo]);
        float dconv_[2], dninh_[2], dexc_[2], dgpre_[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ni = e ? ni2.y : ni2.x, ex = e ? e2.y : e2.x, dn = e ? dn2.y : dn2.x,
                      cv = e ? cv2.y : cv2.x;
          const float mean_ = e ? mean.y : mean.x, rstd_ = e ? rstd.y : rstd.x,
                      scale_ = e ? scale.y : scale.x, bias_ = e ? bias.y : bias.x,
                      b_ = e ? b.y : b.x, ka_ = e ? ka.y : ka.x, gm_ = e ? gm.y : gm.x;
          const float cm = cv - mean_;
          const float xn = cm * rstd_;
          const float bn1 = xn * scale_ + bias_;
          const float lin = ka_ * ni + gm_;
          const float t1 = bn1 * lin;
          float exc_hat, sg_t1;
          softplus_sigmoid(t1, exc_hat, sg_t1);
          const float gate = gate_sigmoid(gpre[nt][2 * half + e] + b_);
          const float dg = dn * (exc_hat - ex);
          const float dgpre = dg * gate * (1.0f - gate);
          const float dt1 = (dn * gate) * sg_t1;
          const float dbn1 = dt1 * lin;
          const float dlin = dt1 * bn1;
          const float dxn = dbn1 * scale_;
          float(&r)[NSUM] = red[nt][e];
          r[0] += dgpre;
          r[1] += dlin * ni;
          r[2] += dlin;
          r[3] += dbn1;
          r[4] += dbn1 * cm;
          dconv_[e] = dxn * rstd_;
          dninh_[e] = dlin * ka_;
          dexc_[e] = dn * (1.0f - gate);
          dgpre_[e] = dgpre;
        }
        da[nt / 2][a_reg(nt, half)] = pack_bf16(dgpre_[0], dgpre_[1]);  // rounds once, here
        s_cv[bo] = pack_bf16(dconv_[0], dconv_[1]);
        *reinterpret_cast<float2*>(&s_ni[fo]) = make_float2(dninh_[0], dninh_[1]);
        *reinterpret_cast<float2*>(&s_e[fo]) = make_float2(dexc_[0], dexc_[1]);
      }
    }

    // dinh = dgpre @ e_w^T over the staged inh, dgated = dgpre @ e_u^T over
    // the staged gated.
    {
      float back_w[NT][4], back_u[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) back_w[nt][i] = back_u[nt][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bw = frag[2 * FRAGS + (ks * NT + nt) * 32 + lane];
          mma_bf16(back_w[nt], da[ks], bw.x, bw.y);
          const uint2 bu = frag[3 * FRAGS + (ks * NT + nt) * 32 + lane];
          mma_bf16(back_u[nt], da[ks], bu.x, bu.y);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(&s_h[at.f32[nt] + half * 8 * C]) =
              make_float2(back_w[nt][2 * half], back_w[nt][2 * half + 1]);
          s_ge[at.b16[nt] + half * 4 * C] =
              pack_bf16(back_u[nt][2 * half], back_u[nt][2 * half + 1]);
        }
    }

    // de_w += inh^T @ dgpre, de_u += gated^T @ dgpre.
    unsigned dt[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      dt[nt][0] = transpose_8x8(da[nt / 2][a_reg(nt, 0)]);
      dt[nt][1] = transpose_8x8(da[nt / 2][a_reg(nt, 1)]);
    }
    wgrad_acc(acc_w, ha, dt);
    wgrad_acc(acc_u, ga, dt);

    __syncwarp();  // every lane's outputs are staged
    const long long row0 = item * MROWS;
    stage_out<8>(dninh, s_ni, row0, rows, lane);
    stage_out<8>(dinh, s_h, row0, rows, lane);
    stage_out<8>(dexc, s_e, row0, rows, lane);
    stage_out<4>(dconv, s_cv, row0, rows, lane);
    stage_out<4>(dgated, s_ge, row0, rows, lane);
    __syncwarp();  // the stage is free for the next refill
    stage = stage + 1 == K3_STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp has left its ring

  float* part = reinterpret_cast<float*>(ring);
  store_wgrad(acc_w, part + warp * K3_PARTIAL, g, t);
  store_wgrad(acc_u, part + warp * K3_PARTIAL + C * C, g, t);
  store_sums(red, vec, part + warp * K3_PARTIAL + 2 * C * C, g, t);
  __syncthreads();
  block_partial<K3_WARPS>(part, K3_PARTIAL, ws);
}

// The blocks' partials ws[blocks][per_block] -> the final results: element e
// is summed by 8 groups of blocks (group k takes blocks k, k + 8, ...), then
// over the groups in order; 32 elements a block. The first n_mats * C * C
// elements are weight gradients, rounded to bf16 once, here; the rest are
// the [NRED, C] f32 sums.
__global__ void __launch_bounds__(32 * FINISH_GROUPS)
finish_kernel(const float* __restrict__ ws, int blocks, int per_block, int n_mats,
              bf16* __restrict__ m0, bf16* __restrict__ m1, float* __restrict__ sums) {
  __shared__ float s_group[FINISH_GROUPS][32];
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.0f;
  for (int b = group; b < blocks; b += FINISH_GROUPS) s += ws[(long long)b * per_block + e];
  s_group[group][lane] = s;
  __syncthreads();
  if (group == 0) {
    float total = s_group[0][lane];
#pragma unroll
    for (int k = 1; k < FINISH_GROUPS; ++k) total += s_group[k][lane];
    if (e < C * C)
      m0[e] = __float2bfloat16_rn(total);
    else if (e < n_mats * C * C)
      m1[e - C * C] = __float2bfloat16_rn(total);
    else
      sums[e - n_mats * C * C] = total;
  }
}

// Resident blocks for K1's `kernel` on the current device, capped at the
// tile count. Queried once per kernel: the port drives one card per process.
template <typename K>
int grid_for(K kernel, long long rows) {
  static long long resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    resident = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (rows + TILE - 1) / TILE;
  return (int)(tiles < resident ? tiles : resident);
}

// The same for a ring kernel with `smem` bytes of dynamic shared memory,
// which it is allowed here, once; capped at the blocks that have a tile for
// every warp. Returns the grid, or minus the CUDA error.
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

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// <kernel>_blocks(rows): the grid the launch below uses, which is the leading
// size of its partial workspace(s): K1 [blocks, 32, 32] and [blocks, 1, 32],
// K2 [blocks, 32 + 7, 32], K3 [blocks, 64 + 7, 32], all f32.
int k1_attention_bwd_blocks(long long rows) { return rows > 0 ? grid_for(k1_bwd_kernel, rows) : 0; }
int k2_inhibition_bwd_blocks(long long rows) {
  return rows > 0 ? ring_grid_for(k2_bwd_kernel, K2_WARPS, K2_SMEM, rows) : 0;
}
int k3_excitation_bwd_blocks(long long rows) {
  return rows > 0 ? ring_grid_for(k3_bwd_kernel, K3_WARPS, K3_SMEM, rows) : 0;
}

// `datt` may be null: the attention map had no cotangent (read as zeros).
int k1_attention_bwd(const void* exc, const void* att_x, const void* a_u,
                     const void* a_u_b, const void* dgated, const void* datt,
                     void* dexc, void* dattx, void* ws_dau, void* ws_db,
                     long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  k1_bwd_kernel<<<grid_for(k1_bwd_kernel, rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)exc, (const bf16*)att_x, (const bf16*)a_u, (const float*)a_u_b,
      (const bf16*)dgated, (const float*)datt, (float*)dexc, (bf16*)dattx,
      (float*)ws_dau, (float*)ws_db, rows);
  return (int)cudaGetLastError();
}

// Two kernels on `stream`: the phase, then the sum over its blocks. di_u is
// [32, 32] bf16; sums [7, 32] f32 = [di_u_b, dalpha, dmu, dmean, drstd,
// dscale, dbias]; ws the f32 workspace sized by k2_inhibition_bwd_blocks.
// Row arrays must be 16-byte aligned (cp.async).
int k2_inhibition_bwd(const void* conv_i, const void* mean0, const void* rstd0,
                      const void* scale0, const void* bias0, const void* inp,
                      const void* gi_x, const void* inh, const void* i_u,
                      const void* i_u_b, const void* alpha, const void* mu,
                      const void* dnew, void* dconv, void* dinp, void* dgix,
                      void* dinh, void* di_u, void* sums, void* ws, long long rows,
                      void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned_16({conv_i, inp, gi_x, inh, dnew, dconv, dinp, dgix, dinh}))
    return (int)cudaErrorMisalignedAddress;
  const int blocks = ring_grid_for(k2_bwd_kernel, K2_WARPS, K2_SMEM, rows);
  if (blocks <= 0) return blocks < 0 ? -blocks : (int)cudaErrorInvalidValue;
  k2_bwd_kernel<<<blocks, K2_WARPS * 32, K2_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)conv_i, (const float*)mean0, (const float*)rstd0,
      (const float*)scale0, (const float*)bias0, (const bf16*)inp,
      (const bf16*)gi_x, (const float*)inh, (const bf16*)i_u, (const float*)i_u_b,
      (const float*)alpha, (const float*)mu, (const float*)dnew, (bf16*)dconv,
      (bf16*)dinp, (bf16*)dgix, (float*)dinh, (float*)ws, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<K2_PARTIAL / 32, 32 * FINISH_GROUPS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, blocks, K2_PARTIAL, 1, (bf16*)di_u, nullptr, (float*)sums);
  return (int)cudaGetLastError();
}

// As k2_inhibition_bwd; sums = [de_w_b = de_u_b, dkappa, dgamma, dmean,
// drstd, dscale, dbias].
int k3_excitation_bwd(const void* conv_e, const void* mean1, const void* rstd1,
                      const void* scale1, const void* bias1, const void* new_inh,
                      const void* inh, const void* gated, const void* exc,
                      const void* e_w, const void* e_w_b, const void* e_u,
                      const void* e_u_b, const void* kappa, const void* gamma,
                      const void* dnew, void* dconv, void* dninh, void* dinh,
                      void* dgated, void* dexc, void* de_w, void* de_u, void* sums,
                      void* ws, long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned_16({conv_e, new_inh, inh, gated, exc, dnew, dconv, dninh, dinh, dgated, dexc}))
    return (int)cudaErrorMisalignedAddress;
  const int blocks = ring_grid_for(k3_bwd_kernel, K3_WARPS, K3_SMEM, rows);
  if (blocks <= 0) return blocks < 0 ? -blocks : (int)cudaErrorInvalidValue;
  k3_bwd_kernel<<<blocks, K3_WARPS * 32, K3_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)conv_e, (const float*)mean1, (const float*)rstd1,
      (const float*)scale1, (const float*)bias1, (const float*)new_inh,
      (const float*)inh, (const bf16*)gated, (const float*)exc, (const bf16*)e_w,
      (const float*)e_w_b, (const bf16*)e_u, (const float*)e_u_b,
      (const float*)kappa, (const float*)gamma, (const float*)dnew, (bf16*)dconv,
      (float*)dninh, (float*)dinh, (bf16*)dgated, (float*)dexc, (float*)ws, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<K3_PARTIAL / 32, 32 * FINISH_GROUPS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, blocks, K3_PARTIAL, 2, (bf16*)de_w, (bf16*)de_u, (float*)sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
