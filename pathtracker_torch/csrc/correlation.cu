// Spatial correlation (cost volume) and its two gradients, hand-written for
// Hopper (sm_90a).
//
// Replaces pathtracker_tpu/ops/correlation.py::correlation_pallas (pallas_call
// at :82, body _corr_kernel :50-66):
//
//   corr[n,y,x,dy*P+dx] = sum_c f1[n,y,x,c] * f2[n, y+dy*dil-r, x+dx*dil-r, c]
//
// with f2 read as zero outside the image, r = (P-1)/2*dil, f1 and f2
// [N,H,W,C] f32, corr [N,H,W,P*P] f32. The JAX package has no Pallas backward
// (its custom VJP goes through the XLA formulation, correlation.py:109-114);
// the port's training path needs one, so this file also holds
//
//   df1[n,y,x,c]   = sum_d g[n,y,x,d] * f2[n, y+dy*dil-r, x+dx*dil-r, c]
//   df2[n,y',x',c] = sum_d g[n,y,x,d] * f1[n,y,x,c],  y = y'-dy*dil+r, x = x'-dx*dil+r
//
// the second in gather form (each output element is summed by one thread over
// the source pixels inside the image), so there are no float atomics and two
// launches give the same bits. The plain PyTorch versions are
// pathtracker_torch/ops/correlation.py::*_plain.
//
// Bound: neither bytes nor operations alone. Per 32x32x64 image with P=15 the
// forward does 29.5 MFLOP on 1.45 MB (f1 + f2 + volume): at the f32 FMA peak
// and at the memory rate both take about the same time. The volume is 64% of
// the bytes, 225 floats (900 B) per pixel.
//
// Forward design. The Pallas kernel holds one whole image (f1 and the padded
// f2, 800 KB) in VMEM; a Hopper block has 227 KB, so the work is tiled:
//   * A block takes a tile of `th` rows x 32 columns of pixels (th = 8 unless
//     the shared-memory tile would not fit), one thread per pixel, a lane per
//     column. Borders are predicated: no padded copy of f2 is made.
//   * Channels go through shared memory in chunks of 16, each pixel's chunk
//     padded to 20 floats, so that a warp's float4 reads of 32 neighbouring
//     pixels touch every bank once.
//   * The accumulators have to live across the channel chunks, so a block
//     takes only 5 dy x 15 dx displacements (75 registers) and the
//     displacement groups are spread over the grid. The thread keeps its own
//     f1 chunk in registers and reads the f2 window from shared memory: one
//     shared-memory float per FMA, which is what limits it. The block's
//     outputs are staged in shared memory and written as runs of 5*P
//     contiguous floats per pixel, lanes along the run, because a lane per
//     pixel would write 4 bytes every 900.
//
// Backward design (corr_bwd_kernel; both gradients, one kernel). Per image
// at P=15 each moves 1.45 MB, 64% of it the cotangent g (900 B a pixel), and
// does 29.5 MFLOP (23.0 inside the image): at the card's rates both take
// about the same time, so g has to be read once and the FMAs fed from
// registers.
//   * A block takes 8 rows x 32 columns x all 64 channels of the output (more
//     channels go in 64-wide chunks over the grid), so at C=64 each g float is
//     read from device memory once. Its 8 warps are its rows; a lane owns 8
//     neighbouring pixels x 8 channels (64 accumulators): 4 pixel groups x 8
//     channel groups, channels 4j..4j+3 and 32+4j..32+4j+3 of group j, so a
//     quarter warp reads 128 contiguous bytes of a feature column.
//   * The P displacement rows are the steps of the block. Step e needs
//     feature rows y + e*dil - r of its 8 output rows: the block streams
//     them through a ring in shared memory (th + 2*min(dil, th) rows of the
//     32 + (P-1)*dil halo columns, 118 KB at P=15), each step copying only the
//     rows it adds, two steps ahead, with one barrier a step. Halo columns
//     outside the image are zeroed once and never loaded; rows outside it are
//     not staged, and their warps skip the step (warp-uniform).
//   * Step e's cotangent, P floats of each pixel, is a run of 60 bytes every
//     900, not 16-byte aligned. Each warp copies its row's runs 16 bytes at a
//     time from their aligned start (4-5 chunks; 80-byte slots) and reads them
//     where they land: run j starts (q + j) mod 4 floats into its slot, q the
//     step's alignment, since P*P = 1 (mod 4). Copying them 4 bytes a float
//     instead was 0.05-0.4 ms slower at N=504 (PERF.md).
//   * df2 gathers: df2[y',x'] sums g*f1 over the source pixels (y'+e*dil-r,
//     x'+ex*dil-r) with g's displacement flipped, (P-1-e, P-1-ex). It stages
//     the runs of its source row (the halo columns in the image) and reads
//     run h = i + ex*dil backwards; df1 reads run i forwards. Otherwise the
//     two share the inner loop: the halo column h is the outer loop, so each
//     feature float read from shared memory feeds every pixel whose window
//     holds it; with P fixed (15, rntsm's) the loop unrolls and the cotangent
//     offsets fold to immediates. A runtime-P instance of the same kernel
//     takes the other patches and dilations. Each output element is summed
//     by one thread in a fixed order: no float atomics, the same bits on
//     every launch.
//   * What bounds it (scripts/torch_corr_probe.py, patched copies): the
//     16-byte copies and the compute's shared-memory reads share the SM's
//     load/store pipe, so staging (~0.26 ms at N=504 alone) and compute
//     (~0.3 ms alone) add up instead of overlapping; g's device-memory reads
//     themselves cost nothing measurable. 8 rows a block (one block of 8
//     warps an SM) beat 4 rows and two blocks an SM, two steps in flight beat
//     one, and half the warps issue their copies after they compute a step,
//     so the two warps of a scheduler take turns (~1%). Warps that only
//     issue copies, for 8 that compute, were slower: too few to issue them.
//     So was reading the cotangent as aligned float4s (one unrolled loop for
//     each alignment of a step's runs): 20% slower, at more registers.
//   * Left for later: a banded GEMM on tensor cores. The rntsm path is f32
//     with TF32 off (the JAX op is exact f32), so it would need 3xTF32 at
//     three times the MMAs, and the band (15 of 46 columns a row) wastes two
//     thirds of each tile; the f32 cores are not what bounds this kernel.
//   * All offsets are 64-bit: at batch 128, T=64 the volume has 1.86e9
//     elements.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;            // tile width: one lane per column
constexpr int TH_MAX = 8;         // tile height: one warp per row
constexpr int CC = 16;            // channels per shared-memory chunk
constexpr int CQ = CC / 4;        // float4s per chunk
constexpr int CS4 = CQ + 1;       // padded float4 stride of one pixel's chunk
constexpr int DYB = 5;            // forward: dy values per block
constexpr int DXB = 15;           // forward: dx values per block
constexpr int SMEM_LIMIT = 232448;  // 227 KB: the most a block can opt into

// Channels [c, c+4) of one pixel's feature vector `p` (C floats), zero past C.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int c, int C) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (c < C) v = *reinterpret_cast<const float4*>(p + c);
  } else {
    if (c + 0 < C) v.x = p[c + 0];
    if (c + 1 < C) v.y = p[c + 1];
    if (c + 2 < C) v.z = p[c + 2];
    if (c + 3 < C) v.w = p[c + 3];
  }
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, int c, int C, float4 v) {
  if (VEC) {
    if (c < C) *reinterpret_cast<float4*>(p + c) = v;
  } else {
    if (c + 0 < C) p[c + 0] = v.x;
    if (c + 1 < C) p[c + 1] = v.y;
    if (c + 2 < C) p[c + 2] = v.z;
    if (c + 3 < C) p[c + 3] = v.w;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  s = fmaf(a.w, b.w, s);
  return s;
}

// Channels [c0, c0+16) of the rows x cols window of `feat` (image n) whose
// top-left pixel is (oy, ox), into shared memory; zero outside the image.
template <bool VEC>
__device__ __forceinline__ void load_window(float4* __restrict__ dst,
                                            const float* __restrict__ feat,
                                            long long n, int H, int W, int C, int c0,
                                            int oy, int ox, int rows, int cols) {
  const int nvec = rows * cols * CQ;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int q = i % CQ;
    const int pos = i / CQ;
    const int gy = oy + pos / cols;
    const int gx = ox + pos % cols;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = load4<VEC>(feat + ((n * H + gy) * W + gx) * C, c0 + 4 * q, C);
    dst[pos * CS4 + q] = v;
  }
}

// Grid: one block per (image, row tile, column tile, dy group, dx group).
template <bool VEC>
__global__ void __launch_bounds__(TW * TH_MAX, 2)
corr_fwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                float* __restrict__ out, int H, int W, int C, int P, int dil,
                int tiles_y, int tiles_x, int groups_y, int groups_x) {
  extern __shared__ float4 smem4[];
  const int th = blockDim.x / TW;
  long long b = blockIdx.x;
  const int dx0 = (int)(b % groups_x) * DXB;  b /= groups_x;
  const int dy0 = (int)(b % groups_y) * DYB;  b /= groups_y;
  const int x0 = (int)(b % tiles_x) * TW;     b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * th;     b /= tiles_y;
  const long long n = b;
  const int ndy = min(DYB, P - dy0), ndx = min(DXB, P - dx0);
  const int r = (P - 1) / 2 * dil;
  const int rows = th + (ndy - 1) * dil, cols = TW + (ndx - 1) * dil;
  const int lane = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int y = y0 + ty, x = x0 + lane;
  const bool live = y < H && x < W;

  float acc[DYB][DXB];
#pragma unroll
  for (int dy = 0; dy < DYB; ++dy)
#pragma unroll
    for (int dx = 0; dx < DXB; ++dx) acc[dy][dx] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk has been read
    load_window<VEC>(smem4, f2, n, H, W, C, c0, y0 + dy0 * dil - r, x0 + dx0 * dil - r,
                     rows, cols);
    float4 a[CQ];
#pragma unroll
    for (int q = 0; q < CQ; ++q)
      a[q] = live ? load4<VEC>(f1 + ((n * H + y) * W + x) * C, c0 + 4 * q, C)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < DYB; ++dy) {
      if (dy < ndy) {
        const float4* row = smem4 + ((ty + dy * dil) * cols + lane) * CS4;
#pragma unroll
        for (int dx = 0; dx < DXB; ++dx) {
          if (dx < ndx) {
            const float4* p = row + dx * dil * CS4;
            float s = acc[dy][dx];
#pragma unroll
            for (int q = 0; q < CQ; ++q) s = dot4(a[q], p[q], s);
            acc[dy][dx] = s;
          }
        }
      }
    }
  }

  // Stage the tile's outputs, one odd-strided row per pixel, then write them
  // with consecutive threads on consecutive displacements.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem4);
  const int per = ndy * ndx;
  const int stride = per | 1;
#pragma unroll
  for (int dy = 0; dy < DYB; ++dy)
#pragma unroll
    for (int dx = 0; dx < DXB; ++dx)
      if (dy < ndy && dx < ndx) stage[threadIdx.x * stride + dy * ndx + dx] = acc[dy][dx];
  __syncthreads();
  const int total = th * TW * per;
  const long long PP = (long long)P * P;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int pix = i / per;
    const int rem = i - pix * per;
    const int dy = rem / ndx;
    const int dx = rem - dy * ndx;
    const int py = y0 + pix / TW, px = x0 + pix % TW;
    if (py < H && px < W)
      out[((n * H + py) * W + px) * PP + (long long)(dy0 + dy) * P + dx0 + dx] =
          stage[pix * stride + rem];
  }
}

// ---------------------------------------------------------------------------
// Backward: df1 and df2, one kernel (design in the header).

constexpr int BK = 8;                // pixels a thread owns: neighbours in one row
constexpr int BCG = 8;               // lanes a pixel group: 8 channels each
constexpr int BCH = 8 * BCG;         // channels a block takes (one chunk)
constexpr int BTW = BK * (32 / BCG);  // tile width: one warp a row
constexpr int BTH_MAX = 8;           // tile height: warps a block
constexpr int BSTAGES = 3;           // steps in flight: one computed, two loading
constexpr int BBLOCKS_PER_SM = 1;
constexpr int BP = 15;               // the patch compiled in (rntsm's), dilation 1
constexpr int GPAD = 4;              // floats after each pixel group's cotangents

__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a[0..3] += gv * fa, a[4..7] += gv * fb.
__device__ __forceinline__ void fma8(float (&a)[8], float gv, float4 fa, float4 fb) {
  a[0] = fmaf(gv, fa.x, a[0]);
  a[1] = fmaf(gv, fa.y, a[1]);
  a[2] = fmaf(gv, fa.z, a[2]);
  a[3] = fmaf(gv, fa.w, a[3]);
  a[4] = fmaf(gv, fb.x, a[4]);
  a[5] = fmaf(gv, fb.y, a[5]);
  a[6] = fmaf(gv, fb.z, a[6]);
  a[7] = fmaf(gv, fb.w, a[7]);
}

// Where run j of a staged cotangent row starts (floats): runs of SL floats,
// GPAD more after every BK of them, so that the four pixel groups' reads
// fall in different banks.
__device__ __forceinline__ int slot(int j, int SL) { return j * SL + j / BK * GPAD; }

// The inner loop of both kernels, for one step (one displacement row):
//   acc[i][j] += G(i, e) * f[i + e*dil][j]   over e < P,
// pixels i < BK of the thread's group, its 8 channels j. `f` is the staged
// feature row at the group's first halo column (BCH floats a column), `gs`
// the staged cotangent row at the group's first run. With VEC the runs were
// copied 16 bytes at a time from their aligned start, so run j's floats
// begin `q + j` (mod 4) into it; without, at its start. GATHER=false: run i
// is pixel i's, G(i, e) its float e. GATHER=true: run h is halo column h's,
// the source pixel of G(i, e) at h = i + e*dil, whose float P-1-e it is. The
// halo column h is the outer loop:
// each feature float read from shared memory feeds every pixel whose window
// holds it. With P and the dilation fixed, everything unrolls and the
// cotangent offsets fold to immediates.
template <bool GATHER, bool VEC, int P_T>
__device__ __forceinline__ void accumulate(float (&acc)[BK][8], const float* __restrict__ f,
                                           const float* __restrict__ gs, int q, int P,
                                           int dil, int SL, int cg) {
  int run[BK];  // df1: where pixel i's floats start
#pragma unroll
  for (int i = 0; i < BK; ++i) run[i] = slot(i, SL) + (VEC ? (q + i) & 3 : 0);
  const int span = BK + (P - 1) * dil;  // halo columns the group reads
#pragma unroll
  for (int h = 0; h < span; ++h) {
    const float4 fa = *reinterpret_cast<const float4*>(f + h * BCH + 4 * cg);
    const float4 fb = *reinterpret_cast<const float4*>(f + h * BCH + 4 * BCG + 4 * cg);
    // df2: the last float of halo column h's run
    const int col = slot(h, SL) + (VEC ? (q + h) & 3 : 0) + P - 1;
#pragma unroll
    for (int i = 0; i < BK; ++i) {
      const int d = h - i;
      if (d < 0 || d % dil != 0 || d / dil >= P) continue;
      const int e = d / dil;
      fma8(acc[i], GATHER ? gs[col - e] : gs[run[i] + e], fa, fb);
    }
  }
}

// out[n,y,x,c] = sum over (e, ex) of G * feat[n, y+e*dil-r, x+ex*dil-r, c],
// for channels [c0, c0+64) of a tile of th rows x 32 columns. GATHER=false
// (df1; feat is f2): G = g[n,y,x,e*P+ex]. GATHER=true (df2; feat is f1): G =
// g[n, y+e*dil-r, x+ex*dil-r, (P-1-e)*P + P-1-ex], the cotangent of the
// source pixel, zero outside the image. P_T > 0: patch P_T at dilation 1;
// P_T = 0: patch and dilation from the arguments. VEC: C % 4 == 0 and every
// pointer 16-byte aligned, so copies go 16 bytes at a time.
// Grid: one block per (image, row tile, column tile, channel chunk).
template <bool GATHER, bool VEC, int P_T>
__global__ void __launch_bounds__(32 * BTH_MAX, BBLOCKS_PER_SM)
corr_bwd_kernel(const float* __restrict__ g, const float* __restrict__ feat,
                float* __restrict__ out, int H, int W, int C, int p_arg, int dil_arg,
                int tiles_y, int tiles_x, int chunks) {
  extern __shared__ float4 smem4[];
  const int P = P_T > 0 ? P_T : p_arg;
  const int dil = P_T > 0 ? 1 : dil_arg;
  const int th = blockDim.x / 32;
  long long b = blockIdx.x;
  const int c0 = (int)(b % chunks) * BCH;  b /= chunks;
  const int x0 = (int)(b % tiles_x) * BTW; b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * th;  b /= tiles_y;
  const long long n = b;
  const long long total = (long long)gridDim.x / chunks / tiles_x / tiles_y * H * W * P * P;  // g's floats
  const int span = (P - 1) * dil;
  const int r = span / 2;
  const int hc = BTW + span;                     // halo columns of a feature row
  const int dm = min(dil, th);                   // ring rows a step adds
  const int ring = th + (BSTAGES - 1) * dm;      // feature rows staged
  const int SL = (P + 6) / 4 * 4;                // floats a run: P from any alignment
  const int runs = GATHER ? hc : BTW;            // runs a cotangent row
  const int grow = slot(runs, SL) + GPAD;        // floats a staged cotangent row
  const long long PP = (long long)P * P;
  float* fring = reinterpret_cast<float*>(smem4);
  float* gbuf = fring + (size_t)ring * hc * BCH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pg = lane / BCG, cg = lane % BCG;
  const int top = y0 - r;  // the feature row of tile row 0 at step 0
  const int y = y0 + warp;  // this warp's output row
  const int lo = max(0, r - x0), hi = min(hc, W - x0 + r);  // halo columns in the image
  // Where tile row t's run of step e starts in g, for its first pixel (df1)
  // or its source row's first halo column (df2); run j's starts j*P*P later.
  auto run_start = [&](int e, int t) {
    return GATHER ? ((n * H + top + e * dil + t) * W + x0 - r) * PP + (long long)(P - 1 - e) * P
                  : ((n * H + y0 + t) * W + x0) * PP + (long long)e * P;
  };

  // Halo columns outside the image stay zero: feature columns in every ring
  // slot, and df2's source runs in every buffer. (Column c of the `outside`
  // ones is halo column c below lo, hi + c - lo from there on.)
  const int outside = hc - (hi - lo);
  for (int i = tid; i < ring * outside * (BCH / 4); i += blockDim.x) {
    const int c = i / (BCH / 4) % outside, s = i / (BCH / 4) / outside;
    const int col = c < lo ? c : hi + c - lo;
    smem4[((size_t)s * hc + col) * (BCH / 4) + i % (BCH / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (GATHER)
    for (int i = tid; i < BSTAGES * th * outside * (SL / 4); i += blockDim.x) {
      const int c = i / (SL / 4) % outside, s = i / (SL / 4) / outside;
      const int col = c < lo ? c : hi + c - lo;
      *reinterpret_cast<float4*>(gbuf + (size_t)s * grow + slot(col, SL) + 4 * (i % (SL / 4))) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // The copies of step e: the feature rows top + e*dil + t (t < th) that
  // step e-1 did not have, into ring slot (e*dm + t) % ring, their columns
  // in the image; and each warp's cotangent row into buffer e % BSTAGES.
  // Rows outside the image are not staged: their warps skip the step.
  auto stage = [&](int e) {
    const int first = top + e * dil;
    const int t_lo = e == 0 ? 0 : max(0, th - dil);
    const int cols = hi - lo;
    if (VEC) {
      const int per_row = cols * (BCH / 4);
      for (int i = tid; i < (th - t_lo) * per_row; i += blockDim.x) {
        const int t = t_lo + i / per_row, col = lo + i % per_row / (BCH / 4);
        const int row = first + t, ch = c0 + 4 * (i % (BCH / 4));
        if (row < 0 || row >= H) continue;
        cp_async_16(fring + ((size_t)((e * dm + t) % ring) * hc + col) * BCH + ch - c0,
                    feat + ((n * H + row) * W + x0 - r + col) * C + ch, ch < C);
      }
    } else {
      const int per_row = cols * BCH;
      for (int i = tid; i < (th - t_lo) * per_row; i += blockDim.x) {
        const int t = t_lo + i / per_row, col = lo + i % per_row / BCH;
        const int row = first + t, ch = c0 + i % BCH;
        if (row < 0 || row >= H) continue;
        cp_async_4(fring + ((size_t)((e * dm + t) % ring) * hc + col) * BCH + ch - c0,
                   feat + ((n * H + row) * W + x0 - r + col) * C + ch, ch < C);
      }
    }
    // Each warp stages its own tile row's cotangent: for each pixel (df1) or
    // in-image halo column (df2), the run of P floats of this step's
    // displacement row, 16 bytes at a time from its aligned start (4 bytes
    // at a time, from its start, without VEC).
    const int row = first + warp;
    if (y >= H || row < 0 || row >= H) return;
    float* gd = gbuf + (size_t)(e % BSTAGES) * th * grow + warp * grow;
    const long long base = run_start(e, warp);
    const int first_run = GATHER ? lo : 0, last_run = GATHER ? hi : min(BTW, W - x0);
    if (VEC) {
      const int per_run = SL / 4;
      for (int i = lane + first_run * per_run; i < last_run * per_run; i += 32) {
        const int j = i / per_run, k = i % per_run;
        const long long start = base + j * PP;
        const int o = (int)(start & 3);
        if (4 * k >= o + P) continue;
        const long long at = start - o + 4 * k;
        float* dst = gd + slot(j, SL) + 4 * k;
        if (at + 4 <= total) {
          cp_async_16(dst, g + at, true);
        } else {  // the tensor's last run: no read past its end
          for (int m = 0; m < 4; ++m) cp_async_4(dst + m, g + at + m, at + m < total);
        }
      }
    } else {
      for (int i = lane + first_run * P; i < last_run * P; i += 32) {
        const int j = i / P, ex = i % P;
        cp_async_4(gd + slot(j, SL) + ex, g + base + j * PP + ex, true);
      }
    }
  };

  float acc[BK][8];
#pragma unroll
  for (int i = 0; i < BK; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int e = 0; e < BSTAGES - 1; ++e) {
    if (e < P) stage(e);
    cp_async_commit();
  }
  // Half the warps issue their copies before they compute a step, half
  // after: the warps a scheduler holds take turns issuing while the others
  // compute.
  const bool early = warp < (th + 1) / 2;
  for (int e = 0; e < P; ++e) {
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();  // step e has landed; step e-1's buffers are free
    if (early && e + BSTAGES - 1 < P) stage(e + BSTAGES - 1);
    const int row = top + e * dil + warp;  // its feature (df1) or source (df2) row
    if (y < H && row >= 0 && row < H) {
      accumulate<GATHER, VEC, P_T>(
          acc, fring + ((size_t)((e * dm + warp) % ring) * hc + pg * BK) * BCH,
          gbuf + (size_t)(e % BSTAGES) * th * grow + warp * grow + slot(pg * BK, SL),
          (int)(run_start(e, warp) & 3), P, dil, SL, cg);
    }
    if (!early && e + BSTAGES - 1 < P) stage(e + BSTAGES - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < BK; ++i) {
    const int x = x0 + pg * BK + i;
    if (x >= W) continue;
    float* dst = out + ((n * H + y) * W + x) * C;
    const int ca = c0 + 4 * cg, cb = c0 + 4 * BCG + 4 * cg;
    store4<VEC>(dst, ca, C, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    store4<VEC>(dst, cb, C, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

bool bad_args(long long n, long long h, long long w, long long c, long long patch,
              long long dil) {
  const long long big = 1LL << 30;
  return n <= 0 || h <= 0 || w <= 0 || c <= 0 || patch <= 0 || patch % 2 == 0 ||
         dil <= 0 || h > big || w > big || c > big || patch > 4096 || dil > big;
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b) |
           reinterpret_cast<size_t>(c)) & 15) == 0;
}

// The tallest tile (most, most/2, ..., 1 rows) whose shared memory fits; 0
// if none.
template <typename F>
int pick_rows(F smem_bytes, int most = TH_MAX) {
  for (int th = most; th >= 1; th /= 2)
    if (smem_bytes(th) <= (long long)SMEM_LIMIT) return th;
  return 0;
}

template <typename K, typename... Args>
int launch(K kernel, long long blocks, int threads, long long smem, cudaStream_t stream,
           Args... args) {
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool GATHER>
int launch_bwd(const void* g, const void* feat, void* out, long long n, long long h,
               long long w, long long c, long long patch, long long dil, void* stream) {
  if (bad_args(n, h, w, c, patch, dil)) return (int)cudaErrorInvalidValue;
  const long long hc = BTW + (patch - 1) * dil;
  if (hc * BCH * 4 > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  const long long sl = (patch + 6) / 4 * 4, runs = GATHER ? hc : BTW;
  const long long grow = runs * sl + (runs / BK + 1) * GPAD;
  auto smem_bytes = [&](int th) {
    return 4 * ((th + (BSTAGES - 1) * (dil < th ? dil : th)) * hc * BCH +
                BSTAGES * th * grow);
  };
  const int th = pick_rows(smem_bytes, BTH_MAX);
  if (th == 0) return (int)cudaErrorInvalidConfiguration;  // window too wide for a block
  const long long tiles_y = (h + th - 1) / th, tiles_x = (w + BTW - 1) / BTW;
  const long long chunks = (c + BCH - 1) / BCH;
  const long long blocks = n * tiles_y * tiles_x * chunks;
  const bool vec = c % 4 == 0 && aligned16(g, feat, out);
  auto kernel = !vec ? corr_bwd_kernel<GATHER, false, 0>
                : patch == BP && dil == 1 ? corr_bwd_kernel<GATHER, true, BP>
                                          : corr_bwd_kernel<GATHER, true, 0>;
  return launch(kernel, blocks, th * 32, smem_bytes(th), (cudaStream_t)stream,
                (const float*)g, (const float*)feat, (float*)out, (int)h, (int)w, (int)c,
                (int)patch, (int)dil, (int)tiles_y, (int)tiles_x, (int)chunks);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// f1, f2 [n,h,w,c] f32 -> out [n,h,w,patch*patch] f32.
int correlation_fwd(const void* f1, const void* f2, void* out, long long n, long long h,
                    long long w, long long c, long long patch, long long dil,
                    void* stream) {
  if (bad_args(n, h, w, c, patch, dil)) return (int)cudaErrorInvalidValue;
  const long long ndy = patch < DYB ? patch : DYB, ndx = patch < DXB ? patch : DXB;
  auto smem_bytes = [&](int th) {
    const long long window = (th + (ndy - 1) * dil) * (TW + (ndx - 1) * dil) * CS4 * 16;
    const long long stage = (long long)th * TW * ((ndy * ndx) | 1) * 4;
    return window > stage ? window : stage;
  };
  const int th = pick_rows(smem_bytes);
  if (th == 0) return (int)cudaErrorInvalidConfiguration;  // window too wide for a block
  const long long tiles_y = (h + th - 1) / th, tiles_x = (w + TW - 1) / TW;
  const long long groups_y = (patch + DYB - 1) / DYB, groups_x = (patch + DXB - 1) / DXB;
  const long long blocks = n * tiles_y * tiles_x * groups_y * groups_x;
  const bool vec = c % 4 == 0 && aligned16(f1, f2, out);
  auto kernel = vec ? corr_fwd_kernel<true> : corr_fwd_kernel<false>;
  return launch(kernel, blocks, th * TW, smem_bytes(th), (cudaStream_t)stream,
                (const float*)f1, (const float*)f2, (float*)out, (int)h, (int)w, (int)c,
                (int)patch, (int)dil, (int)tiles_y, (int)tiles_x, (int)groups_y,
                (int)groups_x);
}

// g [n,h,w,patch*patch], f2 [n,h,w,c] -> df1 [n,h,w,c], all f32.
int correlation_bwd_f1(const void* g, const void* f2, void* df1, long long n, long long h,
                       long long w, long long c, long long patch, long long dil,
                       void* stream) {
  return launch_bwd<false>(g, f2, df1, n, h, w, c, patch, dil, stream);
}

// g [n,h,w,patch*patch], f1 [n,h,w,c] -> df2 [n,h,w,c], all f32.
int correlation_bwd_f2(const void* g, const void* f1, void* df2, long long n, long long h,
                       long long w, long long c, long long patch, long long dil,
                       void* stream) {
  return launch_bwd<true>(g, f1, df2, n, h, w, c, patch, dil, stream);
}

}  // extern "C"
