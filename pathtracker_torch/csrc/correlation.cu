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
// Bound: neither bytes nor operations alone. Per 32x32x64 image with P=15
// each kernel does 29.5 MFLOP (23.0 inside the image) on 1.45 MB: at the f32
// FMA peak and at the memory rate both take about the same time. The volume
// (the forward's output, the backward's input g) is 64% of the bytes, 225
// floats (900 B) a pixel. So each input has to be read from device memory
// once, and the FMAs fed from registers, not one shared-memory float each.
//
// Forward design (corr_fwd_kernel). The Pallas kernel holds one whole image
// (f1 and the padded f2, 800 KB) in VMEM; a Hopper block has 227 KB, so the
// work is tiled as in the backward kernel below, whose tile, ring and lane
// layout it shares:
//   * A block takes 8 rows x 32 columns x all 64 channels of f1 (more
//     channels go in 64-wide chunks, one after the other in the block, each
//     adding to what the one before wrote), so f1 and f2 are read from
//     device memory once a tile. Its 8 warps are its rows; a lane owns 8
//     neighbouring pixels x 8 channels of f1 (4 pixel groups x 8 channel
//     groups, channels 4j..4j+3 and 32+4j..32+4j+3 of group j), which it
//     loads into registers once.
//   * The P displacement rows dy are the steps of the block. Step dy needs
//     f2 rows y + dy*dil - r of its 8 rows: they stream through a ring in
//     shared memory (th + 2*min(dil, th) rows of the 32 + (P-1)*dil halo
//     columns, 118 KB at P=15), each step copying only the rows it adds, two
//     steps ahead, with cp.async and one barrier a step (each warp issues its
//     share of the copies before it computes). Halo columns outside the
//     image are zeroed once and never loaded; rows outside it are not
//     staged, and their warps skip the step (warp-uniform).
//   * Register tile: a lane sums, over its 8 channels, its 8 pixels x the 15
//     displacements dx of the step (120 accumulators). The halo column h is
//     the outer loop: each f2 float read from shared memory feeds every pixel
//     whose window holds it (up to 8 FMAs; 960 FMAs for 44 16-byte reads a
//     step, 5.5 a float), each f1 register 15. With P fixed (15, rntsm's) the
//     loop unrolls; a runtime-P instance of the same kernel takes the other
//     patches and dilations, dx outer, in passes of 8 (so that it does not
//     spill).
//   * Then the 8 channel lanes of a pixel group reduce-scatter their partial
//     sums with shuffles in a fixed order (60 + 30 + 15 exchanges), so that
//     lane l ends with pixel l's 15 sums of the step: no float atomics, the
//     same bits on every launch. (Lanes that hold their pixels in reverse,
//     so that the first exchange needs no selects, gained nothing.)
//   * The volume: a step gives each pixel P floats (60 B) at a 900 B stride.
//     Each warp stages its row's sums of 5 steps in shared memory (a pixel's
//     run of 5*P floats at an odd stride, so the lanes' writes hit distinct
//     banks) and writes them as runs of 300 B a pixel, consecutive lanes on
//     consecutive floats. Storing from the accumulators (4 bytes every 900)
//     took 2.24 ms at N=504 against 0.66 for this scheme, staging 1 or 3
//     steps 0.71 and 0.68 (PERF.md, scripts/torch_corr_probe.py).
//   * The other lane layout measured: a lane sums all the channels of its 8
//     pixels x 15 dx, so nothing is reduced across lanes, with f1 read from
//     shared memory; a warp then covers the whole 8 x 32 tile, so the 8 warps
//     of a block take 8 displacement rows at once (15 f2 rows staged, 8
//     channels a stage, 3 stages, and the sums of 8 steps staged for the
//     writes: 216 KB). It took 0.97 ms at N=504 against 0.78 for this one
//     (PERF.md): its 60 16-byte reads for 960 FMAs (against 44 and 105
//     shuffles here) and 2.2x the staged bytes cost more than the shuffles.
//   * What bounds it (scripts/torch_corr_probe.py, patched copies, N=504):
//     as is 0.66 ms; without the products and shuffles 0.39, without the
//     stores 0.53, without the f2 copies 0.61; an eighth of the FMAs 0.57,
//     no shuffles 0.60. The inner loop (~0.28 ms), the writes of the volume
//     (~0.14) and the copies (~0.05) add up instead of overlapping: every
//     warp computes, then writes, at the same steps. Two steps in flight
//     instead of three were 2% faster, four 2% slower; 4 rows a block and
//     two blocks an SM the same.
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
//
// Both: all offsets are 64-bit (at batch 128, T=64 the volume has 1.86e9
// elements). Left for later: a banded GEMM on tensor cores. The JAX op is
// exact f32 and rntsm pins TF32 off, so it would need 3xTF32 at three times
// the MMAs, and the band (15 of 46 columns a row) wastes two thirds of each
// tile: worked out, about the f32 FMA peak, not above it.

#include <cuda_runtime.h>

namespace {

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

// ---------------------------------------------------------------------------
// Forward (design in the header): the backward's tile, ring and lane layout.

constexpr int FDX_RT = 8;  // runtime-P instance: displacements dx a pass
constexpr int FSS = 5;     // displacement rows staged before a warp writes them

// s += the 8-channel dot product of (a, b) and (fa, fb), in a fixed order.
__device__ __forceinline__ float dot8(float4 a, float4 b, float4 fa, float4 fb, float s) {
  s = fmaf(a.x, fa.x, s);
  s = fmaf(a.y, fa.y, s);
  s = fmaf(a.z, fa.z, s);
  s = fmaf(a.w, fa.w, s);
  s = fmaf(b.x, fb.x, s);
  s = fmaf(b.y, fb.y, s);
  s = fmaf(b.z, fb.z, s);
  s = fmaf(b.w, fb.w, s);
  return s;
}

// acc[i][k] += f1 . f2 over the thread's 8 channels, for pixel i of its
// group and displacement dx0 + k (< P) of one displacement row. `a`, `b`:
// the pixels' f1 channels; `f`: the staged f2 row at the group's first halo
// column (BCH floats a column). P_T > 0 (dilation 1): the halo column h is
// the outer loop and everything unrolls. P_T = 0: displacement outer,
// runtime P and dilation. Either way each accumulator takes its 8 FMAs in
// channel order.
template <int P_T, int NDX>
__device__ __forceinline__ void fwd_products(float (&acc)[BK][NDX], const float4 (&a)[BK],
                                             const float4 (&b)[BK],
                                             const float* __restrict__ f, int P, int dil,
                                             int dx0, int cg) {
  if constexpr (P_T > 0) {
    static_assert(P_T == NDX, "one pass of displacements");
#pragma unroll
    for (int h = 0; h < BK + P_T - 1; ++h) {
      const float4 fa = *reinterpret_cast<const float4*>(f + h * BCH + 4 * cg);
      const float4 fb = *reinterpret_cast<const float4*>(f + h * BCH + 4 * BCG + 4 * cg);
#pragma unroll
      for (int i = 0; i < BK; ++i) {
        const int k = h - i;
        if (k >= 0 && k < P_T) acc[i][k] = dot8(a[i], b[i], fa, fb, acc[i][k]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < NDX; ++k) {
      if (dx0 + k >= P) break;
#pragma unroll
      for (int i = 0; i < BK; ++i) {
        const float* p = f + (i + (dx0 + k) * dil) * BCH + 4 * cg;
        acc[i][k] = dot8(a[i], b[i], *reinterpret_cast<const float4*>(p),
                         *reinterpret_cast<const float4*>(p + 4 * BCG), acc[i][k]);
      }
    }
  }
}

// Sum acc over the 8 channel lanes of the pixel group (lane bits 0-2, `cg`)
// and scatter it: afterwards acc[0] of lane cg holds the whole sums of pixel
// cg. Each exchange hands the partner the half it keeps, in a fixed order
// (60 + 30 + 15 shuffles at NDX = 15).
template <int NDX>
__device__ __forceinline__ void reduce_channel_lanes(float (&acc)[BK][NDX], int cg) {
#pragma unroll
  for (int half = BK / 2; half >= 1; half /= 2) {
    const bool up = cg & half;
#pragma unroll
    for (int j = 0; j < half; ++j)
#pragma unroll
      for (int dx = 0; dx < NDX; ++dx) {
        const float send = up ? acc[j][dx] : acc[j + half][dx];
        const float keep = up ? acc[j + half][dx] : acc[j][dx];
        acc[j][dx] = keep + __shfl_xor_sync(0xffffffffu, send, half);
      }
  }
}

// dst[px*PP + j] = src[px*sst + j] (ADD: +=) for px < cols, j < len: runs
// of `len` floats at stride PP, consecutive lanes on consecutive floats.
template <bool ADD>
__device__ __forceinline__ void write_runs(float* __restrict__ dst,
                                           const float* __restrict__ src, long long PP,
                                           int sst, int len, int cols, int lane) {
#pragma unroll 4
  for (int i = lane; i < cols * len; i += 32) {
    const int px = i / len, j = i - px * len;
    if (ADD)
      dst[px * PP + j] += src[px * sst + j];
    else
      dst[px * PP + j] = src[px * sst + j];
  }
}

// corr[n,y,x,dy*P+dx] = sum_c f1[n,y,x,c] * f2[n, y+dy*dil-r, x+dx*dil-r, c]
// for a tile of th rows x 32 columns. P_T > 0: patch P_T at dilation 1;
// P_T = 0: patch and dilation from the arguments. VEC: C % 4 == 0 and every
// pointer 16-byte aligned, so copies go 16 bytes at a time.
// Grid: one block per (image, row tile, column tile).
template <bool VEC, int P_T>
__global__ void __launch_bounds__(32 * BTH_MAX, BBLOCKS_PER_SM)
corr_fwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                float* __restrict__ out, int H, int W, int C, int p_arg, int dil_arg,
                int tiles_y, int tiles_x) {
  extern __shared__ float4 smem4[];
  constexpr int NDX = P_T > 0 ? P_T : FDX_RT;  // displacements dx a pass
  const int P = P_T > 0 ? P_T : p_arg;
  const int dil = P_T > 0 ? 1 : dil_arg;
  const int th = P_T > 0 ? BTH_MAX : blockDim.x / 32;  // the fixed instance: 8 rows
  long long b = blockIdx.x;
  const int x0 = (int)(b % tiles_x) * BTW; b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * th;  b /= tiles_y;
  const long long n = b;
  const int span = (P - 1) * dil;
  const int r = span / 2;
  const int hc = BTW + span;                 // halo columns of an f2 row
  const int dm = min(dil, th);               // ring rows a step adds
  const int ring = th + (BSTAGES - 1) * dm;  // f2 rows staged
  const int sst = (FSS * P) | 1;             // staged floats a pixel: odd
  const long long PP = (long long)P * P;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pg = lane / BCG, cg = lane % BCG;
  float* fring = reinterpret_cast<float*>(smem4);
  float* ostage = fring + (size_t)ring * hc * BCH + (size_t)warp * BTW * sst;
  const int top = y0 - r;   // the f2 row of tile row 0 at step 0
  const int y = y0 + warp;  // this warp's row
  const int lo = max(0, r - x0), hi = min(hc, W - x0 + r);  // halo columns in the image
  const int cols = min(BTW, W - x0);                        // tile columns in the image

  // Halo columns outside the image stay zero in every ring slot. (Column c
  // of the `outside` ones is halo column c below lo, hi + c - lo from there on.)
  const int outside = hc - (hi - lo);
  for (int i = tid; i < ring * outside * (BCH / 4); i += blockDim.x) {
    const int c = i / (BCH / 4) % outside, s = i / (BCH / 4) / outside;
    const int col = c < lo ? c : hi + c - lo;
    smem4[((size_t)s * hc + col) * (BCH / 4) + i % (BCH / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // The copies of step e: the f2 rows top + e*dil + t (t < th) that step e-1
  // did not have, channels [c0, c0+64), into ring slot (e*dm + t) % ring,
  // their columns in the image. Rows outside the image are not staged.
  auto stage = [&](int e, int c0) {
    constexpr int per = VEC ? 4 : 1;  // floats a copy
#pragma unroll 1
    for (int t = e == 0 ? 0 : max(0, th - dil); t < th; ++t) {
      const int row = top + e * dil + t;
      if (row < 0 || row >= H) continue;
      float* dst = fring + ((size_t)((e * dm + t) % ring) * hc + lo) * BCH;
      const float* src = f2 + ((n * H + row) * W + x0 - r + lo) * C + c0;
      for (int i = tid; i < (hi - lo) * (BCH / per); i += blockDim.x) {
        const int col = i / (BCH / per), ch = per * (i % (BCH / per));
        if (VEC)
          cp_async_16(dst + col * BCH + ch, src + col * C + ch, c0 + ch < C);
        else
          cp_async_4(dst + col * BCH + ch, src + col * C + ch, c0 + ch < C);
      }
    }
  };

  for (int c0 = 0; c0 < C; c0 += BCH) {
#pragma unroll
    for (int e = 0; e < BSTAGES - 1; ++e) {
      if (e < P) stage(e, c0);
      cp_async_commit();
    }
    // The thread's f1: 8 pixels x 8 channels of this chunk, zero outside.
    float4 a[BK], bq[BK];
#pragma unroll
    for (int i = 0; i < BK; ++i) {
      const int x = x0 + pg * BK + i;
      a[i] = bq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y < H && x < W) {
        const float* p = f1 + ((n * H + y) * W + x) * C;
        a[i] = load4<VEC>(p, c0 + 4 * cg, C);
        bq[i] = load4<VEC>(p, c0 + 4 * BCG + 4 * cg, C);
      }
    }
    for (int e = 0; e < P; ++e) {
      cp_async_wait<BSTAGES - 2>();
      __syncthreads();  // step e has landed; step e-1's slot is free
      if (e + BSTAGES - 1 < P) stage(e + BSTAGES - 1, c0);
      const int row = top + e * dil + warp;  // its f2 row
      const bool in = y < H && row >= 0 && row < H;
      const float* f = fring + ((size_t)((e * dm + warp) % ring) * hc + pg * BK) * BCH;
      float* put = ostage + lane * sst + e % FSS * P;  // pixel `lane`'s sums of step e
      for (int dx0 = 0; dx0 < P; dx0 += NDX) {
        float acc[BK][NDX];
#pragma unroll
        for (int i = 0; i < BK; ++i)
#pragma unroll
          for (int k = 0; k < NDX; ++k) acc[i][k] = 0.f;
        if (in) {
          fwd_products<P_T, NDX>(acc, a, bq, f, P, dil, dx0, cg);
          reduce_channel_lanes<NDX>(acc, cg);
        }
#pragma unroll
        for (int k = 0; k < NDX; ++k)
          if (dx0 + k < P) put[dx0 + k] = acc[0][k];
      }
      cp_async_commit();
      if (e % FSS == FSS - 1 || e == P - 1) {
        // The row's staged steps e0..e, a run of `len` floats a pixel (a
        // constant where P_T is a multiple of FSS); later chunks add.
        __syncwarp();
        const int e0 = e - e % FSS;
        const int len = P_T > 0 && P_T % FSS == 0 ? FSS * P_T : (e - e0 + 1) * P;
        if (y < H) {
          float* dst = out + ((n * H + y) * W + x0) * PP + (long long)e0 * P;
          if (c0 == 0)
            write_runs<false>(dst, ostage, PP, sst, len, cols, lane);
          else
            write_runs<true>(dst, ostage, PP, sst, len, cols, lane);
        }
        __syncwarp();
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next chunk
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
int pick_rows(F smem_bytes, int most) {
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
  const long long hc = BTW + (patch - 1) * dil;
  if (hc * BCH * 4 > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  const long long sst = (FSS * patch) | 1;
  auto smem_bytes = [&](int th) {
    return 4 * ((th + (BSTAGES - 1) * (dil < th ? dil : th)) * hc * BCH + th * BTW * sst);
  };
  const int th = pick_rows(smem_bytes, BTH_MAX);
  if (th == 0) return (int)cudaErrorInvalidConfiguration;  // window too wide for a block
  const long long tiles_y = (h + th - 1) / th, tiles_x = (w + BTW - 1) / BTW;
  const long long blocks = n * tiles_y * tiles_x;
  const bool vec = c % 4 == 0 && aligned16(f1, f2, out);
  // The fixed instance (patch 15, dilation 1: 190 KB) always gets 8 rows.
  auto kernel = !vec ? corr_fwd_kernel<false, 0>
                : patch == BP && dil == 1 ? corr_fwd_kernel<true, BP>
                                          : corr_fwd_kernel<true, 0>;
  return launch(kernel, blocks, th * 32, smem_bytes(th), (cudaStream_t)stream,
                (const float*)f1, (const float*)f2, (float*)out, (int)h, (int)w, (int)c,
                (int)patch, (int)dil, (int)tiles_y, (int)tiles_x);
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
