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
// Design. The Pallas kernel holds one whole image (f1 and the padded f2, 800 KB)
// in VMEM; a Hopper block has 227 KB, so the work is tiled instead:
//   * A block takes a tile of `th` rows x 32 columns of pixels (th = 8 unless
//     the shared-memory tile would not fit), one thread per pixel, a lane per
//     column. Borders are predicated: no padded copy of f2 is made.
//   * Channels go through shared memory in chunks of 16, each pixel's chunk
//     padded to 20 floats, so that a warp's float4 reads of 32 neighbouring
//     pixels touch every bank once.
//   * Forward: the accumulators have to live across the channel chunks, so a
//     block takes only 5 dy x 15 dx displacements (75 registers) and the
//     displacement groups are spread over the grid. The thread keeps its own
//     f1 chunk in registers and reads the f2 window from shared memory: one
//     shared-memory float per FMA, which is what limits it. The block's
//     outputs are staged in shared memory and written as runs of 5*P
//     contiguous floats per pixel, lanes along the run, because a lane per
//     pixel would write 4 bytes every 900.
//   * Backward: a block takes one 16-channel chunk of the output for its
//     tile, so its accumulators are 16 registers and it walks all P*P
//     displacements over one shared-memory halo tile of the feature map
//     ((th+(P-1)*dil) x (32+(P-1)*dil) pixels x 16 channels, 81 KB at P=15).
//     The cotangent comes through shared memory one dy at a time, loaded as
//     runs of P contiguous floats. df2 is df1's loop with the displacements
//     flipped and the cotangent taken from the shifted source pixel.
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

// out[n,y,x,c] = sum_d g'[n,y,x,d] * feat[n, y+ey*dil-r, x+ex*dil-r, c] over one
// 16-channel chunk. GATHER=false (df1; feat is f2): (ey, ex) = (dy, dx) and
// g' = g[n,y,x,d]. GATHER=true (df2; feat is f1): (ey, ex) = (P-1-dy, P-1-dx)
// and g' = g[n, y-dy*dil+r, x-dx*dil+r, d], zero outside the image.
// Grid: one block per (image, row tile, column tile, channel chunk).
template <bool GATHER, bool VEC>
__global__ void __launch_bounds__(TW * TH_MAX, 2)
corr_bwd_kernel(const float* __restrict__ g, const float* __restrict__ feat,
                float* __restrict__ out, int H, int W, int C, int P, int dil,
                int tiles_y, int tiles_x, int chunks) {
  extern __shared__ float4 smem4[];
  const int th = blockDim.x / TW;
  long long b = blockIdx.x;
  const int c0 = (int)(b % chunks) * CC;   b /= chunks;
  const int x0 = (int)(b % tiles_x) * TW;  b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * th;  b /= tiles_y;
  const long long n = b;
  const int span = (P - 1) * dil;
  const int r = (P - 1) / 2 * dil;
  const int hrows = th + span, hcols = TW + span;
  const int gcols = GATHER ? hcols : TW;
  const int lane = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int y = y0 + ty, x = x0 + lane;
  const long long PP = (long long)P * P;
  float* gs = reinterpret_cast<float*>(smem4 + hrows * hcols * CS4);

  load_window<VEC>(smem4, feat, n, H, W, C, c0, y0 - r, x0 - r, hrows, hcols);

  float4 acc[CQ];
#pragma unroll
  for (int q = 0; q < CQ; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int dy = 0; dy < P; ++dy) {
    __syncthreads();  // the previous dy's cotangents have been read
    // This dy's cotangents as [th][gcols][P], runs of P contiguous floats.
    const int total = th * gcols * P;
    const int sy_off = GATHER ? r - dy * dil : 0;
    const int sx_off = GATHER ? -r : 0;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int dx = i % P;
      const int pos = i / P;
      const int sy = y0 + pos / gcols + sy_off;
      const int sx = x0 + pos % gcols + sx_off;
      float v = 0.f;
      if (sy >= 0 && sy < H && sx >= 0 && sx < W)
        v = g[((n * H + sy) * W + sx) * PP + (long long)dy * P + dx];
      gs[i] = v;
    }
    __syncthreads();  // also orders the halo load before its first read
    const int ey = GATHER ? P - 1 - dy : dy;
    const float4* hrow = smem4 + ((ty + ey * dil) * hcols + lane) * CS4;
    const float* grow = gs + (ty * gcols + lane) * P;
    for (int dx = 0; dx < P; ++dx) {
      const int shift = (GATHER ? P - 1 - dx : dx) * dil;
      const float gv = GATHER ? grow[shift * P + dx] : grow[dx];
      const float4* p = hrow + shift * CS4;
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const float4 v = p[q];
        acc[q].x = fmaf(gv, v.x, acc[q].x);
        acc[q].y = fmaf(gv, v.y, acc[q].y);
        acc[q].z = fmaf(gv, v.z, acc[q].z);
        acc[q].w = fmaf(gv, v.w, acc[q].w);
      }
    }
  }
  if (y < H && x < W) {
    float* dst = out + ((n * H + y) * W + x) * C;
#pragma unroll
    for (int q = 0; q < CQ; ++q) store4<VEC>(dst, c0 + 4 * q, C, acc[q]);
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

// The tallest tile (8, 4, 2 or 1 rows) whose shared memory fits; 0 if none.
template <typename F>
int pick_rows(F smem_bytes) {
  for (int th = TH_MAX; th >= 1; th /= 2)
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
  const long long span = (patch - 1) * dil;
  auto smem_bytes = [&](int th) {
    const long long gcols = GATHER ? TW + span : TW;
    return (th + span) * (TW + span) * CS4 * 16 + th * gcols * patch * 4;
  };
  const int th = pick_rows(smem_bytes);
  if (th == 0) return (int)cudaErrorInvalidConfiguration;  // window too wide for a block
  const long long tiles_y = (h + th - 1) / th, tiles_x = (w + TW - 1) / TW;
  const long long chunks = (c + CC - 1) / CC;
  const long long blocks = n * tiles_y * tiles_x * chunks;
  const bool vec = c % 4 == 0 && aligned16(g, feat, out);
  auto kernel = vec ? corr_bwd_kernel<GATHER, true> : corr_bwd_kernel<GATHER, false>;
  return launch(kernel, blocks, th * TW, smem_bytes(th), (cudaStream_t)stream,
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
