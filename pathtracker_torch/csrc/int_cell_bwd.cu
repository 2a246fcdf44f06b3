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
// writes the row cotangents and one partial per block of every cross-row
// reduction: the [32, 32] weight gradients (x^T @ dpre) and the per-channel
// column sums. The partials go to [blocks, ...] f32 workspaces that the
// wrapper sums over the block axis, as the JAX glue sums its per-block
// partials outside the kernel. No float atomics anywhere: a block's rows,
// the order of its warps' tree and the order of the final sum are all fixed,
// so two launches on the same inputs give the same bits.
//
// Layout: as csrc/int_cell.cu — channels-last rows [R, 32], [32, 32] bf16
// gate matrices w[k][c] (k = input channel), [32] f32 vectors.
//
// Bound: device-memory bytes. K1 moves 14 B per row element (18 B with a
// cotangent for the attention map), K2 24 B, K3 36 B, against 3, 3 and 6
// 32-term products per element (192-384 FLOP, 8-14 FLOP/B): under the
// ~20 FLOP/B at which an H100's f32 CUDA cores (67 TFLOP/s over 3.35 TB/s)
// would be the limit, but close enough that the products must not stall on
// shared memory.
//
// Design, for the bound:
//   * A block of 8 warps takes tiles of 32 rows, 4 rows per warp; lane c owns
//     channel c; every global access is a warp-wide contiguous row segment
//     and every byte is touched once. A warp's rows are its own, so staging
//     a row in shared memory needs __syncwarp only: no block barrier in the
//     tile loop.
//   * Registers hold the accumulators, not the matrices: forward recompute,
//     transposed product and weight gradient together would want a column, a
//     row and an accumulator per matrix (96 registers for K1, 192 for K3).
//     The gate matrices sit in shared memory as f32, padded to 33 floats a
//     row so that both the column read w[k][lane] and the row read
//     w[lane][j] are conflict-free.
//   * Every product runs k-outer over the warp's 4 rows, so one matrix
//     element read from shared memory feeds 4 FMAs and one broadcast float4
//     of a staged row feeds 4 more: ~16 shared-memory wavefronts per row per
//     product instead of 40.
//   * Weight gradients: lane c keeps acc[k] = sum_rows x[row][k] * d[row][c]
//     in 32 registers across all of the block's tiles (operands rounded to
//     bf16, f32 accumulation); column sums likewise, unrounded. After the
//     tile loop the 8 warps are reduced 8 -> 4 -> 2 -> 1 through shared memory
//     and warp 0 writes the block's partial.
//   * Rows past the end are loaded as zeros with a zero cotangent, which
//     makes every one of their cotangents and reduction terms exactly zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 32;
constexpr int LD = C + 1;  // padded leading dimension of a matrix in smem
constexpr int WARPS = 8;
constexpr int RPW = 4;  // rows per warp
constexpr int TILE = WARPS * RPW;
constexpr int THREADS = WARPS * 32;
constexpr int NRED = 7;  // per-channel column sums of K2 and K3

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

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

__global__ void __launch_bounds__(THREADS, 2)
k2_bwd_kernel(const bf16* __restrict__ conv_i, const float* __restrict__ mean0,
              const float* __restrict__ rstd0, const float* __restrict__ scale0,
              const float* __restrict__ bias0, const bf16* __restrict__ inp,
              const bf16* __restrict__ gi_x, const float* __restrict__ inh,
              const bf16* __restrict__ i_u, const float* __restrict__ i_u_b,
              const float* __restrict__ alpha, const float* __restrict__ mu,
              const float* __restrict__ dnew, bf16* __restrict__ dconv,
              bf16* __restrict__ dinp, bf16* __restrict__ dgix, float* __restrict__ dinh,
              float* __restrict__ ws_diu, float* __restrict__ ws_red, long long rows) {
  __shared__ float s_w[C * LD];
  __shared__ __align__(16) float s_x[TILE][C];  // bf16-rounded inh rows
  __shared__ __align__(16) float s_d[TILE][C];  // bf16-rounded dgpre rows
  __shared__ float s_part[(WARPS / 2) * C * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_matrix(i_u, s_w);
  const float mean = mean0[lane], rstd = rstd0[lane], scale = scale0[lane],
              bias = bias0[lane], b = i_u_b[lane], al = alpha[lane], m = mu[lane];
  float acc_w[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc_w[k] = 0.0f;
  // [dgpre, dlin*inh, dlin, -dxn, dxn*(conv-mean), dbn0*xn, dbn0]
  float red[NRED];
#pragma unroll
  for (int k = 0; k < NRED; ++k) red[k] = 0.0f;
  __syncthreads();
  const float(*my_x)[C] = &s_x[warp * RPW];
  const float(*my_d)[C] = &s_d[warp * RPW];
  const long long tiles = (rows + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float h[RPW], cv[RPW], in_[RPW], gx[RPW], dn[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      const bool in = row < rows;
      const long long idx = row * C + lane;
      h[i] = in ? inh[idx] : 0.0f;
      cv[i] = in ? __bfloat162float(conv_i[idx]) : 0.0f;
      in_[i] = in ? __bfloat162float(inp[idx]) : 0.0f;
      gx[i] = in ? __bfloat162float(gi_x[idx]) : 0.0f;
      dn[i] = in ? dnew[idx] : 0.0f;
      s_x[warp * RPW + i][lane] = bf16_round(h[i]);
    }
    __syncwarp();
    float gpre[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) gpre[i] = 0.0f;
    dot_cols(my_x, s_w, lane, gpre);
    float dinh_direct[RPW], dgpre_bf[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      const float cm = cv[i] - mean;
      const float xn = cm * rstd;
      const float bn0 = xn * scale + bias;
      const float lin = al * h[i] + m;
      const float t1 = bn0 * lin;
      const float pre2 = in_[i] - softplus(t1);
      const float inh_hat = softplus(pre2);
      const float g = sigmoid(gx[i] + gpre[i] + b);
      const float dg = dn[i] * (inh_hat - h[i]);
      const float dgpre = dg * g * (1.0f - g);
      const float dpre2 = (dn[i] * g) * sigmoid(pre2);
      const float dt1 = -dpre2 * sigmoid(t1);
      const float dbn0 = dt1 * lin;
      const float dlin = dt1 * bn0;
      const float dxn = dbn0 * scale;
      red[0] += dgpre;
      red[1] += dlin * h[i];
      red[2] += dlin;
      red[3] -= dxn;
      red[4] += dxn * cm;
      red[5] += dbn0 * xn;
      red[6] += dbn0;
      dinh_direct[i] = dn[i] * (1.0f - g) + dlin * al;
      dgpre_bf[i] = bf16_round(dgpre);
      s_d[warp * RPW + i][lane] = dgpre_bf[i];
      if (row < rows) {
        dconv[row * C + lane] = __float2bfloat16_rn(dxn * rstd);
        dinp[row * C + lane] = __float2bfloat16_rn(dpre2);
        dgix[row * C + lane] = __float2bfloat16_rn(dgpre_bf[i]);
      }
    }
    __syncwarp();
    float back[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) back[i] = 0.0f;
    dot_rows(my_d, s_w, lane, back);
    outer_acc(my_x, dgpre_bf, acc_w);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      if (row < rows) dinh[row * C + lane] = dinh_direct[i] + back[i];
    }
    __syncwarp();
  }
  red[3] *= rstd;  // dmean = sum(-dxn) * rstd
  block_reduce_store<C>(acc_w, s_part, ws_diu + (long long)blockIdx.x * C * C, lane, warp);
  block_reduce_store<NRED>(red, s_part, ws_red + (long long)blockIdx.x * NRED * C, lane, warp);
}

__global__ void __launch_bounds__(THREADS, 2)
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
              float* __restrict__ dexc, float* __restrict__ ws_dew,
              float* __restrict__ ws_deu, float* __restrict__ ws_red, long long rows) {
  __shared__ float s_ew[C * LD];
  __shared__ float s_eu[C * LD];
  __shared__ __align__(16) float s_h[TILE][C];   // bf16-rounded inh rows
  __shared__ __align__(16) float s_ge[TILE][C];  // gated rows (bf16 values)
  __shared__ __align__(16) float s_d[TILE][C];   // bf16-rounded dgpre rows
  __shared__ float s_part[(WARPS / 2) * C * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_matrix(e_w, s_ew);
  load_matrix(e_u, s_eu);
  const float mean = mean1[lane], rstd = rstd1[lane], scale = scale1[lane],
              bias = bias1[lane], bw = e_w_b[lane], bu = e_u_b[lane],
              ka = kappa[lane], ga = gamma[lane];
  float acc_w[C], acc_u[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc_w[k] = acc_u[k] = 0.0f;
  // [dgpre, dlin*new_inh, dlin, -dxn, dxn*(conv-mean), dbn1*xn, dbn1]
  float red[NRED];
#pragma unroll
  for (int k = 0; k < NRED; ++k) red[k] = 0.0f;
  __syncthreads();
  const float(*my_h)[C] = &s_h[warp * RPW];
  const float(*my_ge)[C] = &s_ge[warp * RPW];
  const float(*my_d)[C] = &s_d[warp * RPW];
  const long long tiles = (rows + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float cv[RPW], ni[RPW], e[RPW], dn[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      const bool in = row < rows;
      const long long idx = row * C + lane;
      cv[i] = in ? __bfloat162float(conv_e[idx]) : 0.0f;
      ni[i] = in ? new_inh[idx] : 0.0f;
      e[i] = in ? exc[idx] : 0.0f;
      dn[i] = in ? dnew[idx] : 0.0f;
      s_h[warp * RPW + i][lane] = in ? bf16_round(inh[idx]) : 0.0f;
      s_ge[warp * RPW + i][lane] = in ? __bfloat162float(gated[idx]) : 0.0f;
    }
    __syncwarp();
    float pw[RPW], pu[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) pw[i] = pu[i] = 0.0f;
    dot_cols(my_h, s_ew, lane, pw);
    dot_cols(my_ge, s_eu, lane, pu);
    float dgpre_bf[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      const float cm = cv[i] - mean;
      const float xn = cm * rstd;
      const float bn1 = xn * scale + bias;
      const float lin = ka * ni[i] + ga;
      const float t1 = bn1 * lin;
      const float exc_hat = softplus(t1);
      const float g = sigmoid(pw[i] + bw + pu[i] + bu);
      const float dg = dn[i] * (exc_hat - e[i]);
      const float dgpre = dg * g * (1.0f - g);
      const float dt1 = (dn[i] * g) * sigmoid(t1);
      const float dbn1 = dt1 * lin;
      const float dlin = dt1 * bn1;
      const float dxn = dbn1 * scale;
      red[0] += dgpre;
      red[1] += dlin * ni[i];
      red[2] += dlin;
      red[3] -= dxn;
      red[4] += dxn * cm;
      red[5] += dbn1 * xn;
      red[6] += dbn1;
      dgpre_bf[i] = bf16_round(dgpre);
      s_d[warp * RPW + i][lane] = dgpre_bf[i];
      if (row < rows) {
        dconv[row * C + lane] = __float2bfloat16_rn(dxn * rstd);
        dninh[row * C + lane] = dlin * ka;
        dexc[row * C + lane] = dn[i] * (1.0f - g);
      }
    }
    __syncwarp();
    float back_w[RPW], back_u[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) back_w[i] = back_u[i] = 0.0f;
    dot_rows(my_d, s_ew, lane, back_w);
    dot_rows(my_d, s_eu, lane, back_u);
    outer_acc(my_h, dgpre_bf, acc_w);
    outer_acc(my_ge, dgpre_bf, acc_u);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long row = tile * TILE + warp * RPW + i;
      if (row < rows) {
        dinh[row * C + lane] = back_w[i];
        dgated[row * C + lane] = __float2bfloat16_rn(back_u[i]);
      }
    }
    __syncwarp();
  }
  red[3] *= rstd;  // dmean = sum(-dxn) * rstd
  block_reduce_store<C>(acc_w, s_part, ws_dew + (long long)blockIdx.x * C * C, lane, warp);
  block_reduce_store<C>(acc_u, s_part, ws_deu + (long long)blockIdx.x * C * C, lane, warp);
  block_reduce_store<NRED>(red, s_part, ws_red + (long long)blockIdx.x * NRED * C, lane, warp);
}

// Resident blocks for `kernel` on the current device, capped at the tile
// count. Queried once per kernel: the port drives one card per process.
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

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// <kernel>_blocks(rows): the grid the launch below uses, which is the leading
// size of its partial workspaces ([blocks, 32, 32] and [blocks, n, 32] f32).
int k1_attention_bwd_blocks(long long rows) { return rows > 0 ? grid_for(k1_bwd_kernel, rows) : 0; }
int k2_inhibition_bwd_blocks(long long rows) { return rows > 0 ? grid_for(k2_bwd_kernel, rows) : 0; }
int k3_excitation_bwd_blocks(long long rows) { return rows > 0 ? grid_for(k3_bwd_kernel, rows) : 0; }

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

int k2_inhibition_bwd(const void* conv_i, const void* mean0, const void* rstd0,
                      const void* scale0, const void* bias0, const void* inp,
                      const void* gi_x, const void* inh, const void* i_u,
                      const void* i_u_b, const void* alpha, const void* mu,
                      const void* dnew, void* dconv, void* dinp, void* dgix,
                      void* dinh, void* ws_diu, void* ws_red, long long rows,
                      void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  k2_bwd_kernel<<<grid_for(k2_bwd_kernel, rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)conv_i, (const float*)mean0, (const float*)rstd0,
      (const float*)scale0, (const float*)bias0, (const bf16*)inp,
      (const bf16*)gi_x, (const float*)inh, (const bf16*)i_u, (const float*)i_u_b,
      (const float*)alpha, (const float*)mu, (const float*)dnew, (bf16*)dconv,
      (bf16*)dinp, (bf16*)dgix, (float*)dinh, (float*)ws_diu, (float*)ws_red, rows);
  return (int)cudaGetLastError();
}

int k3_excitation_bwd(const void* conv_e, const void* mean1, const void* rstd1,
                      const void* scale1, const void* bias1, const void* new_inh,
                      const void* inh, const void* gated, const void* exc,
                      const void* e_w, const void* e_w_b, const void* e_u,
                      const void* e_u_b, const void* kappa, const void* gamma,
                      const void* dnew, void* dconv, void* dninh, void* dinh,
                      void* dgated, void* dexc, void* ws_dew, void* ws_deu,
                      void* ws_red, long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  k3_bwd_kernel<<<grid_for(k3_bwd_kernel, rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)conv_e, (const float*)mean1, (const float*)rstd1,
      (const float*)scale1, (const float*)bias1, (const float*)new_inh,
      (const float*)inh, (const bf16*)gated, (const float*)exc, (const bf16*)e_w,
      (const float*)e_w_b, (const bf16*)e_u, (const float*)e_u_b,
      (const float*)kappa, (const float*)gamma, (const float*)dnew, (bf16*)dconv,
      (float*)dninh, (float*)dinh, (bf16*)dgated, (float*)dexc, (float*)ws_dew,
      (float*)ws_deu, (float*)ws_red, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
