// Forward halves of the InT cell's three fused elementwise/gate phases,
// hand-written for Hopper (sm_90a).
//
// Replaces (Pallas kernels of pathtracker_tpu/ops/int_fused.py):
//   k1_attention_fwd   <- k1_attention,  pallas_call at :184 (_k1_fwd_kernel :152-157)
//   k2_inhibition_fwd  <- k2_inhibition, pallas_call at :305 (_k2_fwd_kernel :244-251,
//                                                             _k2_core :229-241)
//   k3_excitation_fwd  <- k3_excitation, pallas_call at :443 (_k3_fwd_kernel :376-385,
//                                                             _k3_core :363-373)
// The plain PyTorch versions are pathtracker_torch/ops/int_fused.py::*_plain.
//
// Layout: unpacked channels-last rows [R, 32] (R = B*H*W), [32, 32] bf16 gate
// matrices w[k][c] (k = input channel) and [32] f32 per-channel vectors. The
// TPU kernels' 128-lane packing and block-diagonal matrices are not ported.
//
// Bound: device-memory bytes. Each element is read and written once: K1 moves
// 12 B/element, K2 14 B, K3 20 B, against one or two 32-term products per
// element (64-128 FLOP per element, ~5-6 FLOP/B), far under the ~295 FLOP/B
// at which an H100's bf16 tensor cores, let alone its f32 CUDA cores
// (~20 FLOP/B), would be the limit.
//
// K1 and K3 (k1_kernel, k3_kernel), the first design, at 63% and 54% of the
// bound:
//   * A block of 8 warps takes tiles of 32 rows, 4 rows per warp; lane c owns
//     channel c. Every global load and store is one warp-wide contiguous
//     128 B (f32) or 64 B (bf16) row segment, and every byte is touched once.
//     Each thread issues all its tile loads before any math, so a warp keeps
//     ~4 rows x (2-5 inputs) requests in flight.
//   * The blocks loop over tiles (a grid of resident blocks), so each thread
//     reads its output column of each gate matrix into 32 registers once per
//     block, not once per tile; per-channel vectors sit in registers too.
//   * The products' row operands are rounded to bf16 (__float2bfloat16_rn),
//     as int_fused.py::_dot does, and staged in shared memory as f32; a warp
//     reads a row as eight broadcast float4 loads and accumulates in f32, k
//     ascending, on the CUDA cores.
//   * All elementwise math is f32 with IEEE expf/log1pf; outputs are written
//     in the JAX kernels' dtypes.
//
// K2 (k2_kernel) is a ring kernel (csrc/ring.cuh), as the backward kernels
// are: the first design spent more issue slots on its 32-FMA row products
// and their broadcast loads, and sat idle between a tile's loads and its
// math, than its 14 B an element cost.
//   * inh @ i_u on the tensor cores (mma.sync.m16n8k16): inh, read from its
//     staged rows in the accumulator layout and rounded to bf16, is the A
//     fragment; i_u's B fragments are laid out once per block.
//   * conv_i, inp, gi_x (bf16) and inh (f32), 5 KB a 16-row tile, come
//     through a cp.async ring of K2_STAGES stages a warp; new_inh is written
//     over the staged inh and copied out 16 bytes a lane.
//   * Transcendentals: 2 softplus (expf + log1pf each) and a sigmoid (expf
//     and a __fdividef quotient) an element. The three take different
//     arguments, so no exponential is shared as in the backward kernels;
//     expf and log1pf stay the accurate ones (the fast intrinsics triple the
//     backward's elements past the tight tolerance). The chain of ~5
//     dependent transcendentals an element is what more warps an SM hide:
//     the forward keeps no weight-gradient accumulators, so it is not held
//     to one block an SM.
//   * Shape: two blocks of 8 warps an SM, two stages a warp (see the
//     constants below for what was measured against it).
//   * What bounds it (scripts/torch_bwd_probe.py): without its
//     transcendentals it streams its 58.7 MB at ~2.65 TB/s, as the backward
//     ring kernels do; the chain of transcendentals adds ~8 us that 16 warps
//     an SM do not hide.

#include "ring.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 4;
constexpr int TILE = WARPS * ROWS_PER_WARP;  // rows per block iteration
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Column `lane` of a row-major [C, C] bf16 matrix.
__device__ __forceinline__ void load_column(const bf16* __restrict__ w, int lane,
                                            float (&col)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) col[k] = __bfloat162float(w[k * C + lane]);
}

// sum_k row[k] * col[k], f32, k ascending; `row` is a 16 B aligned smem row.
__device__ __forceinline__ float row_dot(const float* row, const float (&col)[C]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < C; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    acc = fmaf(v.x, col[k], acc);
    acc = fmaf(v.y, col[k + 1], acc);
    acc = fmaf(v.z, col[k + 2], acc);
    acc = fmaf(v.w, col[k + 3], acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
k1_kernel(const float* __restrict__ exc, const bf16* __restrict__ att_x,
          const bf16* __restrict__ a_u, const float* __restrict__ a_u_b,
          bf16* __restrict__ gated, float* __restrict__ att, long long rows) {
  __shared__ __align__(16) float s_exc[TILE][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float col[C];
  load_column(a_u, lane, col);
  const float b = a_u_b[lane];
  const long long tiles = (rows + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float x[ROWS_PER_WARP], ax[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const long long row = tile * TILE + r;
      const bool in = row < rows;
      x[i] = in ? exc[row * C + lane] : 0.0f;
      ax[i] = in ? __bfloat162float(att_x[row * C + lane]) : 0.0f;
      s_exc[r][lane] = bf16_round(x[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const long long row = tile * TILE + r;
      if (row < rows) {
        const float a = sigmoid(ax[i] + row_dot(s_exc[r], col) + b);
        att[row * C + lane] = a;
        gated[row * C + lane] = __float2bfloat16_rn(a * x[i]);
      }
    }
    __syncthreads();
  }
}

// K2's ring shape: 16 warps an SM, 2 stages each (164 KB). More warps hide
// more of the transcendental chain, more stages only more of the loads.
// Measured (scripts/torch_bwd_probe.py, 131,072 rows, NVIDIA H100 80GB HBM3
// at 700 W): this shape 30.3-30.8 us a call; 8 warps an SM of 3 stages
// 33.1-33.5 us; 12 (6 x 2 blocks) of 3 stages 33.1-33.7 us; 14 (7 x 2) of 3
// stages 36.7 us; 20 (4 x 5 blocks) of 2 stages 32.8-32.9 us.
constexpr int K2_WARPS = 8, K2_STAGES = 2, K2_BLOCKS_PER_SM = 2;
constexpr int K2_NVEC = 7;  // per-channel vectors kept in shared memory
constexpr int K2_STAGE_BYTES = (F32_SLOT + 3 * B16_SLOT) * 4;  // inh | conv inp gi_x
constexpr int K2_SMEM = FRAGS * 8 + K2_NVEC * C * 4 + K2_WARPS * K2_STAGES * K2_STAGE_BYTES;
static_assert(K2_BLOCKS_PER_SM * (K2_SMEM + 1024) <= 233472, "228 KB of shared memory an SM");

__global__ void __launch_bounds__(K2_WARPS * 32, K2_BLOCKS_PER_SM)
k2_kernel(const bf16* __restrict__ conv_i, const float* __restrict__ mean0,
          const float* __restrict__ rstd0, const float* __restrict__ scale0,
          const float* __restrict__ bias0, const bf16* __restrict__ inp,
          const bf16* __restrict__ gi_x, const float* __restrict__ inh,
          const bf16* __restrict__ i_u, const float* __restrict__ i_u_b,
          const float* __restrict__ alpha, const float* __restrict__ mu,
          float* __restrict__ new_inh, long long rows) {
  extern __shared__ uint4 dyn_smem[];
  uint2* frag = reinterpret_cast<uint2*>(dyn_smem);    // i_u
  float* vec = reinterpret_cast<float*>(frag + FRAGS);  // [K2_NVEC][C]
  char* ring = reinterpret_cast<char*>(vec + K2_NVEC * C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  load_b_fragments<false>(i_u, frag);
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
  char* my_ring = ring + warp * (K2_STAGES * K2_STAGE_BYTES);
  auto load = [&](int stage, long long item) {
    float* f = reinterpret_cast<float*>(my_ring + stage * K2_STAGE_BYTES);
    unsigned* h = reinterpret_cast<unsigned*>(f + F32_SLOT);
    const long long row0 = item * MROWS;
    stage_in<8>(f, inh, row0, rows, lane);
    stage_in<4>(h, conv_i, row0, rows, lane);
    stage_in<4>(h + B16_SLOT, inp, row0, rows, lane);
    stage_in<4>(h + 2 * B16_SLOT, gi_x, row0, rows, lane);
  };
  ring_loop<K2_WARPS, K2_STAGES>(rows, warp, load, [&](int stage, long long item) {
    float* s_h = reinterpret_cast<float*>(my_ring + stage * K2_STAGE_BYTES);
    const unsigned* s_cv = reinterpret_cast<const unsigned*>(s_h + F32_SLOT);
    const unsigned* s_in = s_cv + B16_SLOT;
    const unsigned* s_gx = s_in + B16_SLOT;

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

    // Elementwise, in the accumulator layout; new_inh over the staged inh.
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
        const float2 cv2 = unpack_bf16(s_cv[bo]);
        const float2 in2 = unpack_bf16(s_in[bo]);
        const float2 gx2 = unpack_bf16(s_gx[bo]);
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float h = e ? h2.y : h2.x, cv = e ? cv2.y : cv2.x, in_ = e ? in2.y : in2.x,
                      gx = e ? gx2.y : gx2.x;
          const float xn = (cv - (e ? mean.y : mean.x)) * (e ? rstd.y : rstd.x);
          const float bn0 = xn * (e ? scale.y : scale.x) + (e ? bias.y : bias.x);
          const float t1 = bn0 * ((e ? al.y : al.x) * h + (e ? m.y : m.x));
          const float inh_hat = softplus(in_ - softplus(t1));
          const float gate = gate_sigmoid(gx + gpre[nt][2 * half + e] + (e ? b.y : b.x));
          out[e] = (1.0f - gate) * h + gate * inh_hat;
        }
        *reinterpret_cast<float2*>(&s_h[fo]) = make_float2(out[0], out[1]);
      }
    }

    __syncwarp();  // every lane's outputs are staged
    stage_out<8>(new_inh, s_h, item * MROWS, rows, lane);
  });
}

__global__ void __launch_bounds__(THREADS)
k3_kernel(const bf16* __restrict__ conv_e, const float* __restrict__ mean1,
          const float* __restrict__ rstd1, const float* __restrict__ scale1,
          const float* __restrict__ bias1, const float* __restrict__ new_inh,
          const float* __restrict__ inh, const bf16* __restrict__ gated,
          const float* __restrict__ exc, const bf16* __restrict__ e_w,
          const float* __restrict__ e_w_b, const bf16* __restrict__ e_u,
          const float* __restrict__ e_u_b, const float* __restrict__ kappa,
          const float* __restrict__ gamma, float* __restrict__ new_exc,
          long long rows) {
  __shared__ __align__(16) float s_inh[TILE][C];
  __shared__ __align__(16) float s_gated[TILE][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float col_w[C], col_u[C];
  load_column(e_w, lane, col_w);
  load_column(e_u, lane, col_u);
  const float mean = mean1[lane], rstd = rstd1[lane], scale = scale1[lane],
              bias = bias1[lane], bw = e_w_b[lane], bu = e_u_b[lane],
              ka = kappa[lane], ga = gamma[lane];
  const long long tiles = (rows + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float cv[ROWS_PER_WARP], ni[ROWS_PER_WARP], e[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const long long row = tile * TILE + r;
      const bool in = row < rows;
      const long long idx = row * C + lane;
      cv[i] = in ? __bfloat162float(conv_e[idx]) : 0.0f;
      ni[i] = in ? new_inh[idx] : 0.0f;
      e[i] = in ? exc[idx] : 0.0f;
      s_inh[r][lane] = in ? bf16_round(inh[idx]) : 0.0f;
      s_gated[r][lane] = in ? __bfloat162float(gated[idx]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const long long row = tile * TILE + r;
      if (row < rows) {
        const float xn = (cv[i] - mean) * rstd;
        const float bn1 = xn * scale + bias;
        const float exc_hat = softplus(bn1 * (ka * ni[i] + ga));
        const float g = sigmoid(row_dot(s_inh[r], col_w) + bw + row_dot(s_gated[r], col_u) + bu);
        new_exc[row * C + lane] = (1.0f - g) * e[i] + g * exc_hat;
      }
    }
    __syncthreads();
  }
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

int k1_attention_fwd(const void* exc, const void* att_x, const void* a_u,
                     const void* a_u_b, void* gated, void* att, long long rows,
                     void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  k1_kernel<<<grid_for(k1_kernel, rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)exc, (const bf16*)att_x, (const bf16*)a_u, (const float*)a_u_b,
      (bf16*)gated, (float*)att, rows);
  return (int)cudaGetLastError();
}

// Row arrays must be 16-byte aligned (cp.async).
int k2_inhibition_fwd(const void* conv_i, const void* mean0, const void* rstd0,
                      const void* scale0, const void* bias0, const void* inp,
                      const void* gi_x, const void* inh, const void* i_u,
                      const void* i_u_b, const void* alpha, const void* mu,
                      void* new_inh, long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned_16({conv_i, inp, gi_x, inh, new_inh})) return (int)cudaErrorMisalignedAddress;
  const int blocks = ring_grid_for(k2_kernel, K2_WARPS, K2_SMEM, rows);
  if (blocks <= 0) return blocks < 0 ? -blocks : (int)cudaErrorInvalidValue;
  k2_kernel<<<blocks, K2_WARPS * 32, K2_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)conv_i, (const float*)mean0, (const float*)rstd0,
      (const float*)scale0, (const float*)bias0, (const bf16*)inp,
      (const bf16*)gi_x, (const float*)inh, (const bf16*)i_u, (const float*)i_u_b,
      (const float*)alpha, (const float*)mu, (float*)new_inh, rows);
  return (int)cudaGetLastError();
}

int k3_excitation_fwd(const void* conv_e, const void* mean1, const void* rstd1,
                      const void* scale1, const void* bias1, const void* new_inh,
                      const void* inh, const void* gated, const void* exc,
                      const void* e_w, const void* e_w_b, const void* e_u,
                      const void* e_u_b, const void* kappa, const void* gamma,
                      void* new_exc, long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  k3_kernel<<<grid_for(k3_kernel, rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)conv_e, (const float*)mean1, (const float*)rstd1,
      (const float*)scale1, (const float*)bias1, (const float*)new_inh,
      (const float*)inh, (const bf16*)gated, (const float*)exc, (const bf16*)e_w,
      (const float*)e_w_b, (const bf16*)e_u, (const float*)e_u_b,
      (const float*)kappa, (const float*)gamma, (float*)new_exc, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
