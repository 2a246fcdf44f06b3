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
// cotangent for the attention map), K2 26 B, K3 38 B, against 3, 3 and 6
// 32-term products per element. On the f32 CUDA cores those products alone
// (192-384 FLOP and 8-14 FLOP/B) cost more instruction slots and shared-memory
// wavefronts than the bytes cost time, so all three run them on the tensor
// cores, where they are ~3 instructions a row. What is left
// (scripts/torch_bwd_probe.py, NVIDIA H100 80GB HBM3, 700 W): K3 is bound by
// moving its bytes, reads and writes together at ~2.65 TB/s; K2 by its
// transcendentals (3 expf, 2 log1pf, 3 quotients an element), which 8 warps
// an SM do not hide.
//
// All three kernels are ring kernels (csrc/ring.cuh):
//   * Products: mma.sync.m16n8k16, bf16 operands, f32 accumulation. A warp
//     owns 16 rows, and everything elementwise works in the accumulator
//     fragment's layout. The phase's input (exc, inh) rounds into the A
//     fragment of the recomputed gate product; the gate's cotangent (dpre,
//     dgpre), rounded to bf16 once, is the A fragment of dpre @ W^T in the
//     same way. The weight gradient x^T @ dpre has the rows as its K
//     dimension: both operands are the same registers transposed 8x8 block
//     by block with movmatrix, and the [32, 32] f32 sum stays in 32
//     accumulator registers a matrix across all of a warp's tiles. The gate
//     matrices are turned into B fragments for W and for W^T once per block
//     and read back from shared memory, one conflict-free 8-byte load a
//     fragment. wgmma is not used: all products together are ~1.6 GFLOP,
//     microseconds at a fraction of the tensor cores' rate.
//   * Loads in flight while a tile is computed: every warp fills its own
//     ring with cp.async, two stages (K2, K3) or three (K1), one or two
//     tiles ahead of the one it works on (80 KB in flight an SM for K3);
//     cp.async.wait_group and __syncwarp are the only synchronisation in the
//     loop, no block barrier. K1 stages its attention-map cotangent only
//     when it is given (a null pointer reads as zeros).
//   * Stores: each lane writes its outputs over the staged input of the same
//     type and position (dexc over exc, dattx over att_x, dinh over inh,
//     ...; K2's and K3's f32 dconv over dnew), and the warp then copies the
//     finished rows out 16 bytes a lane, fully coalesced. dconv, the batch
//     norm's direct input cotangent dxn * rstd, is written unrounded: the
//     caller adds the statistics' part to it in f32 and rounds the sum to
//     the conv output's bf16 once, as an f32 batch norm's backward does.
//   * Rows past the end are zero-filled by cp.async (source size 0) with a
//     zero cotangent, which makes every one of their cotangents and
//     reduction terms exactly zero; they are not copied out.
//   * Reductions finished inside the launch: a block sums its warps' weight
//     gradients and column sums through the idle ring in warp order and
//     writes one f32 partial to the wrapper's [blocks, ...] workspace; the C
//     function then launches finish_kernel on the same stream, which sums
//     the partials in a fixed order, rounds the weight gradients to bf16
//     once and writes the final [32, 32] and [n, 32] results.
//   * Transcendentals: softplus and sigmoid of one argument share one
//     exponential, and the sigmoids divide with __fdividef; computed apiece
//     with IEEE quotients they, not the bytes, bounded K2.
//   * One block of 8 warps an SM, so that a thread may take 255 registers:
//     32 (K1, K2) or 64 (K3) of weight gradient and 8 (K1) or 40 of column
//     sums live across the tile loop. More warps an SM spill (K2, K3) or
//     gain nothing (K1). K1 is bound by moving its bytes, as K3 is, and
//     keeps three stages a warp in flight.

#include "ring.cuh"

namespace {

constexpr int NRED = 7;  // per-channel column sums of K2 and K3

// Warps a block, stages a warp and blocks an SM. Measured alternatives
// (scripts/torch_bwd_probe.py, 131,072 rows, NVIDIA H100 80GB HBM3 at 700
// W): K1 with two blocks of 2 stages an SM 25.7-26.3 us against this
// shape's 24.9-25.4 us; K2 with 3 stages, K3 with 7 warps of 3 stages gain
// nothing; 10 or 12 warps lose to the smaller register budget.
constexpr int K1_WARPS = 8, K1_STAGES = 3, K1_BLOCKS_PER_SM = 1;
constexpr int K2_WARPS = 8, K2_STAGES = 2;
constexpr int K3_WARPS = 8, K3_STAGES = 2;
constexpr int NVEC = 7;                     // per-channel vectors kept in shared memory
constexpr int NSUM = 5;                     // per-channel sums a lane accumulates
constexpr int K1_STAGE_BYTES = (2 * F32_SLOT + 2 * B16_SLOT) * 4;  // exc datt | att_x dgated
constexpr int K2_STAGE_BYTES = (2 * F32_SLOT + 3 * B16_SLOT) * 4;  // inh dnew | conv inp gi_x
constexpr int K3_STAGE_BYTES = (4 * F32_SLOT + 2 * B16_SLOT) * 4;  // new_inh inh exc dnew | conv gated
constexpr int K1_PARTIAL = C * C + C;             // floats of a block's partial: da_u, db
constexpr int K2_PARTIAL = C * C + NRED * C;      // di_u, sums
constexpr int K3_PARTIAL = 2 * C * C + NRED * C;  // de_w, de_u, sums
constexpr int K1_SMEM = 2 * FRAGS * 8 + K1_WARPS * K1_STAGES * K1_STAGE_BYTES;
constexpr int K2_SMEM = 2 * FRAGS * 8 + NVEC * C * 4 + K2_WARPS * K2_STAGES * K2_STAGE_BYTES;
constexpr int K3_SMEM = 4 * FRAGS * 8 + NVEC * C * 4 + K3_WARPS * K3_STAGES * K3_STAGE_BYTES;
static_assert(K1_PARTIAL * 4 <= K1_STAGES * K1_STAGE_BYTES &&
              K2_PARTIAL * 4 <= K2_STAGES * K2_STAGE_BYTES &&
              K3_PARTIAL * 4 <= K3_STAGES * K3_STAGE_BYTES,
              "the block's reduction reuses the ring");
static_assert(K1_SMEM <= 232448 && K2_SMEM <= 232448 && K3_SMEM <= 232448,
              "227 KB of shared memory a block");
static_assert(K1_BLOCKS_PER_SM * (K1_SMEM + 1024) <= 233472, "228 KB of shared memory an SM");
constexpr int FINISH_GROUPS = 8;

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

__global__ void __launch_bounds__(K1_WARPS * 32, K1_BLOCKS_PER_SM)
k1_bwd_kernel(const float* __restrict__ exc, const bf16* __restrict__ att_x,
              const bf16* __restrict__ a_u, const float* __restrict__ a_u_b,
              const bf16* __restrict__ dgated, const float* __restrict__ datt,
              float* __restrict__ dexc, bf16* __restrict__ dattx, float* __restrict__ ws,
              long long rows) {
  extern __shared__ uint4 dyn_smem[];
  uint2* frag = reinterpret_cast<uint2*>(dyn_smem);  // a_u, a_u^T
  char* ring = reinterpret_cast<char*>(frag + 2 * FRAGS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  load_b_fragments<false>(a_u, frag);
  load_b_fragments<true>(a_u, frag + FRAGS);
  float2 bias[NT];  // a_u_b at this lane's channel pairs
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    bias[nt] = make_float2(a_u_b[nt * 8 + 2 * t], a_u_b[nt * 8 + 2 * t + 1]);
  __syncthreads();

  const LaneOffsets at(g, t);
  const bool has_datt = datt != nullptr;
  float acc_w[2][NT][4];
  float red[NT][2];  // column sums of dpre
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_w[0][nt][i] = acc_w[1][nt][i] = 0.0f;
    red[nt][0] = red[nt][1] = 0.0f;
  }

  char* my_ring = ring + warp * (K1_STAGES * K1_STAGE_BYTES);
  auto load = [&](int stage, long long item) {
    float* f = reinterpret_cast<float*>(my_ring + stage * K1_STAGE_BYTES);
    unsigned* h = reinterpret_cast<unsigned*>(f + 2 * F32_SLOT);
    const long long row0 = item * MROWS;
    stage_in<8>(f, exc, row0, rows, lane);
    if (has_datt) stage_in<8>(f + F32_SLOT, datt, row0, rows, lane);
    stage_in<4>(h, att_x, row0, rows, lane);
    stage_in<4>(h + B16_SLOT, dgated, row0, rows, lane);
  };
  ring_loop<K1_WARPS, K1_STAGES>(rows, warp, load, [&](int stage, long long item) {
    float* s_x = reinterpret_cast<float*>(my_ring + stage * K1_STAGE_BYTES);
    const float* s_da = s_x + F32_SLOT;
    unsigned* s_ax = reinterpret_cast<unsigned*>(s_x + 2 * F32_SLOT);
    const unsigned* s_dg = s_ax + B16_SLOT;

    // Recompute exc @ a_u; exc rounds to bf16 into the A fragment.
    unsigned xa[KS][4];
    float pre[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 x = *reinterpret_cast<const float2*>(&s_x[at.f32[nt] + half * 8 * C]);
        xa[nt / 2][a_reg(nt, half)] = pack_bf16(x.x, x.y);
        pre[nt][2 * half] = pre[nt][2 * half + 1] = 0.0f;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = frag[(ks * NT + nt) * 32 + lane];
        mma_bf16(pre[nt], xa[ks], b.x, b.y);
      }

    // Elementwise, in the accumulator layout. `back` starts as the direct
    // part of dexc and takes dpre @ a_u^T on top.
    unsigned da[KS][4];
    float back[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int fo = at.f32[nt] + half * 8 * C, bo = at.b16[nt] + half * 4 * C;
        const float2 x2 = *reinterpret_cast<const float2*>(&s_x[fo]);
        const float2 d2 =
            has_datt ? *reinterpret_cast<const float2*>(&s_da[fo]) : make_float2(0.0f, 0.0f);
        const float2 ax2 = unpack_bf16(s_ax[bo]);
        const float2 dg2 = unpack_bf16(s_dg[bo]);
        float dpre_[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = e ? x2.y : x2.x, dd = e ? d2.y : d2.x, ax = e ? ax2.y : ax2.x,
                      dg = e ? dg2.y : dg2.x, b = e ? bias[nt].y : bias[nt].x;
          const float att = gate_sigmoid(ax + pre[nt][2 * half + e] + b);
          const float dpre = (dg * x + dd) * att * (1.0f - att);
          red[nt][e] += dpre;
          back[nt][2 * half + e] = dg * att;
          dpre_[e] = dpre;
        }
        const unsigned d = pack_bf16(dpre_[0], dpre_[1]);  // dpre rounds once, here
        da[nt / 2][a_reg(nt, half)] = d;
        s_ax[bo] = d;  // dattx over att_x
      }

    // dexc = dgated * att + dpre @ a_u^T, over the staged exc.
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
        *reinterpret_cast<float2*>(&s_x[at.f32[nt] + half * 8 * C]) =
            make_float2(back[nt][2 * half], back[nt][2 * half + 1]);

    // da_u += exc^T @ dpre.
    unsigned dt[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      dt[nt][0] = transpose_8x8(da[nt / 2][a_reg(nt, 0)]);
      dt[nt][1] = transpose_8x8(da[nt / 2][a_reg(nt, 1)]);
    }
    wgrad_acc(acc_w, xa, dt);

    __syncwarp();  // every lane's outputs are staged
    const long long row0 = item * MROWS;
    stage_out<8>(dexc, s_x, row0, rows, lane);
    stage_out<4>(dattx, s_ax, row0, rows, lane);
  });
  __syncthreads();  // every warp has left its ring

  float* part = reinterpret_cast<float*>(ring) + warp * K1_PARTIAL;
  store_wgrad(acc_w, part, g, t);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // over the 8 row groups, in a fixed butterfly
      float v = red[nt][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) part[C * C + nt * 8 + 2 * t + e] = v;
    }
  __syncthreads();
  block_partial<K1_WARPS>(reinterpret_cast<float*>(ring), K1_PARTIAL, ws);
}

__global__ void __launch_bounds__(K2_WARPS * 32, 1)
k2_bwd_kernel(const bf16* __restrict__ conv_i, const float* __restrict__ mean0,
              const float* __restrict__ rstd0, const float* __restrict__ scale0,
              const float* __restrict__ bias0, const bf16* __restrict__ inp,
              const bf16* __restrict__ gi_x, const float* __restrict__ inh,
              const bf16* __restrict__ i_u, const float* __restrict__ i_u_b,
              const float* __restrict__ alpha, const float* __restrict__ mu,
              const float* __restrict__ dnew, float* __restrict__ dconv,
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
  ring_loop<K2_WARPS, K2_STAGES>(rows, warp, load, [&](int stage, long long item) {
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
        *reinterpret_cast<float2*>(&s_dn[fo]) = make_float2(dconv_[0], dconv_[1]);  // f32, unrounded
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
    stage_out<8>(dconv, s_dn, row0, rows, lane);
    stage_out<4>(dinp, s_in, row0, rows, lane);
    stage_out<4>(dgix, s_gx, row0, rows, lane);
  });
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
              float* __restrict__ dconv, float* __restrict__ dninh,
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
  ring_loop<K3_WARPS, K3_STAGES>(rows, warp, load, [&](int stage, long long item) {
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
        *reinterpret_cast<float2*>(&s_ni[fo]) = make_float2(dninh_[0], dninh_[1]);
        *reinterpret_cast<float2*>(&s_e[fo]) = make_float2(dexc_[0], dexc_[1]);
        // dconv stored last: stored before dninh and dexc it spills 24 B a thread
        *reinterpret_cast<float2*>(&s_dn[fo]) = make_float2(dconv_[0], dconv_[1]);  // f32, as K2's
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
    stage_out<8>(dconv, s_dn, row0, rows, lane);
    stage_out<4>(dgated, s_ge, row0, rows, lane);
  });
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

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// <kernel>_blocks(rows): the grid the launch below uses, which is the leading
// size of its f32 partial workspace: K1 [blocks, 32 + 1, 32], K2 [blocks,
// 32 + 7, 32], K3 [blocks, 64 + 7, 32].
int k1_attention_bwd_blocks(long long rows) {
  return rows > 0 ? ring_grid_for(k1_bwd_kernel, K1_WARPS, K1_SMEM, rows) : 0;
}
int k2_inhibition_bwd_blocks(long long rows) {
  return rows > 0 ? ring_grid_for(k2_bwd_kernel, K2_WARPS, K2_SMEM, rows) : 0;
}
int k3_excitation_bwd_blocks(long long rows) {
  return rows > 0 ? ring_grid_for(k3_bwd_kernel, K3_WARPS, K3_SMEM, rows) : 0;
}

// Two kernels on `stream`: the phase, then the sum over its blocks. `datt`
// may be null: the attention map had no cotangent (read as zeros). da_u is
// [32, 32] bf16, db [32] f32; ws the f32 workspace sized by
// k1_attention_bwd_blocks. Row arrays must be 16-byte aligned (cp.async).
int k1_attention_bwd(const void* exc, const void* att_x, const void* a_u,
                     const void* a_u_b, const void* dgated, const void* datt,
                     void* dexc, void* dattx, void* da_u, void* db, void* ws,
                     long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned_16({exc, att_x, dgated, datt, dexc, dattx}))
    return (int)cudaErrorMisalignedAddress;
  const int blocks = ring_grid_for(k1_bwd_kernel, K1_WARPS, K1_SMEM, rows);
  if (blocks <= 0) return blocks < 0 ? -blocks : (int)cudaErrorInvalidValue;
  k1_bwd_kernel<<<blocks, K1_WARPS * 32, K1_SMEM, (cudaStream_t)stream>>>(
      (const float*)exc, (const bf16*)att_x, (const bf16*)a_u, (const float*)a_u_b,
      (const bf16*)dgated, (const float*)datt, (float*)dexc, (bf16*)dattx, (float*)ws,
      rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<K1_PARTIAL / 32, 32 * FINISH_GROUPS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, blocks, K1_PARTIAL, 1, (bf16*)da_u, nullptr, (float*)db);
  return (int)cudaGetLastError();
}

// As k1_attention_bwd. dconv is [rows, 32] f32, dinp and dgix bf16, dinh f32;
// di_u is [32, 32] bf16; sums [7, 32] f32 = [di_u_b,
// dalpha, dmu, dmean, drstd, dscale, dbias]; ws the f32 workspace sized by
// k2_inhibition_bwd_blocks.
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
      (const float*)alpha, (const float*)mu, (const float*)dnew, (float*)dconv,
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
      (const float*)kappa, (const float*)gamma, (const float*)dnew, (float*)dconv,
      (float*)dninh, (float*)dinh, (bf16*)dgated, (float*)dexc, (float*)ws, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<K3_PARTIAL / 32, 32 * FINISH_GROUPS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, blocks, K3_PARTIAL, 2, (bf16*)de_w, (bf16*)de_u, (float*)sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
