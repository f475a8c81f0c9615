// Flash attention forward for Hopper (sm_90a), non-causal, [B, S, H, D].
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_impl`
// (chiaswarm_tpu/ops/flash_attention.py): softmax(q k^T * scale) v with an
// online softmax over KV tiles (running max m, running sum l, f32
// accumulator), so the [Sq, Skv] score matrix never reaches device memory.
// Scores stay in f32 with the scale applied in f32; KV columns past the true
// length are masked to -1e30 (ragged cross-attention lengths such as 77); P
// is rounded to the input type before P.V, as in the TPU kernel; the output
// is acc / max(l, 1e-30), written in the [B, S, H, D] layout it came in.
//
// What bounds it on an H100: operations, 4*B*H*Sq*Skv*D flops against
// 989 TFLOP/s of bf16 tensor cores, for every self-attention; the 77-token
// cross-attention moves more bytes than it computes and is bound by them
// (and, at a few microseconds, by launch and load latency). At D = 64 the
// softmax weighs as much as the products: each score costs one exp2 on the
// SFUs (16 a cycle per SM) and about five more instructions from the warp
// schedulers, against 128 flops on the tensor cores (4096 a cycle per SM).
// The design runs the two side by side and keeps the softmax short: on a
// full tile (no masked column, positive scale) the scale folds into the
// exponent's FMA and no mask is applied. Three paths:
//
//   - bf16, D in {40, 64, 80, 128, 160} (every UNet attention of SDXL,
//     SD 2.x and SD 1.x, and Flux's joint attention at D = 128):
//     `flash_fwd_wgmma<D>`, warp specialised, one template over the head
//     width (its tiles per width are at `WgTiles`). One producer
//     warpgroup (one thread issues TMA loads, the rest give their
//     registers away with setmaxnreg) and three consumer warpgroups (two
//     at D = 80, 128 and 160), each owning 64 of the CTA's query rows, so
//     every K/V tile feeds 192 (128) rows. K and V tiles of 128 rows (64
//     at D = 160) move through a 3-stage ring in shared memory, each stage
//     with a full barrier for K, one for V and one empty barrier, so
//     copies run two tiles ahead of the products. The tensor maps cover
//     q, k, v as they lie (dims {D, H, S, B}, box {64, 1, rows, 1},
//     128-byte swizzle; a row is ceil(D / 64) boxes); TMA fills rows past
//     Sq or Skv and columns past D with zeros, and the -1e30 column mask
//     does the rest. S = Q.K^T is wgmma (m64n128k16, m64n64k16 for 64-row
//     tiles) with both operands K-major in shared memory; O += P.V is
//     wgmma with P in registers (the S accumulators, softmaxed and packed
//     to bf16) and V read from shared memory as an MN-major operand, so V
//     is never transposed. Each consumer
//     issues S of tile j with P.V of tile j-1 and runs the softmax of tile
//     j after them; the consumers take turns in a ring to issue, so one's
//     softmax overlaps the others' products.
//   - bf16, D == 512 (the VAE mid-block's single head): `flash_fwd_wgmma512`.
//     A 64x512 f32 accumulator is 256 registers a thread in one warpgroup,
//     so two consumer warpgroups share 64 query rows and each owns half of
//     the output width (128 registers). Each computes S over its half of
//     D (the K-split of Q.K^T), the two halves are summed through shared
//     memory, and both run the same softmax on the same S, so S is
//     computed once and P stays in registers for wgmma. Q (64 KB), a K
//     tile and a V tile (64 KB each, 64 rows loaded as 8 boxes of 64
//     columns) fill shared memory; K and V have their own barriers, so
//     K of tile j+1 loads during P.V of tile j and V of tile j+1 during
//     S of tile j+1.
//   - every other case (f32 inputs, other bf16 head widths up to 512): an
//     FMA kernel in plain f32, no TF32, so f32 meets the
//     2e-5 bound of the reference test; 16-byte loads fill the tiles. It is
//     right, not fast.
//
// C interface (bound with ctypes): fa_forward returns cudaGetLastError()
// after the launch, 0 on success, and reports which kernel took the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowBytes = 64 * 2;  // one 64-wide bf16 row of a tile

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Online-softmax update of one KV tile's scores held as a wgmma
// accumulator (s[4i..4i+3] = group i of 8 columns, rows g and g+8): scale
// to the log2 domain in f32, mask columns at or past Skv, fold into the
// running max (m0, m1) and the per-thread partial sums (l0, l1), and
// return the rescale factors for the output accumulator.
//
// kFull: a tile with no masked column and a positive scale. The row max is
// then taken over the raw scores (rounding is monotonic, so
// fl(max(s) * c) == max(fl(s * c)) for c > 0) and the scale folds into the
// exponent's FMA: p = 2^(s * c - m), with one rounding fewer. This saves
// the multiply and the mask's compares and selects on every tile but the
// last; at D = 64 the softmax's instruction count, not the SFU, is what
// keeps the tensor cores waiting.
template <bool kFull, int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], int col0, int Skv,
                                               float scale_log2, float& m0, float& m1,
                                               float& l0, float& l1, float& alpha0,
                                               float& alpha1) {
  const int t = threadIdx.x & 3;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) {
    if constexpr (!kFull) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[4 * i + e] * scale_log2;
        if (col0 + 8 * i + 2 * t + (e & 1) >= Skv) val = kNegInf;
        s[4 * i + e] = val;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
  if constexpr (kFull) {
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  alpha0 = exp2_ftz(m0 - mn0);
  alpha1 = exp2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  const float c = kFull ? scale_log2 : 1.f;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) {
    s[4 * i] = exp2_ftz(fmaf(s[4 * i], c, -mn0));
    s[4 * i + 1] = exp2_ftz(fmaf(s[4 * i + 1], c, -mn0));
    s[4 * i + 2] = exp2_ftz(fmaf(s[4 * i + 2], c, -mn1));
    s[4 * i + 3] = exp2_ftz(fmaf(s[4 * i + 3], c, -mn1));
    rs0 += s[4 * i] + s[4 * i + 1];
    rs1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
}

// the softmax of KV tile j (columns col0 ..): the full-tile form where it applies
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], int col0, int Skv,
                                             float scale_log2, float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1) {
  if (col0 + 2 * NS <= Skv && scale_log2 > 0.f)  // NS / 4 groups of 8 columns
    online_softmax<true>(s, col0, Skv, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
  else
    online_softmax<false>(s, col0, Skv, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
}

// the output accumulator (32 registers of one 64-column block) times the
// rescale factors of its two rows: its first kCols columns (the columns of
// a box past the head width stay zero)
template <int kCols = 64>
__device__ __forceinline__ void rescale(float* acc, float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i) {
    acc[4 * i] *= alpha0;
    acc[4 * i + 1] *= alpha0;
    acc[4 * i + 2] *= alpha1;
    acc[4 * i + 3] *= alpha1;
  }
}

// P for k16 slice kk of the scores: the A-operand registers of wgmma
__device__ __forceinline__ void pack_p(const float* s, int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// store one 64-column block of the output: its first kCols columns (a box
// past the head width is not written there)
template <int kCols = 64>
__device__ __forceinline__ void store_block(const float* acc, float inv0, float inv1,
                                            __nv_bfloat16* ob, size_t row_stride, int r0,
                                            int Sq, int col0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i) {
    const int c = col0 + 8 * i + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * row_stride + c) =
          pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8) * row_stride + c) =
          pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
}

// quad-reduce the row sums and take their inverses
__device__ __forceinline__ void row_sums(float& l0, float& l1, float& inv0, float& inv1) {
  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  inv0 = 1.f / fmaxf(l0, 1e-30f);
  inv1 = 1.f / fmaxf(l1, 1e-30f);
}

// ---------------------------------------------------------------------
// bf16, D in {40, 64, 80, 128, 160}: one warp-specialised kernel, a template
// over the head width
// ---------------------------------------------------------------------

// Tiles for each head width. A row of Q, K or V loads as ceil(D / 64)
// boxes of 64 columns (one 128-byte swizzle atom each); TMA writes zeros
// past D, so S = Q.K^T needs only ceil(D / 16) k16 slices (3, 4, 5, 8, 10),
// a compile-time count: a wgmma under a branch would be serialised.
//
// P.V runs n64 wgmmas over whole boxes, so it computes 64 / 128 / 192
// output columns for D = 40 / 80 / 160 and the stores drop the zero
// columns past D. The exact widths (n40, n64 + n16, 2 x n64 + n32) would
// need an MN-major V operand narrower than its 128-byte swizzle atom,
// outside the canonical wgmma layouts that the D = 64 and D = 512 kernels
// use; and the padding costs tensor-core time, which is not what bounds
// these widths: every score costs one exp2 whatever D is, and the narrow
// heads do the fewest flops per score (at D = 40 the SFU's 16 exp2 a
// cycle per SM is slower than the products, padded or not).
//
// Registers (ptxas -v for sm_90a): every instance builds with 0 bytes of
// spill stores and loads; ptxas reports the launch allotment (128
// registers a thread at D = 40 and 64, 168 at 80, 128 and 160), and the
// consumers run at the setmaxnreg counts below.
template <int D>
struct WgTiles;

// D = 64 (SDXL, SD 2.x) and D = 40 (SD 1.x's first level): three consumer
// warpgroups of 64 query rows and 128-row K/V tiles in 3 stages (120 KB of
// shared memory). The CTA is launched at 65536 / 512 = 128 registers a
// thread; the producer keeps 32 and gives the rest to the consumers (160
// each): S (64), P (32) and a one-box accumulator (32).
template <>
struct WgTiles<64> {
  static constexpr int kConsumers = 3, kBN = 128, kStages = 3;
  static constexpr uint32_t kProducerRegs = 32, kConsumerRegs = 160;
};
template <>
struct WgTiles<40> : WgTiles<64> {};

// D = 80 (SD 1.x's second level): a two-box accumulator (64 registers)
// beside S and P would spill at 160, so two consumers at 232 (the
// producer keeps 40; launched at 168), 128-row tiles in 3 stages: 224 KB.
template <>
struct WgTiles<80> {
  static constexpr int kConsumers = 2, kBN = 128, kStages = 3;
  static constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
};

// D = 128 (Flux's 24 heads of its 3072-wide joint attention): two whole
// boxes a row, as D = 80 has, with no padded columns; the same tiles (two
// consumers at 232 registers: S 64, P 32, the two-box accumulator 64) and
// the same 224 KB of shared memory. P.V computes exactly the head width,
// so a score costs twice the products of D = 64 for the same exp2: the
// tensor cores, not the SFU, bound this width.
template <>
struct WgTiles<128> : WgTiles<80> {};

// D = 160 (SD 1.x's third level and mid block): three boxes a row; 128-row
// K and V tiles would be 96 KB a stage, so 64-row tiles (S 32 registers,
// P 16, the accumulator 96) in 3 stages: 192 KB, two consumers at 232.
template <>
struct WgTiles<160> {
  static constexpr int kConsumers = 2, kBN = 64, kStages = 3;
  static constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
};

template <int D>
struct Wg : WgTiles<D> {
  using T = WgTiles<D>;
  static constexpr int kBoxes = (D + 63) / 64;  // 64-column boxes of a row
  static constexpr int kSteps = (D + 15) / 16;  // k16 slices of Q.K^T
  static constexpr int kThreads = 128 * (T::kConsumers + 1);
  static constexpr int kBM = 64 * T::kConsumers;  // query rows per CTA
  static constexpr uint32_t kConsumerThreads = 128 * T::kConsumers;
  static constexpr uint32_t kQBoxBytes = kBM * kRowBytes;      // one box of Q
  static constexpr uint32_t kKvBytes = T::kBN * kRowBytes;     // one box of K or V
  static constexpr int kNS = T::kBN / 2;   // S registers a thread (kBN / 8 groups of 4)
  static constexpr int kPV = T::kBN / 16;  // k16 slices of P.V
  static constexpr int kLastCols = D - 64 * (kBoxes - 1);  // head columns in the last box
  // registers a thread at launch: 65536 over the threads, a multiple of 8
  static constexpr uint32_t kLaunchRegs = (65536 / kThreads) & ~7u;
  static_assert(D % 8 == 0 && D <= 64 * kBoxes, "head width");
  static_assert(128 * T::kProducerRegs + kConsumerThreads * T::kConsumerRegs <=
                    kLaunchRegs * kThreads,
                "registers");
};

template <int D>
struct SmemWg {
  using C = Wg<D>;
  __nv_bfloat16 q[C::kBoxes][C::kBM * 64];
  __nv_bfloat16 k[C::kStages][C::kBoxes][C::kBN * 64];
  __nv_bfloat16 v[C::kStages][C::kBoxes][C::kBN * 64];
  uint64_t q_full, k_full[C::kStages], v_full[C::kStages], empty[C::kStages];
};

constexpr uint32_t kTurnBarrier = 1;  // named barriers 1 .. consumers: whose turn it is

// S = Q K^T for one K tile (Q's rows of this consumer at q_addr)
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[Wg<D>::kNS], uint32_t q_addr,
                                        uint32_t k_addr) {
  using C = Wg<D>;
#pragma unroll
  for (int ks = 0; ks < C::kSteps; ++ks) {
    const uint32_t qo = (ks / 4) * C::kQBoxBytes + (ks % 4) * 32;
    const uint32_t ko = (ks / 4) * C::kKvBytes + (ks % 4) * 32;
    if constexpr (C::kBN == 128)
      wgmma_m64n128k16_ss(s, desc_kmajor(q_addr + qo), desc_kmajor(k_addr + ko), ks > 0);
    else
      wgmma_m64n64k16_ss(s, desc_kmajor(q_addr + qo), desc_kmajor(k_addr + ko), ks > 0);
  }
}

// O += P V for one V tile: P from registers, V MN-major in shared memory,
// one n64 product per box
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[Wg<D>::kBoxes][32],
                                         const uint32_t (&pa)[Wg<D>::kPV][4], uint32_t v_addr) {
  using C = Wg<D>;
#pragma unroll
  for (int kk = 0; kk < C::kPV; ++kk)
#pragma unroll
    for (int nb = 0; nb < C::kBoxes; ++nb)
      wgmma_m64n64k16_rs(acc[nb], pa[kk],
                         desc_mnmajor(v_addr + nb * C::kKvBytes + kk * 16 * kRowBytes));
}

// The consumers take turns, in a ring, to issue their products, so one's
// softmax (SFU) overlaps the others' wgmma (tensor cores); with two this
// is the ping-pong of FlashAttention-3. Named barrier kTurnBarrier + c is
// consumer c's turn: c syncs on it, and its predecessor arrives on it
// after issuing. Consumer 0 goes first: the last consumer arrives once up
// front and skips its arrival after its last tile, so the counts match.
__device__ __forceinline__ void take_turn(int cw) {
  named_barrier_sync(kTurnBarrier + cw, 256);
}

template <int kConsumers>
__device__ __forceinline__ void pass_turn(int cw, bool more) {
  if (cw != kConsumers - 1 || more)
    named_barrier_arrive(kTurnBarrier + (cw + 1) % kConsumers, 256);
}

template <int D>
__global__ void __launch_bounds__(Wg<D>::kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int Sq,
                int Skv, int H, float scale_log2) {
  using C = Wg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  SmemWg<D>& sm = *reinterpret_cast<SmemWg<D>*>(align1024(smem_raw));
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * C::kBM;
  const int n_tiles = (Skv + C::kBN - 1) / C::kBN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], C::kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      mbar_expect_tx(&sm.q_full, C::kBoxes * C::kQBoxBytes);
#pragma unroll
      for (int nb = 0; nb < C::kBoxes; ++nb)
        tma_load_4d(sm.q[nb], &tq, &sm.q_full, 64 * nb, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[s], C::kBoxes * C::kKvBytes);
#pragma unroll
        for (int nb = 0; nb < C::kBoxes; ++nb)
          tma_load_4d(sm.k[s][nb], &tk, &sm.k_full[s], 64 * nb, h, j * C::kBN, b);
        mbar_expect_tx(&sm.v_full[s], C::kBoxes * C::kKvBytes);
#pragma unroll
        for (int nb = 0; nb < C::kBoxes; ++nb)
          tma_load_4d(sm.v[s][nb], &tv, &sm.v_full[s], 64 * nb, h, j * C::kBN, b);
      }
    }
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    const int cw = wg - 1;  // which 64 query rows of the CTA
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const uint32_t q_addr = smem_addr(sm.q) + cw * 64 * kRowBytes;

    float acc[C::kBoxes][32], s[C::kNS];
    uint32_t pa[C::kPV][4];  // P of the previous tile, the A operand of its P.V
#pragma unroll
    for (int nb = 0; nb < C::kBoxes; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::kNS; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::kPV; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // S of tile j is issued together with P.V of tile j-1, in one turn.
    // (ptxas places the wait for that P.V above the exponentials, so a
    // softmax overlaps the other consumers' products, not its own P.V.)
    // Tile 0 (S only) is peeled off: a wgmma issued under a branch makes
    // ptxas serialize the products.
    mbar_wait(&sm.q_full, 0);
    if (cw == C::kConsumers - 1) named_barrier_arrive(kTurnBarrier, 256);
    {
      mbar_wait(&sm.k_full[0], 0);
      take_turn(cw);
      fence_regs(s, C::kNS);
      wgmma_fence();
      issue_s<D>(s, q_addr, smem_addr(sm.k[0]));
      wgmma_commit();
      pass_turn<C::kConsumers>(cw, n_tiles > 1);
      wgmma_wait<0>();
      fence_regs(s, C::kNS);
      float alpha0, alpha1;  // the accumulator is still zero
      softmax_tile(s, 0, Skv, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
#pragma unroll
      for (int kk = 0; kk < C::kPV; ++kk) pack_p(s, kk, pa[kk]);
    }
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages;
      const int pst = (j - 1) % kStages;  // stage of tile j-1
      mbar_wait(&sm.k_full[st], (j / kStages) & 1);
      mbar_wait(&sm.v_full[pst], ((j - 1) / kStages) & 1);
      // opaque: the descriptors are rebuilt here, not held across the loop
      const uint32_t qa = opaque(q_addr);
      const uint32_t ka = opaque(smem_addr(sm.k[st]));
      const uint32_t va = opaque(smem_addr(sm.v[pst]));

      take_turn(cw);
      fence_regs(s, C::kNS);
#pragma unroll
      for (int nb = 0; nb < C::kBoxes; ++nb) fence_regs(acc[nb], 32);
#pragma unroll
      for (int kk = 0; kk < C::kPV; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
      issue_s<D>(s, qa, ka);
      wgmma_commit();
      issue_pv<D>(acc, pa, va);
      wgmma_commit();
      pass_turn<C::kConsumers>(cw, j + 1 < n_tiles);
      wgmma_wait<1>();  // S of tile j is in
      fence_regs(s, C::kNS);

      float alpha0, alpha1;
      softmax_tile(s, j * C::kBN, Skv, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < C::kBoxes; ++nb) fence_regs(acc[nb], 32);
      mbar_arrive(&sm.empty[pst]);  // K and V of tile j-1 are consumed
#pragma unroll
      for (int nb = 0; nb < C::kBoxes - 1; ++nb) rescale(acc[nb], alpha0, alpha1);
      rescale<C::kLastCols>(acc[C::kBoxes - 1], alpha0, alpha1);
#pragma unroll
      for (int kk = 0; kk < C::kPV; ++kk) pack_p(s, kk, pa[kk]);
    }

    // P.V of the last tile
    const int last = (n_tiles - 1) % kStages;
    mbar_wait(&sm.v_full[last], ((n_tiles - 1) / kStages) & 1);
#pragma unroll
    for (int nb = 0; nb < C::kBoxes; ++nb) fence_regs(acc[nb], 32);
#pragma unroll
    for (int kk = 0; kk < C::kPV; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
    issue_pv<D>(acc, pa, smem_addr(sm.v[last]));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < C::kBoxes; ++nb) fence_regs(acc[nb], 32);
    mbar_arrive(&sm.empty[last]);

    float inv0, inv1;
    row_sums(l0, l1, inv0, inv1);
    __nv_bfloat16* ob = o + ((size_t)b * Sq * H + h) * D;
    const int r0 = q0 + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int nb = 0; nb < C::kBoxes - 1; ++nb)
      store_block(acc[nb], inv0, inv1, ob, (size_t)H * D, r0, Sq, 64 * nb);
    store_block<C::kLastCols>(acc[C::kBoxes - 1], inv0, inv1, ob, (size_t)H * D, r0, Sq,
                              64 * (C::kBoxes - 1));
  }
}

// ---------------------------------------------------------------------
// bf16, D == 512
// ---------------------------------------------------------------------

// One producer and two consumer warpgroups: launched at 168 registers a
// thread, the producer keeps 40 and the consumers take 232.
constexpr int k512Threads = 384;
constexpr uint32_t k512ProducerRegs = 40;
constexpr uint32_t k512ConsumerRegs = 232;
constexpr uint32_t k512ConsumerThreads = 256;
constexpr int k512BM = 64;  // query rows per CTA, shared by both consumer warpgroups
constexpr int k512BN = 64;  // KV rows per tile
constexpr int k512Blocks = 8;  // 64-column blocks of a 512-wide row
constexpr uint32_t k512BoxBytes = 64 * kRowBytes;  // one 64x64 box: 8 KB
constexpr uint32_t k512TileBytes = k512Blocks * k512BoxBytes;  // 64 KB

struct Smem512 {
  __nv_bfloat16 q[k512Blocks][k512BM * 64];
  __nv_bfloat16 k[k512Blocks][k512BN * 64];
  __nv_bfloat16 v[k512Blocks][k512BN * 64];
  float4 red[2][8][128];  // each consumer warpgroup's partial scores, per thread
  uint64_t q_full, k_full, k_empty, v_full, v_empty;
};

__global__ void __launch_bounds__(k512Threads, 1)
flash_fwd_wgmma512(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int Sq,
                   int Skv, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem512& sm = *reinterpret_cast<Smem512*>(align1024(smem_raw));
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * k512BM;
  const int n_tiles = (Skv + k512BN - 1) / k512BN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.k_full, 1);
    mbar_init(&sm.v_full, 1);
    mbar_init(&sm.k_empty, k512ConsumerThreads);
    mbar_init(&sm.v_empty, k512ConsumerThreads);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<k512ProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      mbar_expect_tx(&sm.q_full, k512TileBytes);
#pragma unroll
      for (int c = 0; c < k512Blocks; ++c) tma_load_4d(sm.q[c], &tq, &sm.q_full, 64 * c, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t phase = j & 1;
        mbar_wait(&sm.k_empty, phase ^ 1);
        mbar_expect_tx(&sm.k_full, k512TileBytes);
#pragma unroll
        for (int c = 0; c < k512Blocks; ++c)
          tma_load_4d(sm.k[c], &tk, &sm.k_full, 64 * c, h, j * k512BN, b);
        mbar_wait(&sm.v_empty, phase ^ 1);
        mbar_expect_tx(&sm.v_full, k512TileBytes);
#pragma unroll
        for (int c = 0; c < k512Blocks; ++c)
          tma_load_4d(sm.v[c], &tv, &sm.v_full, 64 * c, h, j * k512BN, b);
      }
    }
  } else {
    setmaxnreg_inc<k512ConsumerRegs>();
    const int cw = wg - 1;  // which half of D this warpgroup reduces over and owns
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const uint32_t q_addr = smem_addr(sm.q[4 * cw]);
    const uint32_t k_addr = smem_addr(sm.k[4 * cw]);
    const uint32_t v_addr = smem_addr(sm.v[4 * cw]);

    float acc[4][32];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(&sm.q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const uint32_t phase = j & 1;

      // this warpgroup's half of S = Q K^T: columns 256*cw .. +256 of D,
      // four 64-column boxes of four k16 slices each
      mbar_wait(&sm.k_full, phase);
      float s[32];
      const uint32_t qa = opaque(q_addr), ka = opaque(k_addr);
      fence_regs(s, 32);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        const uint32_t off = (ks / 4) * k512BoxBytes + (ks % 4) * 32;
        wgmma_m64n64k16_ss(s, desc_kmajor(qa + off), desc_kmajor(ka + off), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s, 32);
      mbar_arrive(&sm.k_empty);

      // sum the two halves: both warpgroups end with the same S
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sm.red[cw][i][tid] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      named_barrier_sync(1, k512ConsumerThreads);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 other = sm.red[cw ^ 1][i][tid];
        s[4 * i] += other.x;
        s[4 * i + 1] += other.y;
        s[4 * i + 2] += other.z;
        s[4 * i + 3] += other.w;
      }
      named_barrier_sync(2, k512ConsumerThreads);  // both read before the next tile writes

      float alpha0, alpha1;
      softmax_tile(s, j * k512BN, Skv, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) rescale(acc[nb], alpha0, alpha1);

      // O += P V over this warpgroup's four 64-column blocks of V
      mbar_wait(&sm.v_full, phase);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pack_p(s, kk, pa[kk]);
        fence_regs(pa[kk]);
      }
      const uint32_t va = opaque(v_addr);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) fence_regs(acc[nb], 32);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          wgmma_m64n64k16_rs(acc[nb], pa[kk],
                             desc_mnmajor(va + nb * k512BoxBytes + kk * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) fence_regs(acc[nb], 32);
      mbar_arrive(&sm.v_empty);
    }

    float inv0, inv1;
    row_sums(l0, l1, inv0, inv1);
    __nv_bfloat16* ob = o + ((size_t)b * Sq * H + h) * 512;
    const int r0 = q0 + warp * 16 + g;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
      store_block(acc[nb], inv0, inv1, ob, (size_t)H * 512, r0, Sq, 64 * (4 * cw + nb));
  }
}

// ---------------------------------------------------------------------
// FMA kernel: f32 math for any D <= DMAX (f32 inputs, and bf16 at the other widths)
// ---------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte load (8 bf16 or 4 f32) converted to f32; zeros when !ok
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, bool ok, float (&f)[16 / sizeof(T)]) {
  constexpr int N = 16 / sizeof(T);
  uint4 u = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
}

template <typename T, int DMAX, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
flash_fwd_fma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int Sq, int Skv, int H, int D, float scale) {
  constexpr int PER_THREAD = (BQ * DMAX + NT - 1) / NT;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int KS = D + 1;  // padded sK stride: column reads hit distinct banks
  float* sQ = smem;                    // [BQ][D]
  float* sK = sQ + BQ * D;             // [BK][D+1]
  float* sV = sK + BK * KS;            // [BK][D]
  float* sS = sV + BK * D;             // [BQ][BK+1]
  float* sM = sS + BQ * (BK + 1);      // [BQ] running max
  float* sL = sM + BQ;                 // [BQ] running sum
  float* sA = sL + BQ;                 // [BQ] rescale of this tile

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const size_t row_stride = (size_t)H * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * H + h) * D;
  const T* vb = v + ((size_t)b * Skv * H + h) * D;
  T* ob = o + ((size_t)b * Sq * H + h) * D;

  const int vecs = D / VEC;  // D % 8 == 0, so rows split into 16-byte vectors
  for (int idx = tid; idx < BQ * vecs; idx += NT) {
    const int r = idx / vecs, d = (idx % vecs) * VEC;
    float f[VEC];
    load_vec<T>(qb + (size_t)(q0 + r) * row_stride + d, q0 + r < Sq, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) sQ[r * D + d + e] = f[e];
  }
  for (int r = tid; r < BQ; r += NT) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < Skv; j0 += BK) {
    __syncthreads();
#pragma unroll 4
    for (int idx = tid; idx < BK * vecs; idx += NT) {
      const int r = idx / vecs, d = (idx % vecs) * VEC;
      const bool ok = j0 + r < Skv;
      float fk[VEC], fv[VEC];
      load_vec<T>(kb + (size_t)(j0 + r) * row_stride + d, ok, fk);
      load_vec<T>(vb + (size_t)(j0 + r) * row_stride + d, ok, fv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sK[r * KS + d + e] = fk[e];
        sV[r * D + d + e] = fv[e];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * BK; idx += NT) {
      int r = idx / BK, c = idx % BK;
      const float* qr = sQ + r * D;
      const float* kr = sK + c * KS;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      sS[r * (BK + 1) + c] = (j0 + c < Skv) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < BQ; r += NT) {
      float* sr = sS + r * (BK + 1);
      float mx = kNegInf;
      for (int c = 0; c < BK; ++c) mx = fmaxf(mx, sr[c]);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        float p = expf(sr[c] - m_new);
        sum += p;
        sr[c] = to_f32(from_f32<T>(p));  // P in the input type for P.V
      }
      const float alpha = expf(m_old - m_new);
      sA[r] = alpha;
      sL[r] = sL[r] * alpha + sum;
      sM[r] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = tid + i * NT;
      if (idx < BQ * D) {
        const int r = idx / D, d = idx % D;
        const float* pr = sS + r * (BK + 1);
        float a = acc[i] * sA[r];
        for (int c = 0; c < BK; ++c) a = fmaf(pr[c], sV[c * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = tid + i * NT;
    if (idx < BQ * D) {
      const int r = idx / D, d = idx % D;
      if (q0 + r < Sq)
        ob[(size_t)(q0 + r) * row_stride + d] = from_f32<T>(acc[i] / fmaxf(sL[r], 1e-30f));
    }
  }
}

template <typename T, int DMAX, int BQ, int BK, int NT>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int H, int D, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_fma<T, DMAX, BQ, BK, NT>;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D +
                       (size_t)BQ * (BK + 1) + 3 * BQ);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv,
                                     H, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_any(const void* q, const void* k, const void* v, void* o, int B,
                           int Sq, int Skv, int H, int D, float scale, cudaStream_t s) {
  if (D <= 64) return launch_fma<T, 64, 64, 64, 256>(q, k, v, o, B, Sq, Skv, H, D, scale, s);
  if (D <= 128) return launch_fma<T, 128, 32, 64, 256>(q, k, v, o, B, Sq, Skv, H, D, scale, s);
  return launch_fma<T, 512, 16, 32, 256>(q, k, v, o, B, Sq, Skv, H, D, scale, s);
}

// tensor maps over q, k, v with `box_rows`-row boxes; the kernel's dynamic
// shared memory (plus 1 KB to align the tiles) is set once per kernel
template <typename Smem, typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, int threads, int D, int BM, int BN, const void* q,
                         const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
                         float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_bshd_map(&tq, q, B, Sq, H, D, BM) || !make_bshd_map(&tk, k, B, Skv, H, D, BN) ||
      !make_bshd_map(&tv, v, B, Skv, H, D, BN))
    return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem) + 1024;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  kernel<<<grid, threads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv,
                                           H, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int H, float scale, cudaStream_t stream) {
  using C = Wg<D>;
  return launch_wgmma<SmemWg<D>>(flash_fwd_wgmma<D>, C::kThreads, D, C::kBM, C::kBN, q, k, v,
                                 o, B, Sq, Skv, H, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous [B, S, H, D].
// *route is set to the kernel that takes the call: the head width of the
// tensor-core kernel (40, 64, 80, 128, 160 or 512), or 0 for the FMA kernel.
// Returns a cudaError_t (0 = success); 1 (cudaErrorInvalidValue) for a
// dtype/D the kernels do not take (the Python wrapper checks first) or a
// tensor map the driver refuses.
int fa_forward(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
               int H, int D, float scale, int dtype, void* stream, int* route) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = 0;
  if (D < 1 || D > 512 || Sq < 1 || Skv < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 40 || D == 64 || D == 80 || D == 128 || D == 160 || D == 512) *route = D;
    switch (D) {
      case 40:
        return (int)launch_wg<40>(q, k, v, o, B, Sq, Skv, H, scale, s);
      case 64:
        return (int)launch_wg<64>(q, k, v, o, B, Sq, Skv, H, scale, s);
      case 80:
        return (int)launch_wg<80>(q, k, v, o, B, Sq, Skv, H, scale, s);
      case 128:
        return (int)launch_wg<128>(q, k, v, o, B, Sq, Skv, H, scale, s);
      case 160:
        return (int)launch_wg<160>(q, k, v, o, B, Sq, Skv, H, scale, s);
      case 512:
        return (int)launch_wgmma<Smem512>(flash_fwd_wgmma512, k512Threads, 512, k512BM, k512BN,
                                          q, k, v, o, B, Sq, Skv, H, scale, s);
      default:
        return (int)launch_fma_any<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, D, scale, s);
    }
  }
  if (dtype == 0) return (int)launch_fma_any<float>(q, k, v, o, B, Sq, Skv, H, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* fa_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
