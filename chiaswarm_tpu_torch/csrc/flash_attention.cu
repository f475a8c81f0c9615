// Flash attention forward for Hopper (sm_90a), non-causal, [B, S, H, D].
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_impl`
// (chiaswarm_tpu/ops/flash_attention.py): softmax(q k^T * scale) v with an
// online softmax over KV tiles (running max m, running sum l, f32
// accumulator), so the [Sq, Skv] score matrix never reaches device memory.
// Scores stay in f32; KV columns past the true length are masked to -1e30
// (ragged cross-attention lengths such as 77); P is rounded to the input
// type before P.V, as in the TPU kernel; the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: operations. 4*B*H*Sq*Skv*D flops against
// 989 TFLOP/s of bf16 tensor cores, while q/k/v/o move only a few MB.
// What the design does about that:
//   - bf16 with D == 64 (every SDXL UNet attention): one CTA of 4 warps per
//     (b*h, 64 query rows); each warp owns 16 rows and runs QK^T and P.V on
//     the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//     Q fragments live in registers for the whole KV sweep, P is reused
//     from the score accumulators as the A operand without touching shared
//     memory, and V is stored transposed in shared memory so each B
//     fragment is one 32-bit load. Rows are padded by 8 elements so the
//     fragment loads are free of bank conflicts.
//   - every other case (f32 inputs, D == 512 for the VAE mid-block, other
//     head widths up to 512): an FMA kernel in plain f32, no TF32, so f32
//     meets the 2e-5 bound of the reference test; 16-byte loads fill the
//     tiles. It is right, not fast.
// Loads are synchronous (no cp.async/TMA pipeline yet): a later change can
// add a multi-stage pipeline and wgmma.
//
// C interface (bound with ctypes): fa_forward returns cudaGetLastError()
// after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------
// bf16 tensor-core kernel, D == 64 (static shared memory: 27 KB)
// ---------------------------------------------------------------------

constexpr int kMmaBQ = 64;   // query rows per CTA (4 warps x 16)
constexpr int kMmaBK = 64;   // KV rows per tile
constexpr int kPad = 8;      // bf16 elements of row padding

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o,
                   int Sq, int Skv, int H, float scale_log2) {
  constexpr int DS = D + kPad;        // sQ / sK row stride
  constexpr int KS = kMmaBK + kPad;   // sVt row stride
  constexpr int VEC = D / 8;          // 16-byte vectors per row
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = kMmaBK / 8;    // score n-tiles per warp
  constexpr int NT_O = D / 8;         // output n-tiles per warp

  __shared__ __align__(16) __nv_bfloat16 sQ[kMmaBQ * DS];
  __shared__ __align__(16) __nv_bfloat16 sK[kMmaBK * DS];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * KS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // group id: fragment row
  const int t = lane & 3;    // thread in group: fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kMmaBQ;
  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * H + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * H + h) * D;
  __nv_bfloat16* ob = o + ((size_t)b * Sq * H + h) * D;

  // Q tile -> shared (zeros past Sq), then into registers for the sweep
  for (int idx = tid; idx < kMmaBQ * VEC; idx += 128) {
    int r = idx / VEC, cv = idx % VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * row_stride + cv * 8);
    *reinterpret_cast<uint4*>(&sQ[r * DS + cv * 8]) = val;
  }
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  {
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16 + t * 2;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(&sQ[r0 * DS + c]);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(&sQ[(r0 + 8) * DS + c]);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(&sQ[r0 * DS + c + 8]);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(&sQ[(r0 + 8) * DS + c + 8]);
    }
  }

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max, rows g and g+8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;          // per-thread partial row sums

  for (int j0 = 0; j0 < Skv; j0 += kMmaBK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < kMmaBK * VEC; idx += 128) {
      int r = idx / VEC, cv = idx % VEC;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j0 + r < Skv) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(j0 + r) * row_stride + cv * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(j0 + r) * row_stride + cv * 8);
      }
      *reinterpret_cast<uint4*>(&sK[r * DS + cv * 8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(cv * 8 + e) * KS + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 KV columns
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &sK[(nt * 8 + g) * DS];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + t * 2);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8 + t * 2);
        mma_bf16_16816(s[nt], qa[ks], b0, b1);
      }
    }

    // scale (f32, log2 domain), mask the ragged KV edge, row maxima
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nt * 8 + t * 2 + (e & 1);
        float val = s[nt][e] * scale_log2;
        if (col >= Skv) val = kNegInf;
        s[nt][e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha1;
      acc[i][3] *= alpha1;
    }

    // O += P V: P comes straight from the score accumulators (bf16)
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const __nv_bfloat16* vrow = &sVt[(dt * 8 + g) * KS + kk * 16];
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow + t * 2);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8 + t * 2);
        mma_bf16_16816(acc[dt], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < NT_O; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * row_stride + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8) * row_stride + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------------
// FMA kernel: f32 math for any D <= DMAX (f32 inputs, and bf16 at D=512)
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

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int H, float scale, cudaStream_t stream) {
  dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, B * H);
  flash_fwd_bf16_mma<D><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, H,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous [B, S, H, D].
// Returns a cudaError_t (0 = success); 1 (cudaErrorInvalidValue) for a
// dtype/D the kernels do not take (the Python wrapper checks first).
int fa_forward(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
               int H, int D, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 512 || Sq < 1 || Skv < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 64) return (int)launch_mma<64>(q, k, v, o, B, Sq, Skv, H, scale, s);
    return (int)launch_fma_any<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, D, scale, s);
  }
  if (dtype == 0) return (int)launch_fma_any<float>(q, k, v, o, B, Sq, Skv, H, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* fa_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
