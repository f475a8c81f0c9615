// GroupNorm (+ fused SiLU) over channel-last rows [B, N, C] for Hopper.
//
// Replaces the Pallas TPU kernel `_gn_kernel` / `_fused_group_norm`
// (chiaswarm_tpu/ops/group_norm.py). Same numerics: f32 sums of x and x^2
// per group, fast variance var = E[x^2] - mean^2, rstd = rsqrt(var + eps),
// y = x * (gamma * rstd) + (beta - mean * gamma * rstd), optionally
// y * sigmoid(y), cast to the input type.
//
// What bounds it on an H100: bytes. Each element is read and written once
// (the least traffic), against 3.35 TB/s; the flops are a few per element.
// The TPU kernel held a whole batch row in VMEM and took only rows under a
// 6 MiB budget; a CTA has at most 227 KB, and SDXL's VAE rows reach
// 1024*1024*128 elements, so the work is split three ways:
//   1. gn_stats: CTAs split the N rows of each batch row into chunks. Each
//      thread owns 8 consecutive channels (one 16-byte bf16 load) and walks
//      its rows, keeping 8 sums and 8 sums of squares in registers; short
//      per-thread runs keep the f32 partials small. The CTA folds them into
//      per-group partials through shared memory in a fixed order.
//   2. gn_finalize: one thread per (batch, group) adds the chunk partials
//      in double and writes mean and rstd, so E[x^2] - mean^2 does not
//      cancel over the 10^8 terms of a full VAE row.
//   3. gn_apply: the same thread layout reads x again, applies the
//      per-channel scale and shift (and SiLU) and writes y.
// That is two reads and one write of x (the stats pass cannot see the
// future), so the kernel runs at best at 2/3 of the one-read bound. Group
// widths need not divide 8 (320 / 32 = 10): a thread's 8 channels may span
// two groups, and each channel looks up its own group.
//
// C interface (bound with ctypes): gn_forward returns cudaGetLastError()
// after the last launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float param_f32(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float param_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// blockDim.x = rows_par * (C / 8); thread (rp, v) owns channels v*8..v*8+7
// and rows n0 + rp, n0 + rp + rows_par, ... of its chunk.
template <typename T>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ partial, int N, int C,
                         int G, int rows_per_chunk, int rows_par) {
  extern __shared__ float sh[];  // [rows_par][C][2]
  const int chunks = gridDim.x;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int V = C / 8;
  const int rp = threadIdx.x / V;
  const int v = threadIdx.x % V;
  const int n0 = chunk * rows_per_chunk;
  const int n1 = min(N, n0 + rows_per_chunk);
  const T* xb = x + (size_t)b * N * C + v * 8;

  float s[8], ss[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = ss[i] = 0.f;
  for (int n = n0 + rp; n < n1; n += rows_par) {
    float f[8];
    load8(xb + (size_t)n * C, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] += f[i];
      ss[i] = fmaf(f[i], f[i], ss[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sh[(rp * C + v * 8 + i) * 2] = s[i];
    sh[(rp * C + v * 8 + i) * 2 + 1] = ss[i];
  }
  __syncthreads();
  const int cg = C / G;
  for (int grp = threadIdx.x; grp < G; grp += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < rows_par; ++r) {
      for (int c = grp * cg; c < (grp + 1) * cg; ++c) {
        a += sh[(r * C + c) * 2];
        q += sh[(r * C + c) * 2 + 1];
      }
    }
    float* out = partial + (((size_t)b * chunks + chunk) * G + grp) * 2;
    out[0] = a;
    out[1] = q;
  }
}

__global__ void gn_finalize(const float* __restrict__ partial, float* __restrict__ stats,
                            int chunks, int G, long long count, float eps) {
  const int b = blockIdx.x;
  for (int grp = threadIdx.x; grp < G; grp += blockDim.x) {
    double a = 0.0, q = 0.0;
    for (int ch = 0; ch < chunks; ++ch) {
      const float* p = partial + (((size_t)b * chunks + ch) * G + grp) * 2;
      a += p[0];
      q += p[1];
    }
    const double mean = a / (double)count;
    const double var = q / (double)count - mean * mean;
    stats[((size_t)b * G + grp) * 2] = (float)mean;
    stats[((size_t)b * G + grp) * 2 + 1] = rsqrtf((float)var + eps);
  }
}

template <typename T, bool SILU>
__global__ void gn_apply(const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ gamma,
                         const T* __restrict__ beta, const float* __restrict__ stats, int N,
                         int C, int G, int rows_per_chunk, int rows_par) {
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int V = C / 8;
  const int rp = threadIdx.x / V;
  const int v = threadIdx.x % V;
  const int cg = C / G;
  float sc[8], sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = v * 8 + i;
    const int grp = c / cg;
    const float mean = stats[((size_t)b * G + grp) * 2];
    const float rstd = stats[((size_t)b * G + grp) * 2 + 1];
    sc[i] = param_f32(gamma, c) * rstd;
    sh[i] = param_f32(beta, c) - mean * sc[i];
  }
  const int n0 = chunk * rows_per_chunk;
  const int n1 = min(N, n0 + rows_per_chunk);
  const size_t base = (size_t)b * N * C + v * 8;
  for (int n = n0 + rp; n < n1; n += rows_par) {
    float f[8];
    load8(x + base + (size_t)n * C, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float val = fmaf(f[i], sc[i], sh[i]);
      if (SILU) val = val / (1.f + expf(-val));
      f[i] = val;
    }
    store8(y + base + (size_t)n * C, f);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* gamma, const void* beta, float* partial,
                   float* stats, int B, int N, int C, int G, int chunks, float eps, int silu,
                   cudaStream_t stream) {
  const int V = C / 8;
  const int rows_par = V >= 256 ? 1 : 256 / V;
  const int threads = rows_par * V;
  const int rows_per_chunk = (N + chunks - 1) / chunks;
  dim3 grid(chunks, B);
  const size_t smem = sizeof(float) * 2 * (size_t)rows_par * C;
  gn_stats<T><<<grid, threads, smem, stream>>>(static_cast<const T*>(x), partial, N, C, G,
                                               rows_per_chunk, rows_par);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize<<<B, G < 1024 ? G : 1024, 0, stream>>>(partial, stats, chunks, G,
                                                     (long long)N * (C / G), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (silu)
    gn_apply<T, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(gamma),
        static_cast<const T*>(beta), stats, N, C, G, rows_per_chunk, rows_par);
  else
    gn_apply<T, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(gamma),
        static_cast<const T*>(beta), stats, N, C, G, rows_per_chunk, rows_par);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads per CTA for width C (the Python wrapper sizes chunks with it).
int gn_threads(int C) {
  const int V = C / 8;
  return (V >= 256 ? 1 : 256 / V) * V;
}

// dtype: 0 = float32, 1 = bfloat16, of x, y, gamma and beta alike. x, y:
// contiguous [B, N, C] with C % 8 == 0, C <= 4096 and C % G == 0; gamma,
// beta: [C].
// partial: f32 scratch of B * chunks * G * 2; stats: f32 scratch of B * G * 2.
int gn_forward(const void* x, void* y, const void* gamma, const void* beta, void* partial,
               void* stats, int B, int N, int C, int G, int chunks, float eps, int silu,
               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 || C / 8 > 512 || G < 1 || C % G || N < 1 || chunks < 1)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)launch<float>(x, y, gamma, beta, p, st, B, N, C, G, chunks, eps, silu, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, y, gamma, beta, p, st, B, N, C, G, chunks, eps, silu,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* gn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
