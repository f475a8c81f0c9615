// GroupNorm (+ fused SiLU) over channel-last rows [B, N, C] for Hopper, in
// one cooperative launch per call.
//
// Replaces the Pallas TPU kernel `_gn_kernel` / `_fused_group_norm`
// (chiaswarm_tpu/ops/group_norm.py). Same numerics: f32 sums of x and x^2
// per group, fast variance var = E[x^2] - mean^2, rstd = rsqrt(var + eps),
// y = x * (gamma * rstd) + (beta - mean * gamma * rstd), optionally
// y * sigmoid(y), cast to the input type.
//
// What bounds it on an H100: bytes. The least traffic is one read and one
// write of x, against 3.35 TB/s; the flops are a few per element. The TPU
// kernel gets there by holding a batch row in VMEM while it takes the
// statistics. A CTA has at most 227 KB of shared memory, but the card has
// 132 of them, about 30 MB, which holds most of SDXL's GroupNorm calls
// whole. So the call is one persistent kernel whose CTAs are all resident
// at once (a cooperative launch, with the grid sized by the occupancy
// query). Each batch row's N rows are cut into `chunks` slabs of
// `rows_per_cta` rows (the last one shorter), one slab per CTA:
//   A. Statistics. One thread issues TMA bulk copies of the first
//      `keep_rows` rows of the slab into shared memory, in up to 8 stages,
//      each with its own mbarrier; the threads sum each stage as it lands.
//      Each thread owns 8 consecutive channels (one 16-byte load) of every
//      rows_par-th row and keeps 8 f32 sums and sums of squares. Rows of the
//      slab past `keep_rows` (a call too large for the card's shared
//      memory) are read with 16-byte loads, four rows in flight. The CTA
//      folds its threads' sums into per-group partials through shared
//      memory in a fixed order (a thread's 8 channels may span two or more
//      groups: 320 / 32 = 10) and writes them to scratch.
//   Grid barrier: cooperative_groups' grid sync (CUDA 12.9 needs no
//   -rdc=true for it).
//   B. Finalize. Every CTA reduces its batch row's partials: lanes of a
//      warp stride over the row's CTAs in double, then add across the lanes
//      in a fixed butterfly. The order depends only on the plan, so every
//      CTA of a batch row gets bit-identical mean and rstd, and so does
//      every call. Double, because a VAE row of 1024^2 x 128 has 4e6 terms
//      per group and E[x^2] - mean^2 cancels.
//   C. Apply. Rows past `keep_rows` are read again, newest first, so that
//      the lines read last in phase A are still in the 50 MB L2; then the
//      kept rows come from shared memory. A call that fits reads x from
//      global memory once.
// Phases B and C wait on each other through the barrier, so the serial
// chain of one CTA (launch, first bytes, fold, barrier, finalize) is a
// fixed cost of a few microseconds that the small calls pay in full.
// The plan (chunks, rows per CTA, rows kept, shared memory) is worked out
// by ops/group_norm.py; gn_forward checks it against the layout here.
//
// C interface (bound with ctypes): every entry point returns a CUDA error
// code, 0 on success; gn_forward returns the cooperative launch's.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// A launch plan, filled in by ops/group_norm.py (`_PlanArgs`) field for field.
// (At namespace scope: gn_forward takes it, and an entry point whose
// signature names a type of an unnamed namespace is not exported.)
struct GnPlan {
  void* scratch;     // [B * chunks][G] float2 partials
  int B, N, C, G;
  int chunks;        // CTAs per batch row; the grid is B * chunks, every CTA resident
  int threads;       // threads_for(C)
  int rows_per_cta;  // slab height; a batch row's last slab may be shorter
  int keep_rows;     // rows of a slab held in shared memory
  int fold_slots;    // groups one thread's 8 channels can touch
  int smem_bytes;
  int dtype;         // 0 = float32, 1 = bfloat16
  int silu;
  float eps;
};

namespace {

constexpr int kMaxThreads = 512;
constexpr int kStages = 8;
constexpr int kBarBytes = kStages * 8;  // the stages' mbarriers, first in shared memory
constexpr int kMaxFoldSlots = 8;        // groups one thread's 8 channels can span

struct Params {
  const void* x;
  void* y;
  const void* gamma;
  const void* beta;
  float2* partial;
  int N, C, G, chunks, rows_per_cta, keep_rows, fold_slots, fold_off, slab_off;
  float eps;
};

inline int align_up(int v, int a) { return (v + a - 1) / a * a; }

// blockDim: rows_par * (C / 8), about kMaxThreads
inline int threads_for(int C) {
  const int V = C / 8;
  return (V >= kMaxThreads ? 1 : kMaxThreads / V) * V;
}

// shared memory: mbarriers | stats [G] float2 | fold | slab (keep_rows x C)
inline void smem_offsets(int threads, int G, int fold_slots, int* fold_off, int* slab_off) {
  *fold_off = align_up(kBarBytes + G * 8, 16);
  *slab_off = align_up(*fold_off + threads * fold_slots * 8, 128);
}

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

// `stream`: evict-first stores (__stcs), for a call that reads part of x
// twice, so that y does not push the lines to be read again out of L2
__device__ __forceinline__ void store8(float* p, const float (&f)[8], bool stream) {
  const float4 a = make_float4(f[0], f[1], f[2], f[3]);
  const float4 b = make_float4(f[4], f[5], f[6], f[7]);
  if (stream) {
    __stcs(reinterpret_cast<float4*>(p), a);
    __stcs(reinterpret_cast<float4*>(p + 4), b);
  } else {
    *reinterpret_cast<float4*>(p) = a;
    *reinterpret_cast<float4*>(p + 4) = b;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8], bool stream) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  if (stream)
    __stcs(reinterpret_cast<uint4*>(p), u);
  else
    *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float param_f32(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float param_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void accumulate(float (&s)[8], float (&ss)[8], const float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i] += f[i];
    ss[i] = fmaf(f[i], f[i], ss[i]);
  }
}

// SiLU with the SFU's exponential and reciprocal (a few ulp; the accurate
// expf and IEEE division made phase C compute-bound)
template <bool SILU>
__device__ __forceinline__ void apply8(float (&f)[8], const float (&sc)[8], const float (&sh)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float val = fmaf(f[i], sc[i], sh[i]);
    if (SILU) val = __fdividef(val, 1.f + __expf(-val));
    f[i] = val;
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kMaxThreads) gn_fused(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  float2* stats = reinterpret_cast<float2*>(smem + kBarBytes);
  float2* fold = reinterpret_cast<float2*>(smem + p.fold_off);
  T* slab = reinterpret_cast<T*>(smem + p.slab_off);

  const int C = p.C, G = p.G, V = C / 8, cg = C / G, fs = p.fold_slots;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rows_par = nthr / V, rp = tid / V, v = tid - rp * V;
  const int b = blockIdx.x / p.chunks;
  const int n0 = (blockIdx.x - b * p.chunks) * p.rows_per_cta;
  const int rows = min(p.N - n0, p.rows_per_cta);  // this slab
  const int keep = min(rows, p.keep_rows);         // slab rows 0..keep-1 in smem
  const int stage_rows = (keep + kStages - 1) / kStages;
  const int stages = keep > 0 ? (keep + stage_rows - 1) / stage_rows : 0;
  const bool rereads = p.keep_rows < p.rows_per_cta;  // the call reads part of x twice
  const size_t base = ((size_t)b * p.N + n0) * C;  // the slab's first element
  const T* __restrict__ xs = static_cast<const T*>(p.x) + base + v * 8;
  T* __restrict__ ys = static_cast<T*>(p.y) + base + v * 8;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&mbar[s], 1);
    hopper::mbar_fence_init();
    // a call that reads part of x twice lets the lines of the kept rows
    // leave L2 first, so that the rows to be read again stay
    const uint64_t policy = hopper::l2_evict_first_policy();
    for (int s = 0; s < stages; ++s) {
      const int first = s * stage_rows;
      const uint32_t bytes = (uint32_t)min(stage_rows, keep - first) * C * sizeof(T);
      const T* src = static_cast<const T*>(p.x) + base + (size_t)first * C;
      hopper::mbar_expect_tx(&mbar[s], bytes);
      if (rereads)
        hopper::bulk_load(slab + first * C, src, bytes, &mbar[s], policy);
      else
        hopper::bulk_load(slab + first * C, src, bytes, &mbar[s]);
    }
  }
  // this thread's channels v*8..v*8+7 run from group g0 on; the first
  // `span0` of them are in g0, then a new group every cg channels
  const int g0 = v * 8 / cg, span0 = (g0 + 1) * cg - v * 8;
  __syncthreads();

  // --- A: per-group partial sums of this slab ---
  float s[8], ss[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = ss[i] = 0.f;
  // rows past the kept ones, from global memory while the stages land
  int n = keep + rp;
  for (; n + 3 * rows_par < rows; n += 4 * rows_par) {
    float f[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) load8(xs + (size_t)(n + u * rows_par) * C, f[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) accumulate(s, ss, f[u]);
  }
  for (; n < rows; n += rows_par) {
    float f[8];
    load8(xs + (size_t)n * C, f);
    accumulate(s, ss, f);
  }
  // kept rows, from shared memory as their stages land
  for (int m = rp, stage = 0, landed_end = 0; m < keep; m += rows_par) {
    while (m >= landed_end) {
      hopper::mbar_wait(&mbar[stage++], 0);
      landed_end += stage_rows;
    }
    float f[8];
    load8(slab + m * C + v * 8, f);
    accumulate(s, ss, f);
  }
  // fold, 1: this thread's 8 channels into its group slots
  {
    float2 cur = make_float2(0.f, 0.f);
    int slot = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i == span0 + slot * cg) {  // channel v*8+i opens the next group
        fold[tid * fs + slot++] = cur;
        cur = make_float2(0.f, 0.f);
      }
      cur.x += s[i];
      cur.y += ss[i];
    }
    fold[tid * fs + slot] = cur;
  }
  __syncthreads();
  // fold, 2: over the rows_par threads that share a channel vector, as a
  // tree whose shape depends on rows_par alone (rows rp and rp + half
  // meet; an odd row out waits a round)
  for (int m = rows_par; m > 1;) {
    const int half = (m + 1) / 2;
    if (rp + half < m)
      for (int j = 0; j < fs; ++j) {
        const float2 o = fold[(tid + half * V) * fs + j];
        fold[tid * fs + j].x += o.x;
        fold[tid * fs + j].y += o.y;
      }
    m = half;
    __syncthreads();
  }
  // fold, 3: per group, over the channel vectors that hold it
  for (int g = tid; g < G; g += nthr) {
    float a = 0.f, q = 0.f;
    for (int w = g * cg / 8; w * 8 < (g + 1) * cg; ++w) {
      const float2 f = fold[w * fs + g - w * 8 / cg];
      a += f.x;
      q += f.y;
    }
    p.partial[(size_t)blockIdx.x * G + g] = make_float2(a, q);
  }
  // this thread's scale and bias, loaded before the barrier rather than after
  float sc[8], sh[8];
  {
    const T* __restrict__ gamma = static_cast<const T*>(p.gamma) + v * 8;
    const T* __restrict__ beta = static_cast<const T*>(p.beta) + v * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = param_f32(gamma, i);
      sh[i] = param_f32(beta, i);
    }
  }

  cooperative_groups::this_grid().sync();

  // --- B: mean and rstd of this batch row, from its CTAs' partials ---
  {
    // lanes per group: a power of two that divides 32
    int lanes = 1;
    while (lanes < 32 && 2 * lanes * G <= nthr) lanes *= 2;
    const int g = tid / lanes, j = tid - g * lanes;
    if ((tid & ~31) < G * lanes) {  // whole warps, so the shuffles see every lane
      double a = 0.0, q = 0.0;
      if (g < G) {
        const float2* part = p.partial + (size_t)b * p.chunks * G + g;
        // eight loads in flight before their sums (absent CTAs add zero)
        for (int c0 = j; c0 < p.chunks; c0 += 8 * lanes) {
          float2 f[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int c = c0 + k * lanes;
            f[k] = c < p.chunks ? __ldcg(part + (size_t)c * G) : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            a += f[k].x;
            q += f[k].y;
          }
        }
      }
      for (int off = lanes / 2; off > 0; off /= 2) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (j == 0 && g < G) {
        const double count = (double)p.N * cg;
        const double mean = a / count;
        const double var = q / count - mean * mean;
        stats[g] = make_float2((float)mean, rsqrtf((float)var + p.eps));
      }
    }
  }
  __syncthreads();

  // --- C: y, the re-read rows newest first, then the kept rows ---
  {
    int g = g0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i == span0 + (g - g0) * cg) ++g;
      const float2 ms = stats[g];
      sc[i] *= ms.y;
      sh[i] -= ms.x * sc[i];
    }
  }
  if (keep + rp < rows) {
    int m = keep + rp + (rows - 1 - keep - rp) / rows_par * rows_par;  // this thread's last row
    for (; m - 3 * rows_par >= keep + rp; m -= 4 * rows_par) {
      float f[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) load8(xs + (size_t)(m - u * rows_par) * C, f[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        apply8<SILU>(f[u], sc, sh);
        store8(ys + (size_t)(m - u * rows_par) * C, f[u], rereads);
      }
    }
    for (; m >= keep + rp; m -= rows_par) {
      float f[8];
      load8(xs + (size_t)m * C, f);
      apply8<SILU>(f, sc, sh);
      store8(ys + (size_t)m * C, f, rereads);
    }
  }
  // (waiting on a stage that has landed returns at once, and makes the
  // bytes the TMA wrote visible to this thread)
  for (int st = 0; st < stages; ++st) hopper::mbar_wait(&mbar[st], 0);
#pragma unroll 4
  for (int m = rp; m < keep; m += rows_par) {
    float f[8];
    load8(slab + m * C + v * 8, f);
    apply8<SILU>(f, sc, sh);
    store8(ys + (size_t)m * C, f, rereads);
  }
}

template <typename T, bool SILU>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&gn_fused<T, SILU>);
}

const void* kernel_for(int dtype, int silu) {
  if (dtype == 0) return silu ? kernel_ptr<float, true>() : kernel_ptr<float, false>();
  if (dtype == 1)
    return silu ? kernel_ptr<__nv_bfloat16, true>() : kernel_ptr<__nv_bfloat16, false>();
  return nullptr;
}

// the plan as ops/group_norm.py works it out: the thread layout, slabs that
// cover each batch row with no empty CTA, and the shared memory layout above
bool plan_ok(const GnPlan& p) {
  if (p.B < 1 || p.N < 1 || p.C < 8 || p.C % 8 || p.C / 8 > kMaxThreads || p.G < 1 || p.C % p.G)
    return false;
  if (p.threads != threads_for(p.C) || p.G > p.threads) return false;
  if (p.fold_slots < 1 || p.fold_slots > kMaxFoldSlots) return false;
  if (p.chunks < 1 || p.rows_per_cta < 1 || (long long)p.chunks * p.rows_per_cta < p.N ||
      (long long)(p.chunks - 1) * p.rows_per_cta >= p.N)
    return false;
  int fold_off, slab_off;
  smem_offsets(p.threads, p.G, p.fold_slots, &fold_off, &slab_off);
  const int elem = p.dtype == 0 ? 4 : 2;
  return p.keep_rows >= 0 && p.keep_rows <= p.rows_per_cta &&
         (long long)p.smem_bytes == slab_off + (long long)p.keep_rows * p.C * elem;
}

}  // namespace

extern "C" {

// The device's SM count and the most dynamic shared memory one CTA may use.
int gn_limits(int device, int* out) {
  cudaError_t err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// CTAs of the (dtype, silu) kernel resident per SM at `threads` threads and
// `smem_bytes` of dynamic shared memory, on the current device; first lets
// the kernel use up to `smem_limit` bytes (above the 48 KB default).
int gn_occupancy(int dtype, int silu, int threads, int smem_bytes, int smem_limit, int* blocks) {
  const void* k = kernel_for(dtype, silu);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads, smem_bytes);
}

// x, y: contiguous [B, N, C] of the plan's dtype; gamma, beta: [C]; every
// pointer 16-byte aligned. One cooperative launch of B * chunks CTAs on
// `stream`.
int gn_forward(const void* x, void* y, const void* gamma, const void* beta, const GnPlan* plan,
               void* stream) {
  const GnPlan& pl = *plan;
  const void* k = kernel_for(pl.dtype, pl.silu);
  if (k == nullptr || !plan_ok(pl)) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.y = y;
  p.gamma = gamma;
  p.beta = beta;
  p.partial = static_cast<float2*>(pl.scratch);
  p.N = pl.N;
  p.C = pl.C;
  p.G = pl.G;
  p.chunks = pl.chunks;
  p.rows_per_cta = pl.rows_per_cta;
  p.keep_rows = pl.keep_rows;
  p.fold_slots = pl.fold_slots;
  smem_offsets(pl.threads, pl.G, pl.fold_slots, &p.fold_off, &p.slab_off);
  p.eps = pl.eps;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(k, dim3(pl.B * pl.chunks), dim3(pl.threads), args,
                                          (size_t)pl.smem_bytes,
                                          static_cast<cudaStream_t>(stream));
}

const char* gn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
