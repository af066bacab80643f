// Fused gossip-combine + SGD update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `mixing_sgd_combine` (body `_combine_kernel`) of
// src/repro/kernels/mixing_combine.py: the streaming pass that closes every
// D-PSGD iteration, eq. (2) of the paper,
//
//     out = W_ii * x + sum_{r<R} W_{i,j_r} * nbr_r - lr * g
//
// with float32 accumulation and one rounding to the type of x. A launch
// without g (g_dtype REPRO_DTYPE_NONE) computes the mix alone,
//
//     out = W_ii * x + sum_{r<R} W_{i,j_r} * nbr_r,
//
// from an instantiation that loads no g at all: the launcher's gossip step
// mixes parameters that its optimizer has already updated.
//
// Bound: bytes moved. Every element costs 2(R+1)+1 flops against
// (R+3) element reads/writes, far under the card's flops-per-byte ridge,
// so the only lever is to move each byte once. The design does three
// things about that:
//   * one pass: x, the R neighbour rows and g are read and out is written
//     without any intermediate in device memory;
//   * 16-byte loads and stores (4 float / 8 bf16 per thread, neighbouring
//     threads on neighbouring addresses) whenever every row start is
//     16-byte aligned; otherwise a scalar loop inside the same kernel
//     (odd N, offset views), never a different code path on the host;
//   * the agent index is the fastest-varying part of the block index, so
//     the blocks that work on the same column range of different agents
//     run at the same time and the R extra reads of a neighbour's row in
//     the stacked form are served by the L2 cache rather than by HBM.
//
// One device function serves both entry points. A "row" is one agent:
//   per-agent entry : rows = 1, neighbour r is recv + r*N        (idx null)
//   stacked entry   : rows = A, neighbour r is x + idx[a,r]*N    (nbr = x)
// Offsets are 64-bit: the stacked embedding leaf of an 8-agent run holds
// more than 2^30 elements.
//
// Plain C interface (loaded with ctypes); the launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;  // grid cap: a few waves of resident blocks

// ---- 16-byte packs --------------------------------------------------------

template <typename T>
struct Pack;  // kN elements of T fill 16 bytes

template <>
struct Pack<float> {
  static constexpr int kN = 4;
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Load V consecutive elements starting at p (16-byte aligned) as floats.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  static_assert(V % 4 == 0, "float packs are float4");
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const float4 t = reinterpret_cast<const float4*>(p)[k];
    v[4 * k + 0] = t.x;
    v[4 * k + 1] = t.y;
    v[4 * k + 2] = t.z;
    v[4 * k + 3] = t.w;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[V]) {
  static_assert(V % 8 == 0, "bf16 packs are 8 wide");
#pragma unroll
  for (int k = 0; k < V / 8; ++k) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[k];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * k + 2 * j + 0] = f.x;
      v[8 * k + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---- the kernel -----------------------------------------------------------

// T: type of x / neighbours / out.  G: type of g (float or T).
// HAS_G: the -lr*g term is loaded and added; false for the pure mix, whose
// g is null and never read.
// VECTOR: every row start is 16-byte aligned, so [0, n_vec*kN) of each row
// goes through 16-byte packs; the rest of the row (all of it when VECTOR is
// false) goes through the scalar loop.
//
// Block b works on row (b % rows) and is the (b / rows)-th of
// (gridDim.x / rows) blocks that stride over that row.
//
// Dynamic shared memory: (r+1) floats of weights, then r 64-bit element
// offsets of the neighbour rows (8-byte aligned: r+1 floats are padded up).
template <typename T, typename G, bool HAS_G, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ x, const T* __restrict__ nbr,
               const int* __restrict__ idx,
               const float* __restrict__ weights, const G* __restrict__ g,
               T* __restrict__ out, long long rows, long long n, int r,
               float lr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sw = reinterpret_cast<float*>(smem);
  const int w_slots = (r + 2) & ~1;  // r+1 rounded up to even
  long long* soff = reinterpret_cast<long long*>(sw + w_slots);

  const long long row = static_cast<long long>(blockIdx.x) % rows;
  const long long lane_block = static_cast<long long>(blockIdx.x) / rows;
  const long long blocks_per_row = static_cast<long long>(gridDim.x) / rows;

  for (int k = threadIdx.x; k <= r; k += blockDim.x) {
    sw[k] = weights[row * (r + 1) + k];
  }
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    const long long src =
        idx != nullptr ? static_cast<long long>(idx[row * r + k]) : k;
    soff[k] = src * n;
  }
  __syncthreads();

  const T* xs = x + row * n;
  const G* gs = HAS_G ? g + row * n : nullptr;
  T* os = out + row * n;
  const float w_self = sw[0];

  const long long tid = lane_block * blockDim.x + threadIdx.x;
  const long long stride = blocks_per_row * blockDim.x;

  constexpr int kN = Pack<T>::kN;
  const long long n_vec = VECTOR ? n / kN : 0;

  for (long long i = tid; i < n_vec; i += stride) {
    const long long e = i * kN;
    float acc[kN];
    float v[kN];
    load_vec<kN>(xs + e, v);
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] = w_self * v[k];
#pragma unroll 4
    for (int q = 0; q < r; ++q) {
      const float wq = sw[q + 1];
      load_vec<kN>(nbr + soff[q] + e, v);
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[k] = fmaf(wq, v[k], acc[k]);
    }
    if constexpr (HAS_G) {
      load_vec<kN>(gs + e, v);
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[k] = fmaf(-lr, v[k], acc[k]);
    }
    store_vec(os + e, acc);
  }

  for (long long e = n_vec * kN + tid; e < n; e += stride) {
    float acc = w_self * to_float(xs[e]);
    for (int q = 0; q < r; ++q) {
      acc = fmaf(sw[q + 1], to_float(nbr[soff[q] + e]), acc);
    }
    if constexpr (HAS_G) acc = fmaf(-lr, to_float(gs[e]), acc);
    os[e] = from_float<T>(acc);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int sm_count() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    int sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
    cached = sms;
  }
  return cached;
}

template <typename T, typename G, bool HAS_G>
int launch(const void* x, const void* nbr, const int* idx,
           const float* weights, const void* g, void* out, long long rows,
           long long n, int r, float lr, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kN = Pack<T>::kN;
  // Row starts stay aligned when N is a multiple of the pack width, or when
  // only one row is touched at all (one agent, no neighbours).
  const bool rows_aligned = (n % kN == 0) || (rows == 1 && r == 0);
  const bool vec = rows_aligned && aligned16(x) && aligned16(nbr) &&
                   aligned16(g) && aligned16(out);

  const long long work = vec ? (n + kN - 1) / kN : n;
  long long per_row = (work + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm / rows;
  if (cap < 1) cap = 1;
  if (per_row > cap) per_row = cap;
  const long long total = per_row * rows;
  if (total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);

  const int w_slots = (r + 2) & ~1;
  const size_t smem = sizeof(float) * w_slots + sizeof(long long) * r;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);

  const dim3 grid(static_cast<unsigned int>(total));
  const dim3 block(kThreads);
  const T* xp = static_cast<const T*>(x);
  const T* np = static_cast<const T*>(nbr);
  const G* gp = static_cast<const G*>(g);
  T* op = static_cast<T*>(out);
  if (vec) {
    combine_kernel<T, G, HAS_G, true><<<grid, block, smem, stream>>>(
        xp, np, idx, weights, gp, op, rows, n, r, lr);
  } else {
    combine_kernel<T, G, HAS_G, false><<<grid, block, smem, stream>>>(
        xp, np, idx, weights, gp, op, rows, n, r, lr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes shared with the Python wrapper.
#define REPRO_DTYPE_F32 0
#define REPRO_DTYPE_BF16 1
#define REPRO_DTYPE_NONE -1  // g_dtype of a launch without g (g is null)

// out[a] = w[a,0]*x[a] + sum_r w[a,r+1]*src(a,r) - lr*g[a],  a < rows, where
// src(a,r) = nbr + idx[a*r_count + r]*n   if idx != NULL (stacked form), or
//          = nbr + r*n                    if idx == NULL (per-agent form).
// x, nbr, out have type x_dtype; g has type g_dtype (float32, or x_dtype),
// or is null with g_dtype REPRO_DTYPE_NONE, and then the -lr*g[a] term is
// absent (lr unused). weights is float32 [rows, r+1]. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int repro_mixing_sgd_combine(
    const void* x, const void* nbr, const int* idx, const float* weights,
    const void* g, void* out, long long rows, long long n, int r, float lr,
    int x_dtype, int g_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((g == nullptr) != (g_dtype == REPRO_DTYPE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_dtype == REPRO_DTYPE_F32 && g_dtype == REPRO_DTYPE_F32) {
    return launch<float, float, true>(x, nbr, idx, weights, g, out, rows, n,
                                      r, lr, s);
  }
  if (x_dtype == REPRO_DTYPE_BF16 && g_dtype == REPRO_DTYPE_BF16) {
    return launch<__nv_bfloat16, __nv_bfloat16, true>(
        x, nbr, idx, weights, g, out, rows, n, r, lr, s);
  }
  if (x_dtype == REPRO_DTYPE_BF16 && g_dtype == REPRO_DTYPE_F32) {
    return launch<__nv_bfloat16, float, true>(x, nbr, idx, weights, g, out,
                                              rows, n, r, lr, s);
  }
  if (x_dtype == REPRO_DTYPE_F32 && g_dtype == REPRO_DTYPE_NONE) {
    return launch<float, float, false>(x, nbr, idx, weights, nullptr, out,
                                       rows, n, r, 0.0f, s);
  }
  if (x_dtype == REPRO_DTYPE_BF16 && g_dtype == REPRO_DTYPE_NONE) {
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        x, nbr, idx, weights, nullptr, out, rows, n, r, 0.0f, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
