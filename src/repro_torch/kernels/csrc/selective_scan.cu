// Mamba's selective scan, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the scan with XLA, as
// `jax.lax.associative_scan` over decay and input tensors of shape
// [B, S, d_inner, d_state] (src/repro/models/ssm.py, mamba_apply_train).
// The port ran it as torch ops, one `addcmul` launch a step; this kernel
// runs the whole scan of a layer in one launch. For each (row b, channel d)
// and state n,
//
//     h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * B_t[n]) * u_t
//     y_t    = sum_n h_t[n] * C_t[n]
//
// with u [B, S, di] (float32 or bfloat16), dt [B, S, di], A [di, DS],
// B and C [B, S, DS], h0 [B, di, DS], all float32 but u. The decay and the
// input are made in registers, so nothing of size [B, S, di, DS] is written.
//
// Bound: the forward reads u, dt, B and C once and writes y once (about
// 2.7 GB at Jamba's served 2 x 8192 x 16384 in bf16) and issues DS
// exponentials a (token, channel) on the MUFU; at DS = 16 the two bounds
// are close. The serial dependency over S is what the design works around:
//   * one thread a (row, channel), its DS states in registers, so the
//     parallelism is B x di threads and each thread runs DS independent
//     chains (instruction-level parallelism inside the step);
//   * B_t and C_t of a chunk of kChunk steps are shared by the block's
//     channels: staged in shared memory, double-buffered, one barrier a
//     chunk; dt and u of the next chunk are loaded into registers while the
//     current chunk runs, so the loads' latency hides behind the arithmetic.
//
// The backward starts from checkpoints of h that the forward saves every
// kChunk steps when asked ([B, nchunks, di, DS]). For each chunk, last to
// first, it recomputes the chunk's states into shared memory with the
// forward's arithmetic, then walks back through it:
//
//     g_t    = C_t * dy_t + exp(dt_{t+1} A) * g_{t+1}      (dL/dh_t)
//     du_t   = sum_n g_t dt_t B_t
//     ddt_t  = sum_n g_t (B_t u_t + h_{t-1} exp(dt_t A) A)
//     dA    += g_t h_{t-1} exp(dt_t A) dt_t               (over b and t)
//     dB_t  += g_t dt_t u_t,  dC_t += h_t dy_t            (over channels)
//
// dB and dC are sums over channels: each warp reduces its 32 channels' 2 DS
// values with a butterfly that leaves one sum a lane (31 shuffles at DS 16),
// the block's two warps are added in shared memory, and each block writes a
// partial [nblocks, B, S, 2 DS] that the wrapper sums. dA's partials are
// per row [B, di, DS]. No atomics: the result does not depend on the order
// in which blocks run.
//
// Plain C interface (loaded with ctypes); each launcher returns the
// cudaError_t of the launch as an int and never synchronises. expf (not
// __expf) keeps the products within the float32 route's 1e-4 over 8192
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 128;  // channels a forward block
constexpr int kBwdThreads = 64;   // channels a backward block (two warps)
constexpr int kChunk = 16;        // steps a chunk = the checkpoint interval

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum over the warp of v[i] for i = lane * N / 32 (so, at N = 32, lane l
// holds the warp's sum of v[l]). Each round keeps half of the values and
// adds the partner's other half; N <= 32.
template <int N, int OFF>
struct ReduceScatter {
  __device__ __forceinline__ static float run(float* v, int lane) {
    if constexpr (N == 1) {
      float x = v[0];
#pragma unroll
      for (int o = OFF; o >= 1; o >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, o);
      }
      return x;
    } else {
      constexpr int kH = N / 2;
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float send = upper ? v[i] : v[i + kH];
        const float keep = upper ? v[i + kH] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      return ReduceScatter<kH, OFF / 2>::run(v, lane);
    }
  }
};

// ---- forward ---------------------------------------------------------------

template <int DS, typename T>
__global__ void __launch_bounds__(kFwdThreads)
    scan_fwd(const T* __restrict__ u, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ h_last,
             float* __restrict__ ck, int S, int di) {
  constexpr int kBC = kChunk * 2 * DS;  // B and C of a chunk
  constexpr int kBCPer = (kBC + kFwdThreads - 1) / kFwdThreads;
  __shared__ float sBC[2][kChunk][2 * DS];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool live = d < di;
  const int dd = live ? d : 0;  // dead lanes load channel 0, store nothing
  const long long row = (long long)b * S;
  const int nchunks = (S + kChunk - 1) / kChunk;

  float a[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = A[(long long)dd * DS + n];
    h[n] = h0[((long long)b * di + dd) * DS + n];
  }

  // chunk c's dt, u into registers and its B, C (this thread's share)
  auto load_steps = [&](int c, float* dtv, float* uv) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = c * kChunk + j;
      const long long at = (row + (t < S ? t : 0)) * di + dd;
      dtv[j] = t < S ? dt[at] : 0.f;
      uv[j] = t < S ? to_float(u[at]) : 0.f;
    }
  };
  auto load_bc = [&](int c, float* bc) {
#pragma unroll
    for (int i = 0; i < kBCPer; ++i) {
      const int e = threadIdx.x + i * kFwdThreads;
      const int j = e / (2 * DS), k = e % (2 * DS);
      const int t = c * kChunk + j;
      float v = 0.f;
      if (e < kBC && t < S) {
        v = k < DS ? Bm[(row + t) * DS + k] : Cm[(row + t) * DS + k - DS];
      }
      bc[i] = v;
    }
  };

  float dtc[kChunk], uc[kChunk], bc[kBCPer];
  load_steps(0, dtc, uc);
  load_bc(0, bc);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
#pragma unroll
    for (int i = 0; i < kBCPer; ++i) {
      const int e = threadIdx.x + i * kFwdThreads;
      if (e < kBC) sBC[buf][e / (2 * DS)][e % (2 * DS)] = bc[i];
    }
    // sBC[buf] is written; every thread is past chunk c - 2, its last reader
    __syncthreads();
    float dtn[kChunk], un[kChunk];
    if (c + 1 < nchunks) {
      load_steps(c + 1, dtn, un);
      load_bc(c + 1, bc);
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) dtn[j] = un[j] = 0.f;
    }
    if (ck != nullptr && live) {
      float* out = ck + (((long long)b * nchunks + c) * di + d) * DS;
#pragma unroll
      for (int n = 0; n < DS; ++n) out[n] = h[n];
    }
    const int len = min(kChunk, S - c * kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < len) {
        const float dtv = dtc[j], uv = uc[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          const float decay = expf(dtv * a[n]);
          const float bu = (dtv * sBC[buf][j][n]) * uv;
          h[n] = fmaf(decay, h[n], bu);
          acc = fmaf(h[n], sBC[buf][j][DS + n], acc);
        }
        if (live) y[(row + c * kChunk + j) * di + d] = acc;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      dtc[j] = dtn[j];
      uc[j] = un[j];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) {
      h_last[((long long)b * di + d) * DS + n] = h[n];
    }
  }
}

// ---- backward --------------------------------------------------------------

template <int DS>
constexpr size_t bwd_smem_bytes() {
  // the chunk's states, the two warps' channel sums, the chunk's B and C
  return sizeof(float) * (kChunk * DS * kBwdThreads + kChunk * 2 * 2 * DS +
                          kChunk * 2 * DS);
}

template <int DS, typename T>
__global__ void __launch_bounds__(kBwdThreads)
    scan_bwd(const T* __restrict__ u, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ ck,
             const float* __restrict__ dy, const float* __restrict__ dh_last,
             float* __restrict__ du, float* __restrict__ ddt,
             float* __restrict__ dA_part, float* __restrict__ dbc_part,
             float* __restrict__ dh0, int batch, int S, int di) {
  constexpr int kV = 2 * DS;          // dB then dC, per step
  constexpr int kSpread = 32 / kV;    // lanes that hold one warp sum
  extern __shared__ float smem[];
  float* states = smem;                             // [kChunk][DS][threads]
  float* red = states + kChunk * DS * kBwdThreads;  // [kChunk][2][kV]
  float* sBC = red + kChunk * 2 * kV;               // [kChunk][kV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kBwdThreads + tid;
  const bool live = d < di;
  const int dd = live ? d : 0;
  const long long row = (long long)b * S;
  const int nchunks = (S + kChunk - 1) / kChunk;

  float a[DS], gcar[DS], dA[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = A[(long long)dd * DS + n];
    const float g0 = dh_last != nullptr
                         ? dh_last[((long long)b * di + dd) * DS + n]
                         : 0.f;
    gcar[n] = live ? g0 : 0.f;  // exp(dt_{t+1} A) g_{t+1}; dL/dh_{S-1} first
    dA[n] = 0.f;
  }

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int len = min(kChunk, S - t0);
    __syncthreads();  // the last chunk's readers of sBC and red are done
    for (int e = tid; e < kChunk * kV; e += kBwdThreads) {
      const int j = e / kV, k = e % kV;
      float v = 0.f;
      if (j < len) {
        v = k < DS ? Bm[(row + t0 + j) * DS + k]
                   : Cm[(row + t0 + j) * DS + k - DS];
      }
      sBC[e] = v;
    }
    float hprev0[DS], dtr[kChunk], ur[kChunk], dyr[kChunk];
#pragma unroll
    for (int n = 0; n < DS; ++n) {
      hprev0[n] = ck[(((long long)b * nchunks + c) * di + dd) * DS + n];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const long long at = (row + t0 + (j < len ? j : 0)) * di + dd;
      dtr[j] = j < len ? dt[at] : 0.f;
      ur[j] = j < len ? to_float(u[at]) : 0.f;
      dyr[j] = j < len && live ? dy[at] : 0.f;
    }
    __syncthreads();

    // the chunk's states h_{t0} .. h_{t0+len-1}, as the forward made them
    {
      float h[DS];
#pragma unroll
      for (int n = 0; n < DS; ++n) h[n] = hprev0[n];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < len) {
#pragma unroll
          for (int n = 0; n < DS; ++n) {
            const float decay = expf(dtr[j] * a[n]);
            const float bu = (dtr[j] * sBC[j * kV + n]) * ur[j];
            h[n] = fmaf(decay, h[n], bu);
            states[(j * DS + n) * kBwdThreads + tid] = h[n];
          }
        }
      }
    }

#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j < len) {
        const float dtv = dtr[j], uv = ur[j], dyv = dyr[j];
        float v[kV];
        float du_acc = 0.f, ddt_acc = 0.f;
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          const float hp =
              j > 0 ? states[((j - 1) * DS + n) * kBwdThreads + tid]
                    : hprev0[n];
          const float ht = states[(j * DS + n) * kBwdThreads + tid];
          const float bn = sBC[j * kV + n];
          const float decay = expf(dtv * a[n]);
          const float g = fmaf(sBC[j * kV + DS + n], dyv, gcar[n]);
          const float gdt = g * dtv;
          v[n] = gdt * uv;                    // dB_t[n], this channel's share
          v[DS + n] = ht * dyv;               // dC_t[n]
          du_acc = fmaf(gdt, bn, du_acc);
          const float gd = g * hp * decay;    // dL/d(dt_t A[d, n])
          ddt_acc = fmaf(g * bn, uv, ddt_acc);
          ddt_acc = fmaf(gd, a[n], ddt_acc);
          dA[n] = fmaf(gd, dtv, dA[n]);
          gcar[n] = decay * g;
        }
        if (live) {
          const long long at = (row + t0 + j) * di + d;
          du[at] = du_acc;
          ddt[at] = ddt_acc;
        }
        const float s = ReduceScatter<kV, 16>::run(v, lane);
        if (lane % kSpread == 0) red[(j * 2 + warp) * kV + lane / kSpread] = s;
      }
    }
    __syncthreads();
    for (int e = tid; e < len * kV; e += kBwdThreads) {
      const int j = e / kV, k = e % kV;
      dbc_part[(((long long)blockIdx.x * batch + b) * S + t0 + j) * kV + k] =
          red[(j * 2) * kV + k] + red[(j * 2 + 1) * kV + k];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) {
      const long long at = ((long long)b * di + d) * DS + n;
      dA_part[at] = dA[n];
      dh0[at] = gcar[n];  // exp(dt_0 A) g_0 = dL/dh_{-1}
    }
  }
}

template <int DS, typename T>
int launch_fwd(const void* u, const float* dt, const float* A,
               const float* Bm, const float* Cm, const float* h0, float* y,
               float* h_last, float* ck, int batch, int S, int di,
               cudaStream_t stream) {
  dim3 grid((di + kFwdThreads - 1) / kFwdThreads, batch);
  scan_fwd<DS, T><<<grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(u), dt, A, Bm, Cm, h0, y, h_last, ck, S, di);
  return static_cast<int>(cudaGetLastError());
}

template <int DS, typename T>
int launch_bwd(const void* u, const float* dt, const float* A,
               const float* Bm, const float* Cm, const float* ck,
               const float* dy, const float* dh_last, float* du, float* ddt,
               float* dA_part, float* dbc_part, float* dh0, int batch, int S,
               int di, cudaStream_t stream) {
  constexpr size_t kSmem = bwd_smem_bytes<DS>();
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd<DS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((di + kBwdThreads - 1) / kBwdThreads, batch);
  scan_bwd<DS, T><<<grid, kBwdThreads, kSmem, stream>>>(
      static_cast<const T*>(u), dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
      dA_part, dbc_part, dh0, batch, S, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_by_state(int ds, const void* u, const float* dt, const float* A,
                 const float* Bm, const float* Cm, const float* h0, float* y,
                 float* h_last, float* ck, int batch, int S, int di,
                 cudaStream_t stream) {
  switch (ds) {
    case 4:
      return launch_fwd<4, T>(u, dt, A, Bm, Cm, h0, y, h_last, ck, batch, S,
                              di, stream);
    case 16:
      return launch_fwd<16, T>(u, dt, A, Bm, Cm, h0, y, h_last, ck, batch, S,
                               di, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_by_state(int ds, const void* u, const float* dt, const float* A,
                 const float* Bm, const float* Cm, const float* ck,
                 const float* dy, const float* dh_last, float* du, float* ddt,
                 float* dA_part, float* dbc_part, float* dh0, int batch,
                 int S, int di, cudaStream_t stream) {
  switch (ds) {
    case 4:
      return launch_bwd<4, T>(u, dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
                              dA_part, dbc_part, dh0, batch, S, di, stream);
    case 16:
      return launch_bwd<16, T>(u, dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
                               dA_part, dbc_part, dh0, batch, S, di, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// u_dtype: 0 = float32, 1 = bfloat16; ds 4 or 16 (the d_state of the
// repo's configs: Jamba's 16, its smoke config's 4). ck may be NULL (no
// checkpoints).
extern "C" int repro_selective_scan_fwd(
    const void* u, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* h0, float* y, float* h_last, float* ck,
    int batch, int S, int di, int ds, int u_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_dtype == 0) {
    return fwd_by_state<float>(ds, u, dt, A, Bm, Cm, h0, y, h_last, ck,
                               batch, S, di, s);
  }
  return fwd_by_state<__nv_bfloat16>(ds, u, dt, A, Bm, Cm, h0, y, h_last, ck,
                                     batch, S, di, s);
}

// dh_last may be NULL (no gradient on the last state). dbc_part is
// [ceil(di / 64), batch, S, 2 ds], dA_part [batch, di, ds].
extern "C" int repro_selective_scan_bwd(
    const void* u, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* ck, const float* dy, const float* dh_last,
    float* du, float* ddt, float* dA_part, float* dbc_part, float* dh0,
    int batch, int S, int di, int ds, int u_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_dtype == 0) {
    return bwd_by_state<float>(ds, u, dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
                               dA_part, dbc_part, dh0, batch, S, di, s);
  }
  return bwd_by_state<__nv_bfloat16>(ds, u, dt, A, Bm, Cm, ck, dy, dh_last,
                                     du, ddt, dA_part, dbc_part, dh0, batch,
                                     S, di, s);
}
