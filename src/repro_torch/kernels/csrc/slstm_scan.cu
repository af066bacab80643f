// sLSTM's recurrence (xLSTM's scalar-memory block), forward and backward,
// for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package steps the cell with XLA's
// `jax.lax.scan` (src/repro/models/ssm.py, slstm_apply_train). The port
// ran it as ~22 torch ops a token; this kernel runs the whole time loop of
// a layer in one launch. For each row b and step t, with d = d_model,
//
//     pre  = pre_x[b, t] + round(round(h_{t-1}) @ R)        [4d] float32
//     z, i, f, o = tanh(pre_z), pre_i, logsigmoid(pre_f), sigmoid(pre_o)
//     m'   = max(f + m, i)
//     c'   = exp(f + m - m') c + exp(i - m') z
//     n'   = exp(f + m - m') n + exp(i - m')
//     h'   = o c' / max(n', exp(-m') + 1e-6)
//
// R [d, 4d] is in the compute dtype T (float32 or bfloat16), and round()
// rounds to T: the reference computes `(h.astype(T) @ R).astype(float32)`,
// so at bf16 the rounding is part of the function. The carry (c, n, h, m)
// is float32.
//
// Bound: neither bytes nor FLOPs. A step's product needs all of h_{t-1},
// so the S steps of a row run one after another. The design is the simple
// one: one block a row, h_{t-1} in shared memory, R streamed from L2 each
// step (4.7 MB in bf16 at d = 768; the 50 MB L2 holds it for every row),
// the whole loop inside one launch, two barriers a step. Each thread owns
// 8 consecutive columns of R, read as one 16-byte load a row k (two in
// float32), 8 rows in flight, so that enough bytes are on their way from
// L2 to hide its latency; the step's 4d pre-activations meet in shared
// memory, and each thread then updates two elements of the cell. A step's
// time is about R's bytes over one SM's share of the L2 bandwidth;
// spreading a row over a cluster of SMs is the way past it.
//
// The backward walks each row from the last step to the first, from the
// gate pre-activations and the (c, n, m) of every step that the forward
// saves when asked. Each step turns dL/dh_t (the output's gradient plus
// the recurrent one from step t + 1) into the four pre-activations'
// gradient dpre_t, with autograd's rule for `maximum` (a tie splits the
// gradient in halves), then the recurrent gradient for step t - 1:
// round(round(dpre_t) @ R^T), one warp a row of R, 8 columns a lane a
// 16-byte load. It returns dpre and the
// initial carry's gradient; dR = H_prev^T dpre is one matrix product in
// the wrapper.
//
// Plain C interface (loaded with ctypes); each launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // d <= 1024: 4d / 8 columns a thread
constexpr int kMaxPer = 2;        // elements a thread: threads >= d / 2
constexpr int kCols = 8;          // columns of R a thread loads at once

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// kCols consecutive values from 16-byte aligned global memory
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// autograd's rule for maximum(x, y): the larger takes the gradient, a tie
// gives each half
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

// Threads a block for d: one for each kCols columns of R's 4d, at least a
// warp, whole warps.
__host__ __device__ __forceinline__ int block_threads(int d) {
  const int groups = 4 * d / kCols;
  return groups <= 32 ? 32 : (groups + 31) / 32 * 32;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    slstm_fwd(const float* __restrict__ pre_x, const T* __restrict__ R,
              const float* __restrict__ carry0, float* __restrict__ hs,
              float* __restrict__ carry, float* __restrict__ pre_save,
              float* __restrict__ st_save, int batch, int S, int d) {
  extern __shared__ float smem[];
  float* sh = smem;          // round(h_{t-1}) [d]
  float* spre = smem + d;    // the step's pre-activations [4d]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long bd = (long long)batch * d;
  const int d4 = 4 * d;
  const int col0 = tid * kCols;  // this thread's columns of R
  const bool cols = col0 < d4;
  // carry0 / carry: [4][batch][d] as (c, n, h, m)
  float c[kMaxPer], n[kMaxPer], m[kMaxPer];
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int j = tid + e * nt;
    if (j < d) {
      const long long at = (long long)b * d + j;
      c[e] = carry0[at];
      n[e] = carry0[bd + at];
      sh[j] = round_to<T>(carry0[2 * bd + at]);
      m[e] = carry0[3 * bd + at];
    }
  }
  __syncthreads();
  for (int t = 0; t < S; ++t) {
    const long long step = (long long)b * S + t;
    if (cols) {
      float px[kCols], acc[kCols];
      load8(pre_x + step * d4 + col0, px);
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
      const T* rp = R + col0;
#pragma unroll 8
      for (int k = 0; k < d; ++k) {
        float r8[kCols];
        load8(rp + (long long)k * d4, r8);
        const float hk = sh[k];
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[i] = fmaf(hk, r8[i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const float pre = px[i] + round_to<T>(acc[i]);
        spre[col0 + i] = pre;
        if (pre_save != nullptr) pre_save[step * d4 + col0 + i] = pre;
      }
    }
    __syncthreads();  // spre is whole; every thread is done reading h_{t-1}
#pragma unroll
    for (int e = 0; e < kMaxPer; ++e) {
      const int j = tid + e * nt;
      if (j < d) {
        const float z = tanhf(spre[j]);
        const float o = sigmoid(spre[3 * d + j]);
        const float logf_ = log_sigmoid(spre[2 * d + j]);
        const float pi = spre[d + j];
        const float m_new = fmaxf(logf_ + m[e], pi);
        const float iw = expf(pi - m_new);
        const float fw = expf(logf_ + m[e] - m_new);
        c[e] = fw * c[e] + iw * z;
        n[e] = fw * n[e] + iw;
        m[e] = m_new;
        const float h = o * (c[e] / fmaxf(n[e], expf(-m_new) + 1e-6f));
        hs[step * d + j] = h;
        sh[j] = round_to<T>(h);
        if (st_save != nullptr) {
          const long long bsd = (long long)batch * S * d;
          st_save[step * d + j] = c[e];
          st_save[bsd + step * d + j] = n[e];
          st_save[2 * bsd + step * d + j] = m[e];
        }
      }
    }
    __syncthreads();  // h_t is in shared memory; spre is read
  }
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int j = tid + e * nt;
    if (j < d) {
      const long long at = (long long)b * d + j;
      carry[at] = c[e];
      carry[bd + at] = n[e];
      carry[2 * bd + at] = hs[((long long)b * S + S - 1) * d + j];
      carry[3 * bd + at] = m[e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    slstm_bwd(const float* __restrict__ pre, const float* __restrict__ st,
              const T* __restrict__ R, const float* __restrict__ carry0,
              const float* __restrict__ dhs, const float* __restrict__ dlast,
              float* __restrict__ dpre, float* __restrict__ dcarry0,
              int batch, int S, int d) {
  extern __shared__ float smem[];
  float* sdp = smem;          // round(dpre_t) [4d]
  float* sdh = smem + 4 * d;  // the recurrent dL/dh_{t-1} [d]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const long long bd = (long long)batch * d;
  const long long bsd = (long long)batch * S * d;
  const int d4 = 4 * d;
  // dlast / dcarry0: [4][batch][d] as (c, n, h, m); dlast may be NULL
  float dc[kMaxPer], dn[kMaxPer], dm[kMaxPer];
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int j = tid + e * nt;
    if (j < d) {
      const long long at = (long long)b * d + j;
      dc[e] = dlast != nullptr ? dlast[at] : 0.f;
      dn[e] = dlast != nullptr ? dlast[bd + at] : 0.f;
      sdh[j] = dlast != nullptr ? dlast[2 * bd + at] : 0.f;
      dm[e] = dlast != nullptr ? dlast[3 * bd + at] : 0.f;
    }
  }
  for (int t = S - 1; t >= 0; --t) {
    __syncthreads();  // sdh holds dL/dh_t from step t + 1
    const long long step = (long long)b * S + t;
#pragma unroll
    for (int e = 0; e < kMaxPer; ++e) {
      const int j = tid + e * nt;
      if (j < d) {
        const long long at = (long long)b * d + j;
        float pz = pre[step * d4 + j], pi = pre[step * d4 + d + j];
        float pf = pre[step * d4 + 2 * d + j], po = pre[step * d4 + 3 * d + j];
        const float c1 = st[step * d + j], n1 = st[bsd + step * d + j];
        const float m1 = st[2 * bsd + step * d + j];
        const float c0 = t > 0 ? st[step * d - d + j] : carry0[at];
        const float n0 = t > 0 ? st[bsd + step * d - d + j] : carry0[bd + at];
        const float m0 =
            t > 0 ? st[2 * bsd + step * d - d + j] : carry0[3 * bd + at];
        const float z = tanhf(pz), o = sigmoid(po), lf = log_sigmoid(pf);
        const float iw = expf(pi - m1);
        const float fw = expf(lf + m0 - m1);
        const float ex = expf(-m1), floor_ = ex + 1e-6f;
        const float den = fmaxf(n1, floor_);
        const float q = c1 / den;

        const float dh = dhs[step * d + j] + sdh[j];
        const float d_o = dh * q;
        const float dq = dh * o;
        float dc1 = dc[e] + dq / den;
        const float dden = -dq * c1 / (den * den);
        float dn1 = dn[e] + dden * max_share(n1, floor_);
        float dm1 = dm[e] - dden * max_share(floor_, n1) * ex;
        float dfw = dn1 * n0 + dc1 * c0;
        float diw = dn1 + dc1 * z;
        const float dz = dc1 * iw;
        float dpi = diw * iw;
        dm1 -= diw * iw;
        const float dfa = dfw * fw;  // dL/d(f + m - m')
        float dlf = dfa;
        float dm0 = dfa;
        dm1 -= dfa;
        const float fm = lf + m0;
        const float dA = dm1 * max_share(fm, pi);
        dpi += dm1 * max_share(pi, fm);
        dlf += dA;
        dm0 += dA;
        // log_sigmoid's backward as torch computes it
        const float zf = expf(-fabsf(pf));
        const float dpf =
            dlf * ((pf < 0.f ? 1.f : 0.f) - (pf < 0.f ? 1.f : -1.f) * (zf / (1.f + zf)));
        const float dpo = d_o * (1.f - o) * o;
        const float dpz = dz * (1.f - z * z);

        dpre[step * d4 + j] = dpz;
        dpre[step * d4 + d + j] = dpi;
        dpre[step * d4 + 2 * d + j] = dpf;
        dpre[step * d4 + 3 * d + j] = dpo;
        sdp[j] = round_to<T>(dpz);
        sdp[d + j] = round_to<T>(dpi);
        sdp[2 * d + j] = round_to<T>(dpf);
        sdp[3 * d + j] = round_to<T>(dpo);
        dc[e] = dc1 * fw;
        dn[e] = dn1 * fw;
        dm[e] = dm0;
      }
    }
    __syncthreads();  // sdp holds round(dpre_t); sdh is read
    // dL/dh_{t-1}[k] = round(sum_col sdp[col] R[k, col]): a warp a row,
    // kCols columns a lane a load
    for (int k = warp; k < d; k += warps) {
      const T* rk = R + (long long)k * d4;
      float acc = 0.f;
      for (int col = lane * kCols; col < d4; col += 32 * kCols) {
        float r8[kCols];
        load8(rk + col, r8);
        const float4 a = *reinterpret_cast<const float4*>(sdp + col);
        const float4 b4 = *reinterpret_cast<const float4*>(sdp + col + 4);
        acc = fmaf(a.x, r8[0], acc);
        acc = fmaf(a.y, r8[1], acc);
        acc = fmaf(a.z, r8[2], acc);
        acc = fmaf(a.w, r8[3], acc);
        acc = fmaf(b4.x, r8[4], acc);
        acc = fmaf(b4.y, r8[5], acc);
        acc = fmaf(b4.z, r8[6], acc);
        acc = fmaf(b4.w, r8[7], acc);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      }
      if (lane == 0) sdh[k] = round_to<T>(acc);
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int j = tid + e * nt;
    if (j < d) {
      const long long at = (long long)b * d + j;
      dcarry0[at] = dc[e];
      dcarry0[bd + at] = dn[e];
      dcarry0[2 * bd + at] = sdh[j];
      dcarry0[3 * bd + at] = dm[e];
    }
  }
}

template <typename T>
int launch_fwd(const float* pre_x, const void* R, const float* carry0,
               float* hs, float* carry, float* pre_save, float* st_save,
               int batch, int S, int d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 5 * d;
  slstm_fwd<T><<<batch, block_threads(d), smem, stream>>>(
      pre_x, static_cast<const T*>(R), carry0, hs, carry, pre_save, st_save,
      batch, S, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const float* pre, const float* st, const void* R,
               const float* carry0, const float* dhs, const float* dlast,
               float* dpre, float* dcarry0, int batch, int S, int d,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * 5 * d;
  slstm_bwd<T><<<batch, block_threads(d), smem, stream>>>(
      pre, st, static_cast<const T*>(R), carry0, dhs, dlast, dpre, dcarry0,
      batch, S, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r_dtype: 0 = float32, 1 = bfloat16. carry0 / carry [4, batch, d] as
// (c, n, h, m); pre_save [batch, S, 4d] and st_save [3, batch, S, d] may be
// NULL (no gradient wanted). d even, d <= 1024; R and pre_x 16-byte
// aligned.
extern "C" int repro_slstm_scan_fwd(const float* pre_x, const void* R,
                                    const float* carry0, float* hs,
                                    float* carry, float* pre_save,
                                    float* st_save, int batch, int S, int d,
                                    int r_dtype, void* stream) {
  if (d > 1024 || d % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0) {
    return launch_fwd<float>(pre_x, R, carry0, hs, carry, pre_save, st_save,
                             batch, S, d, s);
  }
  return launch_fwd<__nv_bfloat16>(pre_x, R, carry0, hs, carry, pre_save,
                                   st_save, batch, S, d, s);
}

// dlast [4, batch, d] (the last carry's gradient) may be NULL; dcarry0 is
// the initial carry's [4, batch, d].
extern "C" int repro_slstm_scan_bwd(const float* pre, const float* st,
                                    const void* R, const float* carry0,
                                    const float* dhs, const float* dlast,
                                    float* dpre, float* dcarry0, int batch,
                                    int S, int d, int r_dtype, void* stream) {
  if (d > 1024 || d % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0) {
    return launch_bwd<float>(pre, st, R, carry0, dhs, dlast, dpre, dcarry0,
                             batch, S, d, s);
  }
  return launch_bwd<__nv_bfloat16>(pre, st, R, carry0, dhs, dlast, dpre,
                                   dcarry0, batch, S, d, s);
}
