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
// 2.7 GB at Jamba's served 2 x 8192 x 16384 in bf16, 0.80 ms at 3.35 TB/s)
// and needs DS exponentials a (token, channel): 4.3 G `ex2` on the MUFU,
// 1.03 ms at 16 a clock an SM, the larger. The backward moves about 0.74 GB
// at 1 x 2048 x 16384 (0.22 ms) and needs one exponential a cell (0.13 ms).
// What stands between each kernel and its bound is the serial dependency
// over S: a step of a (row, channel) waits for the last, so the card needs
// many warps in flight, each issuing few instructions a step. The design:
//   * the DS states of a (row, channel) are split over L = DS / 4 lanes,
//     4 states a lane (L = 4 at DS 16, 1 at DS 4): the parallelism is
//     B x di x L threads and a thread needs few registers. A warp holds
//     32 / L channels; a channel's L lanes sit in L quarter-warps (lane =
//     part x 32 / L + channel), so the 8 lanes of a quarter-warp read the
//     same 16 bytes of B_t and of C_t (one broadcast) and the sums over a
//     channel's lanes shuffle across quarter-warps;
//   * the forward's 128-thread blocks run at most 64 registers a thread,
//     eight an SM (32 warps). y_t is the sum of the L lanes' partials: one
//     reduce-scatter every L steps (3 shuffles for 4 steps at L = 4) leaves
//     each lane one step's sum, which it stores;
//   * a chunk of kChunk steps' dt, u, B and C is staged in shared memory,
//     double-buffered, one barrier a chunk: each thread loads its share of
//     the next chunk into registers while the current one runs (coalesced
//     rows of the block's channels); a lane reads (dt, u) as one 8-byte pair
//     and its four B_t and C_t as one 16-byte load each. The forward runs a
//     full chunk without a branch a step, so that a step's loads issue
//     during the last step's arithmetic; only the last chunk is guarded;
//   * the decay is `ex2.approx` (one MUFU op) of dt * (A * log2 e), the
//     product A * log2 e rounded once a thread: a fixed relative error of at
//     most 2^-24 in each step's exponent, which a state forgets at the rate
//     it decays, so h's relative error stays near 1e-7 however long S is
//     (the checks hold it to the float32 route's 1e-4 at 8192 steps with a
//     wide margin). The input is (dt * u) * B_t[n], one product a step
//     fewer than the plain version's (dt * B_t[n]) * u, equal to it within
//     a rounding. Fewer instructions a step is what the card rewards here:
//     it issues about as many as the MUFU's 16 a clock an SM takes, and
//     falls short of both.
//
// The backward starts from checkpoints of h that the forward saves every
// kChunk steps when asked ([B, nchunks, di, DS]). For each chunk, last to
// first, it recomputes the chunk's states into registers (16 steps x 4
// states a lane, indexed at compile time) and their decays into shared
// memory (each thread its own 16 x 16 bytes, so one exponential a cell),
// then walks back through them:
//
//     g_t    = C_t * dy_t + exp(dt_{t+1} A) * g_{t+1}      (dL/dh_t)
//     du_t   = sum_n g_t dt_t B_t
//     ddt_t  = sum_n g_t (B_t u_t + h_{t-1} exp(dt_t A) A)
//     dA    += g_t h_{t-1} exp(dt_t A) dt_t               (over b and t)
//     dB_t  += g_t dt_t u_t,  dC_t += h_t dy_t            (over channels)
//
// du and ddt sum the L lanes of a channel (one reduce-scatter of the pair).
// dB and dC are sums over channels: each warp reduces its channels' 8
// values a lane by a reduce-scatter over the lane bits that name the
// channel (7 shuffles at L = 4), the block's warps are added in shared
// memory, and each block writes one partial [nblocks, B, S, 2 DS] that the
// wrapper sums. dA's partials are per row [B, di, DS]. No atomics: the
// result does not depend on the order in which blocks run. The backward's
// 512-thread blocks hold 128 channels (half the partials of 64-channel
// blocks) at up to 128 registers a thread, one block (16 warps) an SM;
// 256 channels a block would need 1024 threads at 64 registers, which the
// chunk's 64 states a lane do not leave.
//
// The host plans each launch (kernels/selective_scan.py, `plan`): the
// launchers take the plan's channels, threads and shared bytes, and refuse
// to launch where they differ from this file's Layout<DS>; the wrapper
// reads Layout<DS> through repro_selective_scan_layout first and raises.
//
// Plain C interface (loaded with ctypes); each launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;        // steps a chunk = the checkpoint interval
constexpr int kNs = 4;            // states a lane
constexpr int kFwdThreads = 128;  // threads a forward block
constexpr int kBwdChannels = 128; // channels a backward block
constexpr float kLog2e = 1.4426950216293335f;  // float(log2 e)

template <int DS>
struct Layout {
  static_assert(DS % kNs == 0, "DS must be a multiple of the lane's states");
  static constexpr int kLanes = DS / kNs;
  // forward: [2][kChunk] x ((dt, u)[C], B[DS], C[DS])
  static constexpr int kFwdChannels = kFwdThreads / kLanes;
  // eight blocks an SM at 4 lanes (64 registers a thread); a lane that
  // holds a whole channel (DS 4) stages 16 steps of it: four
  static constexpr int kFwdMinBlocks = kLanes == 1 ? 4 : 8;
  static constexpr long long kFwdSmem =
      4LL * 2 * kChunk * (2 * kFwdChannels + 2 * DS);
  // backward: [2][kChunk] x ((dt, u)[C], dy[C], B[DS], C[DS]), the
  // decays [kChunk][threads][kNs], the warps' sums [kChunk][warps][2 DS]
  static constexpr int kBwdThreads = kBwdChannels * kLanes;
  static constexpr int kBwdWarps = kBwdThreads / 32;
  static constexpr int kBwdStep = 3 * kBwdChannels + 2 * DS;
  static constexpr long long kBwdSmem =
      4LL * (2 * kChunk * kBwdStep + kChunk * kBwdThreads * kNs +
             kChunk * kBwdWarps * 2 * DS);
  static_assert(kFwdThreads % 32 == 0 && kBwdThreads % 32 == 0, "warps");
  static_assert(kBwdSmem <= 232448, "Hopper's shared memory a block");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A * log2 e, rounded once a thread, and the decay exp(dt * A) from it:
// one multiply and one MUFU op.
struct Rate {
  float a2;
  __device__ __forceinline__ void set(float a) { a2 = a * kLog2e; }
  __device__ __forceinline__ float decay(float dt) const {
    return ex2(dt * a2);
  }
};

// Sum over the warp's lanes that differ in bits OFF, OFF / 2, ..., STOP of
// v[i], scattered: each round keeps half of the values and adds the
// partner's other half, so after log2 N rounds the lane holds the sum of
// v[i] for i = its bits OFF .. (read high to low); the rounds left add that
// one value over the remaining bits. N <= 32.
template <int N, int OFF, int STOP>
struct ReduceScatter {
  __device__ __forceinline__ static float run(float* v, int lane) {
    if constexpr (N == 1) {
      float x = v[0];
#pragma unroll
      for (int o = OFF; o >= STOP; o >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, o);
      }
      return x;
    } else {
      static_assert(OFF >= STOP, "more values than lane bits");
      constexpr int kH = N / 2;
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float send = upper ? v[i] : v[i + kH];
        const float keep = upper ? v[i + kH] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      return ReduceScatter<kH, OFF / 2, STOP>::run(v, lane);
    }
  }
};

// One chunk's per-step rows of a block's channels, [kChunk][C] of each of
// NR arrays ([B, S, di], element type of each) and [kChunk][DS] of B and C
// ([B, S, DS]), staged through registers: load() issues the global loads of
// this thread's share, store() writes them to shared memory. Rows past S
// and channels past di are zeros.
template <int C, int DS, int THREADS>
struct Stage {
  static constexpr int kPerArray = kChunk * C / THREADS;
  static constexpr int kPerBc = (kChunk * DS + THREADS - 1) / THREADS;
  static_assert(kChunk * C % THREADS == 0, "a whole share a thread");
  float rows[3][kPerArray];
  float bc[2][kPerBc];

  template <int NR, typename T>
  __device__ __forceinline__ void load(const T* __restrict__ u,
                                       const float* __restrict__ dt,
                                       const float* __restrict__ dy,
                                       const float* __restrict__ Bm,
                                       const float* __restrict__ Cm,
                                       long long row, int t0, int S, int d0,
                                       int di, int tid) {
#pragma unroll
    for (int i = 0; i < kPerArray; ++i) {
      const int e = tid + i * THREADS;
      const int t = t0 + e / C, d = d0 + e % C;
      const bool ok = t < S && d < di;
      const long long at = ok ? (row + t) * di + d : 0;
      rows[0][i] = ok ? dt[at] : 0.f;
      rows[1][i] = ok ? to_float(u[at]) : 0.f;
      if constexpr (NR == 3) rows[2][i] = ok ? dy[at] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerBc; ++i) {
      const int e = tid + i * THREADS;
      const bool ok = e < kChunk * DS && t0 + e / DS < S;
      const long long at = ok ? (row + t0) * DS + e : 0;
      bc[0][i] = ok ? Bm[at] : 0.f;
      bc[1][i] = ok ? Cm[at] : 0.f;
    }
  }

  // dst: [kChunk] rows of ((dt, u) pairs[C], dy[C] when NR is 3, B[DS],
  // C[DS]) floats
  template <int NR>
  __device__ __forceinline__ void store(float* dst, int tid) const {
    constexpr int kStep = NR * C + 2 * DS;
#pragma unroll
    for (int i = 0; i < kPerArray; ++i) {
      const int e = tid + i * THREADS;
      float* at = dst + (e / C) * kStep;
      *reinterpret_cast<float2*>(at + 2 * (e % C)) =
          make_float2(rows[0][i], rows[1][i]);
      if constexpr (NR == 3) at[2 * C + e % C] = rows[2][i];
    }
#pragma unroll
    for (int i = 0; i < kPerBc; ++i) {
      const int e = tid + i * THREADS;
      if (e < kChunk * DS) {
        float* at = dst + (e / DS) * kStep + NR * C + e % DS;
        at[0] = bc[0][i];
        at[DS] = bc[1][i];
      }
    }
  }
};

// ---- forward ---------------------------------------------------------------

// One chunk of the forward from the staged rows `cur`, y to yp[j * di].
// kGuard: the chunk may be shorter than kChunk (the last one); a full chunk
// runs without a branch a step, so its steps' loads can be issued early.
// y_t is summed over the L lanes by one reduce-scatter every L steps (each
// lane ends with one step's sum and stores it).
template <int DS, bool kGuard>
__device__ __forceinline__ void fwd_chunk(const float* cur, float* yp,
                                          int len, int di, int c, int p,
                                          bool live, float (&h)[kNs],
                                          const Rate (&rate)[kNs]) {
  using Lay = Layout<DS>;
  constexpr int L = Lay::kLanes, C = Lay::kFwdChannels;
  constexpr int kStep = 2 * C + 2 * DS;
  float accs[L];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    float acc = 0.f;
    if (!kGuard || j < len) {
      const float* at = cur + j * kStep;
      const float2 tu = *reinterpret_cast<const float2*>(at + 2 * c);
      const float dtv = tu.x, uv = tu.y;
      const float4 bv = *reinterpret_cast<const float4*>(at + 2 * C + p * kNs);
      const float4 cv =
          *reinterpret_cast<const float4*>(at + 2 * C + DS + p * kNs);
      const float bn[kNs] = {bv.x, bv.y, bv.z, bv.w};
      const float cn[kNs] = {cv.x, cv.y, cv.z, cv.w};
      const float dtu = dtv * uv;
#pragma unroll
      for (int n = 0; n < kNs; ++n) {
        const float bu = dtu * bn[n];
        h[n] = fmaf(rate[n].decay(dtv), h[n], bu);
        acc = fmaf(h[n], cn[n], acc);
      }
    }
    if constexpr (L == 1) {
      if (live && (!kGuard || j < len)) yp[j * di] = acc;
    } else {
      // the L lanes' partials of L steps, scattered: lane p ends with the
      // sum of step j - L + 1 + p
      accs[j % L] = acc;
      if (j % L == L - 1) {
        const float sum = ReduceScatter<L, 16, 32 / L>::run(accs, threadIdx.x);
        const int step = j - (L - 1) + p;
        if (live && (!kGuard || step < len)) yp[step * di] = sum;
      }
    }
  }
}

template <int DS, typename T>
__global__ void __launch_bounds__(kFwdThreads, Layout<DS>::kFwdMinBlocks)
    scan_fwd(const T* __restrict__ u, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ h_last,
             float* __restrict__ ck, int S, int di) {
  using Lay = Layout<DS>;
  constexpr int L = Lay::kLanes, C = Lay::kFwdChannels;
  constexpr int kStep = 2 * C + 2 * DS;
  extern __shared__ __align__(16) float smem[];  // [2][kChunk][kStep]

  const int tid = threadIdx.x;
  // channel c of the block, part p of its states: a warp's 32 / L
  // channels, each channel's lanes 32 / L apart
  const int c = (tid >> 5) * (32 / L) + (tid & 31) % (32 / L);
  const int p = (tid & 31) / (32 / L);
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int d = d0 + c;
  const bool live = d < di;
  const int dd = live ? d : 0;  // dead lanes read channel 0, store nothing
  const long long row = (long long)b * S;
  const int nchunks = (S + kChunk - 1) / kChunk;
  const long long state = ((long long)b * di + dd) * DS + p * kNs;

  float h[kNs];
  Rate rate[kNs];
#pragma unroll
  for (int n = 0; n < kNs; ++n) {
    rate[n].set(A[(long long)dd * DS + p * kNs + n]);
    h[n] = h0[state + n];
  }

  Stage<C, DS, kFwdThreads> next;
  next.template load<2>(u, dt, nullptr, Bm, Cm, row, 0, S, d0, di, tid);
#pragma unroll 1
  for (int ch = 0; ch < nchunks; ++ch) {
    float* cur = smem + (ch & 1) * kChunk * kStep;
    next.template store<2>(cur, tid);
    // cur is written; every thread is past chunk ch - 2, its last reader
    __syncthreads();
    const int t0 = ch * kChunk;
    if (ch + 1 < nchunks) {
      next.template load<2>(u, dt, nullptr, Bm, Cm, row, t0 + kChunk, S, d0,
                            di, tid);
    }
    if (ck != nullptr && live) {
      float* out = ck + (((long long)b * nchunks + ch) * di + d) * DS + p * kNs;
#pragma unroll
      for (int n = 0; n < kNs; ++n) out[n] = h[n];
    }
    const int len = min(kChunk, S - t0);
    float* yp = y + (row + t0) * di + d;
    if (len < kChunk) {
      fwd_chunk<DS, true>(cur, yp, len, di, c, p, live, h, rate);
    } else {
      fwd_chunk<DS, false>(cur, yp, len, di, c, p, live, h, rate);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kNs; ++n) h_last[state + n] = h[n];
  }
}

// ---- backward --------------------------------------------------------------

// What a backward lane keeps from chunk to chunk.
struct BwdLane {
  float a[kNs], gcar[kNs], dA[kNs];
  Rate rate[kNs];
};

// One chunk of the backward from the staged rows `cur` and the checkpoint
// hprev0 = h_{t0 - 1}: the chunk's states into registers and their decays
// into this thread's slots of `decays`, then the reverse walk; du and ddt
// to du_p[j * di] / ddt_p[j * di], the warp's sums of dB and dC a step to
// red. Every step is guarded by j < len: unlike the forward's, the
// backward's full chunks ran slower without the branches (more spills).
// A function of its own: the same code written into the kernel's loop ran
// slower (its registers allocated otherwise).
template <int DS>
__device__ __forceinline__ void bwd_chunk(
    const float* cur, float* decays, float* red, float* du_p, float* ddt_p,
    int len, int di, int c, int p, int tid, bool live,
    const float (&hprev0)[kNs], BwdLane& s) {
  using Lay = Layout<DS>;
  constexpr int L = Lay::kLanes, C = kBwdChannels;
  constexpr int kThreads = Lay::kBwdThreads, kWarps = Lay::kBwdWarps;
  constexpr int kStep = Lay::kBwdStep;
  constexpr int kV = 2 * DS;  // dB then dC, per step
  const int lane = tid & 31, warp = tid >> 5;
  // where this lane's reduce-scatter of dB and dC leaves its sum, if it
  // holds one: over the lane bits kOff .. 1 that name the channel
  constexpr int kOff = 16 / L;
  const int k = (lane / (kOff / 4)) & 7;
  const bool holds = lane % (kOff / 4) == 0;
  const int slot = k < kNs ? p * kNs + k : DS + p * kNs + (k - kNs);

  // the chunk's states h_{t0} .. h_{t0+len-1}, as the forward made them,
  // and their decays
  float hs[kChunk][kNs];
  {
    float h[kNs];
#pragma unroll
    for (int n = 0; n < kNs; ++n) h[n] = hprev0[n];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < len) {
        const float* at = cur + j * kStep;
        const float2 tu = *reinterpret_cast<const float2*>(at + 2 * c);
        const float dtv = tu.x, uv = tu.y;
        const float4 bv =
            *reinterpret_cast<const float4*>(at + 3 * C + p * kNs);
        const float bn[kNs] = {bv.x, bv.y, bv.z, bv.w};
        const float dtu = dtv * uv;
        float dec[kNs];
#pragma unroll
        for (int n = 0; n < kNs; ++n) {
          dec[n] = s.rate[n].decay(dtv);
          h[n] = fmaf(dec[n], h[n], dtu * bn[n]);
          hs[j][n] = h[n];
        }
        *reinterpret_cast<float4*>(decays + (j * kThreads + tid) * kNs) =
            make_float4(dec[0], dec[1], dec[2], dec[3]);
      }
    }
  }

#pragma unroll
  for (int j = kChunk - 1; j >= 0; --j) {
    if (j < len) {
      const float* at = cur + j * kStep;
      const float2 tu = *reinterpret_cast<const float2*>(at + 2 * c);
      const float dtv = tu.x, uv = tu.y, dyv = at[2 * C + c];
      const float4 bv =
          *reinterpret_cast<const float4*>(at + 3 * C + p * kNs);
      const float4 cv =
          *reinterpret_cast<const float4*>(at + 3 * C + DS + p * kNs);
      const float4 ev = *reinterpret_cast<const float4*>(
          decays + (j * kThreads + tid) * kNs);
      const float bn[kNs] = {bv.x, bv.y, bv.z, bv.w};
      const float cn[kNs] = {cv.x, cv.y, cv.z, cv.w};
      const float en[kNs] = {ev.x, ev.y, ev.z, ev.w};
      float v[2 * kNs];
      float du_acc = 0.f, ddt_acc = 0.f;
#pragma unroll
      for (int n = 0; n < kNs; ++n) {
        const float hp = j > 0 ? hs[j - 1][n] : hprev0[n];
        const float g = fmaf(cn[n], dyv, s.gcar[n]);
        const float gdt = g * dtv;
        v[n] = gdt * uv;              // dB_t[p * 4 + n], this channel's share
        v[kNs + n] = hs[j][n] * dyv;  // dC_t[p * 4 + n]
        du_acc = fmaf(gdt, bn[n], du_acc);
        const float gd = g * hp * en[n];  // dL/d(dt_t A[d, n])
        ddt_acc = fmaf(g * bn[n], uv, ddt_acc);
        ddt_acc = fmaf(gd, s.a[n], ddt_acc);
        s.dA[n] = fmaf(gd, dtv, s.dA[n]);
        s.gcar[n] = en[n] * g;
      }
      if constexpr (L == 1) {
        if (live) {
          du_p[j * di] = du_acc;
          ddt_p[j * di] = ddt_acc;
        }
      } else {
        // over the lane bits that name the part: lanes of parts 0 and 1
        // end with du, of 2 and 3 with ddt
        float w[2] = {du_acc, ddt_acc};
        const float sum = ReduceScatter<2, 16, 32 / L>::run(w, lane);
        if (live && (p & (L / 2 - 1)) == 0) {
          ((p & (L / 2)) ? ddt_p : du_p)[j * di] = sum;
        }
      }
      const float sum = ReduceScatter<2 * kNs, kOff, 1>::run(v, lane);
      if (holds) red[(j * kWarps + warp) * kV + slot] = sum;
    }
  }
}

template <int DS, typename T>
__global__ void __launch_bounds__(Layout<DS>::kBwdThreads, 1)
    scan_bwd(const T* __restrict__ u, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ ck,
             const float* __restrict__ dy, const float* __restrict__ dh_last,
             float* __restrict__ du, float* __restrict__ ddt,
             float* __restrict__ dA_part, float* __restrict__ dbc_part,
             float* __restrict__ dh0, int batch, int S, int di) {
  using Lay = Layout<DS>;
  constexpr int L = Lay::kLanes, C = kBwdChannels;
  constexpr int kThreads = Lay::kBwdThreads, kWarps = Lay::kBwdWarps;
  constexpr int kStep = Lay::kBwdStep;
  constexpr int kV = 2 * DS;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                               // [2][kChunk][kStep]
  float* decays = stage + 2 * kChunk * kStep;        // [kChunk][threads][kNs]
  float* red = decays + kChunk * kThreads * kNs;     // [kChunk][warps][kV]

  const int tid = threadIdx.x;
  const int c = (tid >> 5) * (32 / L) + (tid & 31) % (32 / L);  // as forward
  const int p = (tid & 31) / (32 / L);
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int d = d0 + c;
  const bool live = d < di;
  const int dd = live ? d : 0;
  const long long row = (long long)b * S;
  const int nchunks = (S + kChunk - 1) / kChunk;
  const long long state = ((long long)b * di + dd) * DS + p * kNs;

  BwdLane s;
#pragma unroll
  for (int n = 0; n < kNs; ++n) {
    s.a[n] = A[(long long)dd * DS + p * kNs + n];
    const float g0 = dh_last != nullptr ? dh_last[state + n] : 0.f;
    s.gcar[n] = live ? g0 : 0.f;  // exp(dt_{t+1} A) g_{t+1}; dL/dh_{S-1} first
    s.dA[n] = 0.f;
    s.rate[n].set(s.a[n]);
  }

  Stage<C, DS, kThreads> next;
  next.template load<3>(u, dt, dy, Bm, Cm, row, (nchunks - 1) * kChunk, S,
                        d0, di, tid);
#pragma unroll 1
  for (int ch = nchunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk;
    const int len = min(kChunk, S - t0);
    float* cur = stage + (ch & 1) * kChunk * kStep;
    next.template store<3>(cur, tid);
    // cur is written; every thread is past chunk ch + 1's sums of red
    __syncthreads();
    if (ch > 0) {
      next.template load<3>(u, dt, dy, Bm, Cm, row, t0 - kChunk, S, d0, di,
                            tid);
    }
    float hprev0[kNs];
    const float* cko =
        ck + (((long long)b * nchunks + ch) * di + dd) * DS + p * kNs;
#pragma unroll
    for (int n = 0; n < kNs; ++n) hprev0[n] = cko[n];
    const long long at = (row + t0) * di + d;
    bwd_chunk<DS>(cur, decays, red, du + at, ddt + at, len, di, c, p, tid,
                  live, hprev0, s);
    __syncthreads();
    for (int e = tid; e < len * kV; e += kThreads) {
      const int j = e / kV, o = e % kV;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(j * kWarps + w) * kV + o];
      dbc_part[(((long long)blockIdx.x * batch + b) * S + t0 + j) * kV + o] =
          sum;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
      dA_part[state + n] = s.dA[n];
      dh0[state + n] = s.gcar[n];  // exp(dt_0 A) g_0 = dL/dh_{-1}
    }
  }
}

// The launch's shape as this file lays it out: lanes a (row, channel),
// channels, threads and shared bytes a block.
template <int DS>
void layout(int direction, int* out, long long* smem) {
  using Lay = Layout<DS>;
  out[0] = Lay::kLanes;
  out[1] = direction == 0 ? Lay::kFwdChannels : kBwdChannels;
  out[2] = direction == 0 ? kFwdThreads : Lay::kBwdThreads;
  *smem = direction == 0 ? Lay::kFwdSmem : Lay::kBwdSmem;
}

template <int DS>
bool plan_ok(int direction, int channels, int threads, long long smem) {
  int want[3];
  long long want_smem;
  layout<DS>(direction, want, &want_smem);
  return channels == want[1] && threads == want[2] && smem == want_smem;
}

template <int DS, typename T>
int launch_fwd(const void* u, const float* dt, const float* A,
               const float* Bm, const float* Cm, const float* h0, float* y,
               float* h_last, float* ck, int batch, int S, int di,
               int channels, int threads, long long smem,
               cudaStream_t stream) {
  if (!plan_ok<DS>(0, channels, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(
      scan_fwd<DS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((di + channels - 1) / channels, batch);
  scan_fwd<DS, T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(u), dt, A, Bm, Cm, h0, y, h_last, ck, S, di);
  return static_cast<int>(cudaGetLastError());
}

template <int DS, typename T>
int launch_bwd(const void* u, const float* dt, const float* A,
               const float* Bm, const float* Cm, const float* ck,
               const float* dy, const float* dh_last, float* du, float* ddt,
               float* dA_part, float* dbc_part, float* dh0, int batch, int S,
               int di, int channels, int threads, long long smem,
               cudaStream_t stream) {
  if (!plan_ok<DS>(1, channels, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd<DS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((di + channels - 1) / channels, batch);
  scan_bwd<DS, T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(u), dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
      dA_part, dbc_part, dh0, batch, S, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_by_state(int ds, const void* u, const float* dt, const float* A,
                 const float* Bm, const float* Cm, const float* h0, float* y,
                 float* h_last, float* ck, int batch, int S, int di,
                 int channels, int threads, long long smem,
                 cudaStream_t stream) {
  switch (ds) {
    case 4:
      return launch_fwd<4, T>(u, dt, A, Bm, Cm, h0, y, h_last, ck, batch, S,
                              di, channels, threads, smem, stream);
    case 16:
      return launch_fwd<16, T>(u, dt, A, Bm, Cm, h0, y, h_last, ck, batch, S,
                               di, channels, threads, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_by_state(int ds, const void* u, const float* dt, const float* A,
                 const float* Bm, const float* Cm, const float* ck,
                 const float* dy, const float* dh_last, float* du, float* ddt,
                 float* dA_part, float* dbc_part, float* dh0, int batch,
                 int S, int di, int channels, int threads, long long smem,
                 cudaStream_t stream) {
  switch (ds) {
    case 4:
      return launch_bwd<4, T>(u, dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
                              dA_part, dbc_part, dh0, batch, S, di, channels,
                              threads, smem, stream);
    case 16:
      return launch_bwd<16, T>(u, dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
                               dA_part, dbc_part, dh0, batch, S, di, channels,
                               threads, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// direction: 0 = forward, 1 = backward; ds 4 or 16 (the d_state of the
// repo's configs: Jamba's 16, its smoke config's 4). out[0..3) = lanes a
// (row, channel), channels a block, threads a block; *smem = shared bytes.
extern "C" int repro_selective_scan_layout(int direction, int ds, int* out,
                                           long long* smem) {
  if (direction != 0 && direction != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (ds) {
    case 4:
      layout<4>(direction, out, smem);
      return 0;
    case 16:
      layout<16>(direction, out, smem);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// u_dtype: 0 = float32, 1 = bfloat16. ck may be NULL (no checkpoints).
// channels, threads, smem: the host plan's, refused unless they are the
// kernel's.
extern "C" int repro_selective_scan_fwd(
    const void* u, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* h0, float* y, float* h_last, float* ck,
    int batch, int S, int di, int ds, int u_dtype, int channels, int threads,
    long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_dtype == 0) {
    return fwd_by_state<float>(ds, u, dt, A, Bm, Cm, h0, y, h_last, ck,
                               batch, S, di, channels, threads, smem, s);
  }
  return fwd_by_state<__nv_bfloat16>(ds, u, dt, A, Bm, Cm, h0, y, h_last, ck,
                                     batch, S, di, channels, threads, smem,
                                     s);
}

// dh_last may be NULL (no gradient on the last state). dbc_part is
// [ceil(di / channels), batch, S, 2 ds], dA_part [batch, di, ds].
extern "C" int repro_selective_scan_bwd(
    const void* u, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* ck, const float* dy, const float* dh_last,
    float* du, float* ddt, float* dA_part, float* dbc_part, float* dh0,
    int batch, int S, int di, int ds, int u_dtype, int channels, int threads,
    long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_dtype == 0) {
    return bwd_by_state<float>(ds, u, dt, A, Bm, Cm, ck, dy, dh_last, du, ddt,
                               dA_part, dbc_part, dh0, batch, S, di, channels,
                               threads, smem, s);
  }
  return bwd_by_state<__nv_bfloat16>(ds, u, dt, A, Bm, Cm, ck, dy, dh_last,
                                     du, ddt, dA_part, dbc_part, dh0, batch,
                                     S, di, channels, threads, smem, s);
}
