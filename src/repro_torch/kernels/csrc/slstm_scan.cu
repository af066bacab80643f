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
// so the S steps run one after another, and a step's time is latency: of
// the product, of the cell and of passing h_{t-1} on. The design keeps R
// on chip for the whole launch and spreads it over the card:
//
// * A persistent cooperative grid. The d hidden units are split into P
//   groups of U consecutive units (U <= 8, P = ceil(d / U), chosen by the
//   wrapper's plan so that P blocks fit on the card at once); block j owns
//   the units J_j for every row. The launch is cudaLaunchCooperativeKernel,
//   so the card either holds all P blocks at once or refuses the launch
//   (the launcher returns that error; there is no other design).
// * Forward. Block j keeps R's 4U columns {g d + u : g in (z, i, f, o),
//   u in J_j} for all d rows in shared memory (d x 4U in T). Each step it
//   reads round(h_{t-1}) [B, d] from a double-buffered exchange buffer in
//   global memory, computes its [B, 4U] product over all d rows (so each
//   column's sum is whole in one block and rounded to T once), adds pre_x,
//   applies the cell to its B x U elements, writes h_t's rounded units into
//   the other buffer and passes one grid barrier.
// * Backward. Block j keeps R's rows J_j (U x 4d). Each step, from the last
//   to the first, it turns its elements' dL/dh_t (the output's gradient
//   plus the recurrent part from step t + 1) into dpre_t with autograd's
//   rules (a tie of `maximum` splits the gradient in halves), writes
//   round(dpre_t) into the exchange buffer, passes one grid barrier, reads
//   round(dpre_t) [B, 4d] whole and computes its units of
//   dL/dh_{t-1} = round(round(dpre_t) @ R^T). dR = H_prev^T dpre is one
//   matrix product in the wrapper.
// * Products. Forward bf16: mma.sync m16n8k16 (bf16 in, float32 out), the
//   rows of a tile of 16 as M (padded), the reduction over d split over
//   the 8 warps. Each 16-deep block's product starts from zero and is
//   added to the warp's sums with FADD (round to nearest): the tensor cores
//   align and truncate what they add, so a sum carried through them drifts
//   as it grows. Backward bf16: each product of two bf16 values is exact
//   in float and the lanes, the shuffles and the warps sum them in double,
//   so the recurrent gradient is its exact sum over K = 4d rounded to bf16
//   once, whatever the order. float32: FFMA (no TF32), split over the
//   warps. The warps' partial sums are added in a fixed order.
// * Rounding. Both cells round where the plain version (kernels/ref.py)
//   rounds: each product that meets a sum is __fmul_rn, so nvcc contracts
//   no a * b + c into one FMA. At bf16 a last-bit difference in dpre flips
//   its rounding to bf16 at a near-tie, and the flip travels down the
//   steps; a backward held against the plain version by its distance to
//   the float32 truth has to make the plain version's roundings.
// * Rows. A block loops over the batch in tiles of `rows` (16 in bf16; in
//   float32 what shared memory holds, at most 16), so any B >= 1 works.
//   Each thread owns one (row, unit) element of a tile; its running state
//   ((c, n, m) forward, (dc, dn, dh, dm) backward) lives in the output
//   carry, read and written by that thread alone.
// * Barrier. A counter in global memory that the wrapper zeroes before the
//   launch: after a CTA barrier each block's thread 0 adds one with
//   red.release.gpu and spins with ld.acquire.gpu until all P blocks have
//   added one for this phase, then a CTA barrier again. The exchange
//   buffer changes during the launch, so it is read with ld.global.cg (L2,
//   never the read-only or L1 path). Double buffering makes one barrier a
//   step enough: a block writes buffer t mod 2 only after every block has
//   passed the barrier that ended step t - 1, and so has finished reading
//   it.
//
// Plain C interface (loaded with ctypes); each launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;      // rows of a tile at most (mma's M)
constexpr int kMaxUnits = 8;      // 4U <= 32 columns: a warp's lanes
constexpr int kMaxD = 1024;
constexpr long long kSmemLimit = 232448;  // 227 KB a block
constexpr int kCounterBytes = 16;         // the barrier's counter, padded
constexpr unsigned long long kBarrierTimeoutNs = 2000000000ULL;  // 2 s

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

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

// The backward's recurrent sum rounded to T once (bf16: from double).
template <typename T>
__device__ __forceinline__ float round_sum(float v) {
  return round_to<T>(v);
}
template <typename T>
__device__ __forceinline__ float round_sum(double v) {
  return __bfloat162float(__double2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

// D += A B for one m16n8k16 tile: bf16 A (row) and B (col), float32 D
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block adds one to `counter` and waits until it reads `target`:
// the writes of the whole block before the call are visible to every
// block after it (the CTA barrier, then thread 0's release add; its
// acquire load, then the CTA barrier). A wait past kBarrierTimeoutNs traps
// (a launch error at the next synchronize, not a hung card).
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter)
                 : "memory");
    unsigned seen;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(seen)
                 : "l"(counter)
                 : "memory");
    if (seen < target) {
      const unsigned long long start = global_ns();
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen)
                     : "l"(counter)
                     : "memory");
        if (global_ns() - start > kBarrierTimeoutNs) __trap();
      } while (seen < target);
    }
  }
  __syncthreads();
}

// `rows` rows of `row_bytes` (a multiple of 16) from the exchange buffer
// (rows back to back) into shared memory rows `dst_stride` bytes apart,
// through L2 (ld.global.cg): the buffer is written during the launch.
__device__ __forceinline__ void stage_rows(const unsigned char* src,
                                           unsigned char* dst, int rows,
                                           int row_bytes, int dst_stride) {
  const int per_row = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = i - r * per_row;
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(
                               src + (long long)r * row_bytes) + c);
    *reinterpret_cast<uint4*>(dst + (long long)r * dst_stride + c * 16) = v;
  }
}

// ---------------------------------------------------------------------------
// Shared memory layouts, mirrored by kernels/slstm_scan.py (shared_bytes)
// ---------------------------------------------------------------------------

// Elements of a row of the exchange buffer.
__host__ __device__ __forceinline__ int fwd_exchange_stride(int d) {
  return round_up(d, 8);
}
__host__ __device__ __forceinline__ int bwd_exchange_stride(int d) {
  return 4 * d;
}

struct Layout {
  int r_stride;     // elements between R's rows (or columns) in shared memory
  int x_stride;     // elements between the staged exchange rows
  int cols;         // columns of a partial sum row
  long long r_off, x_off, part_off, bytes;
};

// Forward. bf16: R's 4U columns (padded to n-tiles of 8) as rows of
// round_up(d, 16) + 8 elements (k contiguous; the 8 spread the banks), the
// h tile as 16 such rows. float32: R [d][4U] (column contiguous), the h
// tile [rows][round_up(d, 8)]. Then the warps' partial sums
// [warps][rows][cols] float32.
__host__ __device__ inline Layout fwd_layout(bool bf16, int d, int U,
                                             int rows) {
  Layout l;
  if (bf16) {
    l.r_stride = round_up(d, 16) + 8;
    l.x_stride = l.r_stride;
    l.cols = round_up(4 * U, 8);
    l.r_off = 0;
    l.x_off = 2LL * l.cols * l.r_stride;
    l.part_off = l.x_off + 2LL * kRowTile * l.x_stride;
  } else {
    l.r_stride = 4 * U;
    l.x_stride = fwd_exchange_stride(d);
    l.cols = 4 * U;
    l.r_off = 0;
    l.x_off = 4LL * d * 4 * U;
    l.part_off = l.x_off + 4LL * rows * l.x_stride;
  }
  l.bytes = l.part_off + 4LL * kWarps * rows * l.cols;
  return l;
}

// Backward. bf16: R's U rows (padded to 8) of round_up(4d, 16) + 8
// elements, the round(dpre) tile as 16 such rows, the partial sums
// [warps][rows][8] in double. float32: R's U rows of 4d + 4 floats (the 4
// spreads the banks), the tile [rows][4d], the partial sums
// [warps][rows][8] float32.
__host__ __device__ inline Layout bwd_layout(bool bf16, int d, int U,
                                             int rows) {
  Layout l;
  l.cols = kMaxUnits;
  if (bf16) {
    l.r_stride = round_up(4 * d, 16) + 8;
    l.x_stride = l.r_stride;
    l.r_off = 0;
    l.x_off = 2LL * kMaxUnits * l.r_stride;
    l.part_off = l.x_off + 2LL * kRowTile * l.x_stride;
  } else {
    l.r_stride = 4 * d + 4;
    l.x_stride = bwd_exchange_stride(d);
    l.r_off = 0;
    l.x_off = 4LL * U * l.r_stride;
    l.part_off = l.x_off + 4LL * rows * l.x_stride;
  }
  l.bytes = l.part_off + (bf16 ? 8LL : 4LL) * kWarps * rows * l.cols;
  return l;
}

__device__ __forceinline__ void zero_shared(unsigned char* smem,
                                            long long bytes) {
  for (long long i = threadIdx.x * 16LL; i < bytes; i += kThreads * 16LL) {
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// The products: each warp's partial sums into part[warp][row][col]
// ---------------------------------------------------------------------------

// Forward bf16: [16, Kp] h tile x R's columns [cols, Kp]; the k-steps of
// 16 dealt to the warps in turn, each block's product from zero and added
// to the warp's sums with FADD.
__device__ __forceinline__ void fwd_product(const __nv_bfloat16* hsm,
                                            const __nv_bfloat16* rs,
                                            float* part, const Layout& l,
                                            int d, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int ksteps = round_up(d, 16) / 16, nt = l.cols / 8;
  const int ks = l.x_stride;
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  for (int kk = warp; kk < ksteps; kk += kWarps) {
    const int k = kk * 16 + 2 * tg;
    const uint32_t a0 = ld_pair(hsm + g * ks + k);
    const uint32_t a1 = ld_pair(hsm + (g + 8) * ks + k);
    const uint32_t a2 = ld_pair(hsm + g * ks + k + 8);
    const uint32_t a3 = ld_pair(hsm + (g + 8) * ks + k + 8);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n < nt) {
        const __nv_bfloat16* rb = rs + (n * 8 + g) * l.r_stride + k;
        float blk[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(blk, a0, a1, a2, a3, ld_pair(rb), ld_pair(rb + 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += blk[i];
      }
    }
  }
  float* pw = part + warp * rows * l.cols;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (n < nt) {
      const int col = n * 8 + 2 * tg;
      pw[g * l.cols + col] = acc[n][0];
      pw[g * l.cols + col + 1] = acc[n][1];
      pw[(g + 8) * l.cols + col] = acc[n][2];
      pw[(g + 8) * l.cols + col + 1] = acc[n][3];
    }
  }
}

// f(std::integral_constant<int, nr>()) for the tile's runtime row count
// 1 <= nr <= NR: the FFMA products' row loops have a compile-time length,
// so no row past nr issues (a predicated-off shared load still holds its
// FFMA for the load's latency).
template <int NR, typename F>
__device__ __forceinline__ void with_rows(int nr, F&& f) {
  if constexpr (NR > 1) {
    if (nr < NR) {
      with_rows<NR - 1>(nr, f);
      return;
    }
  }
  f(std::integral_constant<int, NR>());
}

// Forward float32: lane = column (4U of 32), the d rows of R cut into
// eight even slices, one a warp; each lane keeps a sum for each of the
// tile's NR rows, loading a k pair's h of every row before the FFMAs.
template <int NR>
__device__ __forceinline__ void fwd_product(const float* hsm, const float* rs,
                                            float* part, const Layout& l,
                                            int d, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = l.cols;
  const int kc = round_up((d + kWarps - 1) / kWarps, 2);
  const int kb = warp * kc, ke = min(d, kb + kc);
  if (lane >= cols) return;
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  for (int k = kb; k < ke; k += 2) {
    const float r0 = rs[k * cols + lane], r1 = rs[(k + 1) * cols + lane];
    float2 h[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      h[r] = *reinterpret_cast<const float2*>(hsm + r * l.x_stride + k);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      acc[r] = fmaf(h[r].x, r0, acc[r]);
      acc[r] = fmaf(h[r].y, r1, acc[r]);
    }
  }
  float* pw = part + warp * rows * cols;
#pragma unroll
  for (int r = 0; r < NR; ++r) pw[r * cols + lane] = acc[r];
}

// Backward bf16, exactly rounded: lanes as the float32 backward's; each
// product of two bf16 values is exact in float, each lane sums its share
// in double, the quarters by two shuffles and the warps' partial sums in
// double too, so the recurrent gradient is its exact sum rounded to bf16
// once, whatever the order.
template <int NR>
__device__ __forceinline__ void bwd_product(const __nv_bfloat16* dsm,
                                            const __nv_bfloat16* rs,
                                            double* part, const Layout& l,
                                            int d, int rows, int nu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u = lane >> 2, q = lane & 3;
  const int d4 = 4 * d;
  const int kc = round_up((d4 + kWarps - 1) / kWarps, 4);
  const int kb = warp * kc, ke = min(d4, kb + kc);
  double acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.0;
  if (u < nu) {
    const __nv_bfloat16* ru = rs + u * l.r_stride;
    for (int k = kb + q; k < ke; k += 4) {
      const float rv = __bfloat162float(ru[k]);
      float x[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        x[r] = __bfloat162float(dsm[r * l.x_stride + k]);
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] += static_cast<double>(x[r] * rv);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
  }
  double* pw = part + warp * rows * l.cols;
  if (q == 0 && u < nu) {
#pragma unroll
    for (int r = 0; r < NR; ++r) pw[r * l.cols + u] = acc[r];
  }
}

// Backward float32: lane = (unit lane / 4, a quarter lane % 4) over the 4d
// columns cut into eight slices, one a warp, loading a column's values of
// the tile's NR rows before the FFMAs; the quarters are summed by two
// shuffles.
template <int NR>
__device__ __forceinline__ void bwd_product(const float* dsm, const float* rs,
                                            float* part, const Layout& l,
                                            int d, int rows, int nu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u = lane >> 2, q = lane & 3;
  const int d4 = 4 * d;
  const int kc = round_up((d4 + kWarps - 1) / kWarps, 4);
  const int kb = warp * kc, ke = min(d4, kb + kc);
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  if (u < nu) {
    const float* ru = rs + u * l.r_stride;
    for (int k = kb + q; k < ke; k += 4) {
      const float rv = ru[k];
      float x[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) x[r] = dsm[r * l.x_stride + k];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = fmaf(x[r], rv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
  }
  float* pw = part + warp * rows * l.cols;
  if (q == 0 && u < nu) {
#pragma unroll
    for (int r = 0; r < NR; ++r) pw[r * l.cols + u] = acc[r];
  }
}

// The warps' partial sums of (row r, column col), in warp order.
template <typename P>
__device__ __forceinline__ P sum_parts(const P* part, int rows, int cols,
                                       int r, int col) {
  P s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[(w * rows + r) * cols + col];
  return s;
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

// xbuf: two buffers [batch][fwd_exchange_stride(d)] of round(h) in T, zeroed
// by the wrapper (the padding stays zero); counter zeroed by the wrapper.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_fwd(const float* __restrict__ pre_x, const T* __restrict__ R,
              const float* __restrict__ carry0, float* __restrict__ hs,
              float* __restrict__ carry, float* __restrict__ pre_save,
              float* __restrict__ st_save, T* xbuf, unsigned* counter,
              int batch, int S, int d, int U, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  const Layout l = fwd_layout(kBf16, d, U, rows);
  T* rs = reinterpret_cast<T*>(smem + l.r_off);
  T* xsm = reinterpret_cast<T*>(smem + l.x_off);
  float* part = reinterpret_cast<float*>(smem + l.part_off);
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U, nu = min(U, d - u0);
  const int d4 = 4 * d, xs = fwd_exchange_stride(d);
  const long long bd = (long long)batch * d;
  const long long bsd = (long long)batch * S * d;
  const long long buf = (long long)batch * xs;

  zero_shared(smem, l.bytes);
  __syncthreads();
  // R's columns g d + u0 + u, u < nu, of every row k
  for (int i = tid; i < d * 4 * U; i += kThreads) {
    const int k = i / (4 * U), n = i - k * 4 * U;
    const int gate = n / U, u = n - gate * U;
    if (u < nu) {
      const T v = R[(long long)k * d4 + gate * d + u0 + u];
      if (kBf16) {
        rs[n * l.r_stride + k] = v;
      } else {
        rs[k * l.r_stride + n] = v;
      }
    }
  }
  // the carry: state into the output carry (this thread's elements alone
  // read and write them), round(h0) into buffer 1 (step 0 reads (0-1) mod 2)
  for (int b0 = 0; b0 < batch; b0 += rows) {
    const int nr = min(rows, batch - b0);
    if (tid < nr * nu) {
      const int b = b0 + tid / nu, j = u0 + tid % nu;
      const long long at = (long long)b * d + j;
      carry[at] = carry0[at];
      carry[bd + at] = carry0[bd + at];
      carry[3 * bd + at] = carry0[3 * bd + at];
      xbuf[buf + (long long)b * xs + j] = to_t<T>(carry0[2 * bd + at]);
    }
  }
  unsigned phase = 1;
  grid_barrier(counter, phase * gridDim.x);

  for (int t = 0; t < S; ++t) {
    const T* hin = xbuf + ((t + 1) & 1) * buf;
    T* hout = xbuf + (t & 1) * buf;
    for (int b0 = 0; b0 < batch; b0 += rows) {
      const int nr = min(rows, batch - b0);
      const bool mine = tid < nr * nu;
      const int r = mine ? tid / nu : 0, u = mine ? tid % nu : 0;
      const int b = b0 + r, j = u0 + u;
      const long long at = (long long)b * d + j;
      const long long step = (long long)b * S + t;
      float px[4], c = 0.f, n = 0.f, m = 0.f;
      if (mine) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          px[gate] = __ldg(pre_x + step * d4 + gate * d + j);
        c = carry[at];
        n = carry[bd + at];
        m = carry[3 * bd + at];
      }
      stage_rows(
          reinterpret_cast<const unsigned char*>(hin + b0 * (long long)xs),
          reinterpret_cast<unsigned char*>(xsm), nr, xs * (int)sizeof(T),
          l.x_stride * (int)sizeof(T));
      __syncthreads();
      if constexpr (kBf16) {
        fwd_product(xsm, rs, part, l, d, rows);
      } else {
        with_rows<kRowTile>(nr, [&](auto tile_rows) {
          fwd_product<decltype(tile_rows)::value>(xsm, rs, part, l, d, rows);
        });
      }
      __syncthreads();
      if (mine) {
        float pre[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          pre[gate] = px[gate] + round_to<T>(sum_parts(part, rows, l.cols, r,
                                                       gate * U + u));
        const float z = tanhf(pre[0]);
        const float o = sigmoid(pre[3]);
        const float logf_ = log_sigmoid(pre[2]);
        const float pi = pre[1];
        const float m_new = fmaxf(logf_ + m, pi);
        const float iw = expf(pi - m_new);
        const float fw = expf(logf_ + m - m_new);
        c = __fadd_rn(__fmul_rn(fw, c), __fmul_rn(iw, z));
        n = __fadd_rn(__fmul_rn(fw, n), iw);
        m = m_new;
        const float h = o * (c / fmaxf(n, expf(-m_new) + 1e-6f));
        hs[step * d + j] = h;
        hout[(long long)b * xs + j] = to_t<T>(h);
        carry[at] = c;
        carry[bd + at] = n;
        carry[3 * bd + at] = m;
        if (t == S - 1) carry[2 * bd + at] = h;
        if (pre_save != nullptr) {
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            pre_save[step * d4 + gate * d + j] = pre[gate];
        }
        if (st_save != nullptr) {
          st_save[step * d + j] = c;
          st_save[bsd + step * d + j] = n;
          st_save[2 * bsd + step * d + j] = m;
        }
      }
    }
    if (t + 1 < S) grid_barrier(counter, ++phase * gridDim.x);
  }
}

// xbuf: two buffers [batch][4d] of round(dpre) in T; counter zeroed by the
// wrapper. dcarry0 [4][batch][d] holds the running (dc, dn, dh, dm).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_bwd(const float* __restrict__ pre, const float* __restrict__ st,
              const T* __restrict__ R, const float* __restrict__ carry0,
              const float* __restrict__ dhs, const float* __restrict__ dlast,
              float* __restrict__ dpre, float* __restrict__ dcarry0,
              T* xbuf, unsigned* counter, int batch, int S, int d, int U,
              int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  const Layout l = bwd_layout(kBf16, d, U, rows);
  T* rs = reinterpret_cast<T*>(smem + l.r_off);
  T* xsm = reinterpret_cast<T*>(smem + l.x_off);
  using Acc = std::conditional_t<kBf16, double, float>;
  Acc* part = reinterpret_cast<Acc*>(smem + l.part_off);
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U, nu = min(U, d - u0);
  const int d4 = 4 * d, xs = bwd_exchange_stride(d);
  const long long bd = (long long)batch * d;
  const long long bsd = (long long)batch * S * d;
  const long long buf = (long long)batch * xs;

  zero_shared(smem, l.bytes);
  __syncthreads();
  // R's rows u0 + u, u < nu
  for (int i = tid; i < nu * d4; i += kThreads) {
    const int u = i / d4, k = i - u * d4;
    rs[u * l.r_stride + k] = R[(long long)(u0 + u) * d4 + k];
  }
  // the last carry's gradient (zeros when dlast is NULL) as the running state
  for (int b0 = 0; b0 < batch; b0 += rows) {
    const int nr = min(rows, batch - b0);
    if (tid < nr * nu) {
      const long long at = (long long)(b0 + tid / nu) * d + u0 + tid % nu;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        dcarry0[p * bd + at] = dlast != nullptr ? dlast[p * bd + at] : 0.f;
    }
  }
  unsigned phase = 0;

  for (int t = S - 1; t >= 0; --t) {
    T* xout = xbuf + (t & 1) * buf;
    // dpre_t of this block's elements
    for (int b0 = 0; b0 < batch; b0 += rows) {
      const int nr = min(rows, batch - b0);
      if (tid >= nr * nu) continue;
      const int b = b0 + tid / nu, j = u0 + tid % nu;
      const long long at = (long long)b * d + j;
      const long long step = (long long)b * S + t;
      const float pz = pre[step * d4 + j], pi = pre[step * d4 + d + j];
      const float pf = pre[step * d4 + 2 * d + j];
      const float po = pre[step * d4 + 3 * d + j];
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

      const float dh = dhs[step * d + j] + dcarry0[2 * bd + at];
      const float d_o = dh * q;
      const float dq = dh * o;
      const float dc1 = dcarry0[at] + dq / den;
      const float dden = -dq * c1 / (den * den);
      const float dn1 =
          __fadd_rn(dcarry0[bd + at], __fmul_rn(dden, max_share(n1, floor_)));
      float dm1 = __fsub_rn(
          dcarry0[3 * bd + at],
          __fmul_rn(__fmul_rn(dden, max_share(floor_, n1)), ex));
      const float dfw = __fadd_rn(__fmul_rn(dn1, n0), __fmul_rn(dc1, c0));
      const float diw = __fadd_rn(dn1, __fmul_rn(dc1, z));
      const float dz = dc1 * iw;
      float dpi = diw * iw;
      dm1 = __fsub_rn(dm1, __fmul_rn(diw, iw));
      const float dfa = dfw * fw;  // dL/d(f + m - m')
      dm1 -= dfa;
      const float fm = lf + m0;
      const float dA = dm1 * max_share(fm, pi);
      dpi = __fadd_rn(dpi, __fmul_rn(dm1, max_share(pi, fm)));
      const float dlf = dfa + dA;
      const float dm0 = dfa + dA;
      // log_sigmoid's derivative, sigmoid(-pf), as the plain version has it
      const float dpf = dlf * (1.f / (1.f + expf(pf)));
      const float dpo = d_o * (1.f - o) * o;
      const float dpz = dz * __fsub_rn(1.f, __fmul_rn(z, z));

      dpre[step * d4 + j] = dpz;
      dpre[step * d4 + d + j] = dpi;
      dpre[step * d4 + 2 * d + j] = dpf;
      dpre[step * d4 + 3 * d + j] = dpo;
      T* xo = xout + (long long)b * xs + j;
      xo[0] = to_t<T>(dpz);
      xo[d] = to_t<T>(dpi);
      xo[2 * d] = to_t<T>(dpf);
      xo[3 * d] = to_t<T>(dpo);
      dcarry0[at] = dc1 * fw;
      dcarry0[bd + at] = dn1 * fw;
      dcarry0[3 * bd + at] = dm0;
    }
    grid_barrier(counter, ++phase * gridDim.x);
    // dL/dh_{t-1} of this block's units = round(round(dpre_t) R[J_j]^T)
    for (int b0 = 0; b0 < batch; b0 += rows) {
      const int nr = min(rows, batch - b0);
      stage_rows(reinterpret_cast<const unsigned char*>(
                     xout + b0 * (long long)xs),
                 reinterpret_cast<unsigned char*>(xsm), nr,
                 xs * (int)sizeof(T), l.x_stride * (int)sizeof(T));
      __syncthreads();
      with_rows<kRowTile>(nr, [&](auto tile_rows) {
        bwd_product<decltype(tile_rows)::value>(xsm, rs, part, l, d, rows,
                                                nu);
      });
      __syncthreads();
      if (tid < nr * nu) {
        const int r = tid / nu, u = tid % nu;
        const long long at = (long long)(b0 + r) * d + u0 + u;
        dcarry0[2 * bd + at] =
            round_sum<T>(sum_parts(part, rows, l.cols, r, u));
      }
    }
  }
}

template <typename T>
long long smem_bytes(int direction, int d, int U, int rows) {
  const bool bf16 = sizeof(T) == 2;
  return direction == 0 ? fwd_layout(bf16, d, U, rows).bytes
                        : bwd_layout(bf16, d, U, rows).bytes;
}

template <typename T>
void* kernel_of(int direction) {
  return direction == 0 ? reinterpret_cast<void*>(slstm_fwd<T>)
                        : reinterpret_cast<void*>(slstm_bwd<T>);
}

bool plan_ok(int d, int U, int rows, int r_dtype) {
  return d >= 2 && d <= kMaxD && d % 2 == 0 && U >= 1 && U <= kMaxUnits &&
         rows >= 1 && rows <= kRowTile && (r_dtype == 0 || rows == kRowTile);
}

// Shared bytes of the plan, the attribute set for them, and the blocks an
// SM holds at once (the occupancy calculator).
template <typename T>
int prepare(int direction, int d, int U, int rows, long long* smem,
            int* per_sm) {
  *smem = smem_bytes<T>(direction, d, U, rows);
  if (*smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  void* kern = kernel_of<T>(direction);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm == nullptr) return 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kern, kThreads, static_cast<size_t>(*smem)));
}

template <typename T>
int launch(int direction, void** args, int d, int U, int rows,
           cudaStream_t stream) {
  long long smem = 0;
  const int e = prepare<T>(direction, d, U, rows, &smem, nullptr);
  if (e != 0) return e;
  const int blocks = (d + U - 1) / U;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel_of<T>(direction), dim3(blocks), dim3(kThreads), args,
      static_cast<size_t>(smem), stream));
}

}  // namespace

// The plan's shared bytes (*smem) and the blocks of the kernel an SM holds
// at once (*per_sm); direction 0 forward, 1 backward; r_dtype 0 float32,
// 1 bfloat16.
extern "C" int repro_slstm_scan_resident(int direction, int r_dtype, int d,
                                         int units, int rows,
                                         long long* smem, int* per_sm) {
  if (!plan_ok(d, units, rows, r_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return r_dtype == 0
             ? prepare<float>(direction, d, units, rows, smem, per_sm)
             : prepare<__nv_bfloat16>(direction, d, units, rows, smem,
                                      per_sm);
}

// carry0 / carry [4, batch, d] as (c, n, h, m); pre_save [batch, S, 4d] and
// st_save [3, batch, S, d] may be NULL (no gradient wanted). scratch: the
// barrier's counter (16 bytes) then two exchange buffers [batch][round_up(d,
// 8)] in R's dtype, all zeroed. d even, d <= 1024; units U <= 8 a block,
// ceil(d / U) blocks; rows a tile (16 in bf16). R and pre_x 16-byte aligned.
extern "C" int repro_slstm_scan_fwd(const float* pre_x, const void* R,
                                    const float* carry0, float* hs,
                                    float* carry, float* pre_save,
                                    float* st_save, void* scratch, int batch,
                                    int S, int d, int units, int rows,
                                    int r_dtype, void* stream) {
  if (!plan_ok(d, units, rows, r_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* counter = static_cast<unsigned*>(scratch);
  void* xbuf = static_cast<unsigned char*>(scratch) + kCounterBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0) {
    const float* r = static_cast<const float*>(R);
    float* xb = static_cast<float*>(xbuf);
    void* args[] = {&pre_x, &r, &carry0, &hs, &carry, &pre_save, &st_save,
                    &xb, &counter, &batch, &S, &d, &units, &rows};
    return launch<float>(0, args, d, units, rows, s);
  }
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(R);
  __nv_bfloat16* xb = static_cast<__nv_bfloat16*>(xbuf);
  void* args[] = {&pre_x, &r, &carry0, &hs, &carry, &pre_save, &st_save,
                  &xb, &counter, &batch, &S, &d, &units, &rows};
  return launch<__nv_bfloat16>(0, args, d, units, rows, s);
}

// dlast [4, batch, d] (the last carry's gradient) may be NULL; dcarry0 is
// the initial carry's [4, batch, d]. scratch: the counter (16 bytes) then
// two exchange buffers [batch][4d] in R's dtype, the counter zeroed.
extern "C" int repro_slstm_scan_bwd(const float* pre, const float* st,
                                    const void* R, const float* carry0,
                                    const float* dhs, const float* dlast,
                                    float* dpre, float* dcarry0,
                                    void* scratch, int batch, int S, int d,
                                    int units, int rows, int r_dtype,
                                    void* stream) {
  if (!plan_ok(d, units, rows, r_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* counter = static_cast<unsigned*>(scratch);
  void* xbuf = static_cast<unsigned char*>(scratch) + kCounterBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0) {
    const float* r = static_cast<const float*>(R);
    float* xb = static_cast<float*>(xbuf);
    void* args[] = {&pre, &st, &r, &carry0, &dhs, &dlast, &dpre, &dcarry0,
                    &xb, &counter, &batch, &S, &d, &units, &rows};
    return launch<float>(1, args, d, units, rows, s);
  }
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(R);
  __nv_bfloat16* xb = static_cast<__nv_bfloat16*>(xbuf);
  void* args[] = {&pre, &st, &r, &carry0, &dhs, &dlast, &dpre, &dcarry0,
                  &xb, &counter, &batch, &S, &d, &units, &rows};
  return launch<__nv_bfloat16>(1, args, d, units, rows, s);
}
