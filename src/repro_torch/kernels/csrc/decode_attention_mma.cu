// Decode attention (one query per head against a KV cache) for NVIDIA
// Hopper (sm_90a), bfloat16 on the tensor cores: the "mma" design of
// kernels/decode_attention.py. float32 keeps the FFMA design in
// decode_attention.cu.
//
// Replaces the TPU kernel `decode_attention` (body `_decode_kernel`) of
// src/repro/kernels/decode_attention.py for bfloat16 operands:
//
//     o[b,h] = sum_{j < length[b]} softmax_j(cap*tanh((q_bh . k_j) * D^-0.5 / cap)) v_j
//
// with q [B,H,1,D], k/v [B,KV,S,D], KV head of query head h = h / (H/KV)
// (GQA), running (max, sum, acc) in float32, zeros for length = 0, and
// out = acc / max(l, 1e-30).
//
// Bound: bytes. Each cache element read feeds 2*G flops (G = H/KV query
// heads per KV head), far below the card's flops-per-byte ridge, so the
// kernel can at best stream the valid part of the cache once at the
// memory's rate. What keeps a decode kernel from that rate is instruction
// issue (every byte has to be converted, multiplied and summed by some
// thread) and too few bytes in flight. What the design does about both:
//   * tensor cores for both products, to take the arithmetic off the
//     issue ports: the G <= 16 query heads of one KV head are the 16 rows
//     of an mma.sync m16n8k16 tile (rows past G are zero and never
//     stored). S = Q.K^T takes Q and K fragments by ldmatrix; P stays in
//     registers as the A fragment of P.V (the accumulator fragment of S
//     is the A fragment of P.V); V comes by ldmatrix.trans. P is rounded
//     to bf16 for P.V, as the flash kernels do: each term of P.V then
//     carries a relative error of at most 2^-9, while the row sums l use
//     the float32 P;
//   * each warp owns every fourth tile (32 cache slots; 16 at D = 256) of
//     the block's part of the cache and its own (m, l, O), and streams its
//     tiles through its own ring of shared memory stages by 16-byte
//     cp.async: no block barrier inside the loop, only __syncwarp. The
//     four warps merge once at the end of the block. At D = 64, the
//     models' width, the ring has five stages, so each warp keeps four
//     tiles (32 KB of K and V) in flight, 128 KB per SM; that takes the
//     SM's shared memory, so one block is resident per SM (kBlocksPerSm,
//     which the occupancy calculator confirms for split_plan);
//   * one block per (batch, KV head, split of the cache): the G query
//     heads share every K/V tile, which is loaded from device memory once
//     (the TPU kernel's grid is per query head). The splits are a balanced
//     partition of the cache's tiles, chosen by split_plan in
//     kernels/decode_attention.py: the fewest whose B*KV*splits blocks
//     fill whole waves of kBlocksPerSm x SMs to 95 %;
//   * the splits are combined inside the same launch: each block writes
//     its partial (m, l, acc), and the last block of its (batch, KV head)
//     to arrive (a counter in device memory, which that block sets back
//     to 0, so no memset is needed and the launch can be replayed in a
//     CUDA graph) combines them and writes the output;
//   * each warp stops at length[b]: slots from length on are neither read
//     nor masked; `length` is read on the device (a scalar broadcast or a
//     [B] vector), so a decode step never waits on the host;
//   * element strides for batch, head and sequence (unit stride on D): the
//     model hands its [B,S,KV,D] cache as a transposed view, no copy.
//
// Plain C interface (loaded with ctypes); the launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;        // the mma's M: query heads of a KV head
constexpr int kMaxGroup = 16;
constexpr int kMaxSplits = 256;  // the combine keeps [kRows][splits] weights
constexpr int kSmemPerSm = 233472;  // 228 KB
constexpr int kSmemPerBlockReserved = 1024;

template <int D>
struct Cfg {
  // Cache slots a warp takes in one step (the unit of a split): 32, or 16
  // at D = 256, where three stages of 32 slots would not fit.
  static constexpr int kTile = D == 256 ? 16 : 32;
  // Stages of each warp's ring, and the resident blocks per SM that the
  // shared memory they take leaves (the register budget __launch_bounds__
  // gives follows from it). At D >= 64 one block per SM, whose four warps
  // keep 4 (2 at D >= 128) tiles each in flight, streams the SM's share of
  // the memory rate; a second resident block would only add its fixed
  // costs (first loads, merge, combine).
  static constexpr int kStages = D == 16 ? 8 : (D <= 64 ? 5 : 3);
  static constexpr int kBlocksPerSm = D <= 32 ? 2 : 1;
  // Rows padded by 16 bytes: ldmatrix's 8 row addresses of 16 bytes fall
  // in distinct banks.
  static constexpr int LD = D + 8;
  static constexpr int kOperand = kTile * LD;          // one K or V tile
  static constexpr int kWarpRing = kStages * 2 * kOperand;
  // Q, then each warp's ring (elements of bf16).
  static constexpr int kSmem =
      (kRows * LD + kWarps * kWarpRing) * static_cast<int>(sizeof(bf16));
  static_assert(kBlocksPerSm * (kSmem + kSmemPerBlockReserved) <= kSmemPerSm &&
                    (kBlocksPerSm + 1) * (kSmem + kSmemPerBlockReserved) >
                        kSmemPerSm,
                "shared memory must give exactly kBlocksPerSm blocks per SM");
  // The merge reuses the ring: (m, l) and O of each warp.
  static constexpr int kMergeFloats = kWarps * 2 * kRows + kWarps * kRows * D;
  static_assert(kMergeFloats * 4 <= kSmem, "merge scratch");
  static_assert((2 * kRows * kMaxSplits + kRows) * 4 <= kSmem,
                "combine scratch");
};

struct Strides {
  long long b, h, s;  // elements; D has unit stride
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* length;
  long long length_stride;  // 0: one length for the batch; 1: [B]
  Strides sq, sk, sv;
  long long o_b, o_h;
  float* part_m;    // [B*H, splits], log2 domain
  float* part_l;    // [B*H, splits]
  float* part_acc;  // [B*H, splits, D]
  int* counters;    // [B*KV], 0 between launches
  int heads, kv_heads, group, len_s, tiles, splits;
  float scale_log2;  // D^-0.5 * log2 e
  float cap_inv;     // D^-0.5 / softcap
  float cap_log2;    // softcap * log2 e; <= 0: no softcap
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void store_bf16x4(bf16* dst, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// The splits' partials of (batch b, KV head kvh) into its G output rows:
// o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with w_s = 2^(m_s - max
// m) over the splits that saw a slot (an empty split has l = 0 and
// acc = 0). Reads the partials from L2 (other blocks wrote them), each
// once; `smem` holds [kRows][kMaxSplits] of m (then the weights) and of l,
// and kRows reciprocals.
template <int D>
__device__ __forceinline__ void combine_splits(const Params& p, int b, int kvh,
                                               float* smem) {
  constexpr int D4 = D / 4;
  const int G = p.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(b) * p.heads + kvh * G;
  float* sW = smem;                       // [kRows][kMaxSplits]
  float* sL = sW + kRows * kMaxSplits;     // [kRows][kMaxSplits]
  float* sInv = sL + kRows * kMaxSplits;   // [kRows]
  for (int row = warp; row < G; row += kWarps) {
    const float* pm = p.part_m + (row0 + row) * p.splits;
    const float* pl = p.part_l + (row0 + row) * p.splits;
    float* wrow = sW + row * kMaxSplits;
    float* lrow = sL + row * kMaxSplits;
    float mx = kNegInf;
    for (int s = lane; s < p.splits; s += 32) {
      const float ms = __ldcg(pm + s);
      const float ls = __ldcg(pl + s);
      wrow[s] = ms;
      lrow[s] = ls;
      if (ls > 0.f) mx = fmaxf(mx, ms);
    }
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < p.splits; s += 32) {  // this lane's own entries
      const float w = lrow[s] > 0.f ? ex2(wrow[s] - mx) : 0.f;
      wrow[s] = w;
      den += w * lrow[s];
    }
    den = warp_sum(den);
    if (lane == 0) sInv[row] = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < G * D4; c += kThreads) {
    const int row = c / D4;
    const int col = (c - row * D4) * 4;
    const float4* src = reinterpret_cast<const float4*>(
        p.part_acc + (row0 + row) * p.splits * D + col);
    const float* w = sW + row * kMaxSplits;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < p.splits; ++s) {
      const float4 x = __ldcg(src + s * D4);
      o.x += w[s] * x.x;
      o.y += w[s] * x.y;
      o.z += w[s] * x.z;
      o.w += w[s] * x.w;
    }
    const float inv = sInv[row];
    store_bf16x4(p.o + b * p.o_b + (kvh * G + row) * p.o_h + col,
                 make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
  }
}

// Fragment layouts of mma.m16n8k16 (lane = 4g + t): A holds rows g, g+8 at
// columns 2t, 2t+1 (+8); B holds k rows 2t, 2t+1 (+8) at column g; C holds
// rows g, g+8 at columns 2t, 2t+1. Rows are query heads, S's columns are
// the tile's cache slots (kTile / 8 n8 tiles), O's columns the head dim.
template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kBlocksPerSm)
decode_mma_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int LD = C::LD;
  constexpr int NS = C::kStages;
  constexpr int KQ = D / 16;         // k-steps of Q.K^T
  constexpr int kTile = C::kTile;
  constexpr int NT = kTile / 8;      // 8-slot column tiles of S
  constexpr int KP = kTile / 16;     // k-steps of P.V
  constexpr int DT = D / 8;          // 8-wide column tiles of O
  constexpr int kPacks = D / 8;      // 16-byte packs per row
  constexpr int D4 = D / 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]

  const int split = blockIdx.x;
  const int bk = blockIdx.y;
  const int b = bk / p.kv_heads;
  const int kvh = bk - b * p.kv_heads;
  const int G = p.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row half of a fragment
  const int t = lane & 3;   // column pair within a fragment

  // This split's slots: tiles [t0, t1) of the balanced partition, cut at
  // the valid length. Warp w takes the split's tiles w, w + 4, ...
  const int len = min(max(p.length[b * p.length_stride], 0), p.len_s);
  const int t0 = static_cast<int>(static_cast<long long>(split) * p.tiles /
                                  p.splits);
  const int t1 = static_cast<int>(static_cast<long long>(split + 1) *
                                  p.tiles / p.splits);
  const int s_begin = t0 * kTile;
  const int s_end = min(t1 * kTile, len);
  const int n_tiles = s_begin < s_end ? (s_end - s_begin + kTile - 1) / kTile
                                      : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  const bf16* k = p.k + b * p.sk.b + kvh * p.sk.h;
  const bf16* v = p.v + b * p.sv.b + kvh * p.sv.h;
  bf16* ring = sQ + kRows * LD + warp * C::kWarpRing;

  // The warp's i-th tile into stage i % NS; rows past s_end zero-filled.
  auto load = [&](int i) {
    const int n0 = s_begin + (warp + i * kWarps) * kTile;
    const int valid = min(kTile, s_end - n0);
    bf16* dk = ring + (i % NS) * 2 * C::kOperand;
    bf16* dv = dk + C::kOperand;
#pragma unroll
    for (int it = 0; it < kTile * kPacks / 32; ++it) {
      const int c = lane + 32 * it;
      const int r = c / kPacks;
      const int col = (c - r * kPacks) * 8;
      const bool ok = r < valid;
      const long long slot = ok ? n0 + r : 0;
      cp_async16(dk + r * LD + col, k + slot * p.sk.s + col, ok);
      cp_async16(dv + r * LD + col, v + slot * p.sv.s + col, ok);
    }
  };

  // Q rows of this KV head's G query heads (rows G..15 are zeros), loaded
  // before the K/V copies are issued: behind them, Q would arrive only
  // once the memory had served every warp's first tiles, and no warp could
  // start.
  constexpr int kQPacks = (kRows * kPacks + kThreads - 1) / kThreads;
  const bf16* q = p.q + b * p.sq.b + static_cast<long long>(kvh) * G * p.sq.h;
  uint4 qv[kQPacks];
#pragma unroll
  for (int i = 0; i < kQPacks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kPacks;
    const int col = (c - r * kPacks) * 8;
    qv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < kRows * kPacks && r < G) {
      qv[i] = *reinterpret_cast<const uint4*>(q + r * p.sq.h + col);
    }
  }

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < mine) load(i);
    async_commit();
  }

#pragma unroll
  for (int i = 0; i < kQPacks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kPacks;
    const int col = (c - r * kPacks) * 8;
    if (c < kRows * kPacks) *reinterpret_cast<uint4*>(sQ + r * LD + col) = qv[i];
  }
  __syncthreads();

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const bf16* qrow = sQ + (lane & 15) * LD + (lane >> 4) * 8;
  const int krow = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int vrow = (lane & 15) * LD + (lane >> 4) * 8;

  for (int i = 0; i < mine; ++i) {
    async_wait<NS - 2>();
    __syncwarp();  // tile i visible to the warp; stage (i - 1) % NS read
    if (i + NS - 1 < mine) load(i + NS - 1);
    async_commit();
    const bf16* tK = ring + (i % NS) * 2 * C::kOperand;
    const bf16* tV = tK + C::kOperand;
    const int valid = min(kTile, s_end - (s_begin + (warp + i * kWarps) * kTile));

    // S = Q K^T: 16 heads x kTile slots, two 8-slot column tiles per
    // ldmatrix of K.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qrow + kk * 16);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk4[4];
        ldmatrix_x4(bk4, tK + krow + j * 8 * LD + kk * 16);
        mma_bf16(s[j], a, bk4[0], bk4[1]);
        mma_bf16(s[j + 1], a, bk4[2], bk4[3]);
      }
    }

    // Logits in the log2 domain, softcap if any; slots past the valid end
    // of the last tile masked.
    if (p.cap_log2 > 0.f) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = p.cap_log2 * tanhf(s[j][e] * p.cap_inv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale_log2;
      }
    }
    if (valid < kTile) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j * 8 + 2 * t + (e & 1) >= valid) s[j][e] = kNegInf;
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[r], mt);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }

    // P = 2^(S - m) (a masked slot gives 2^-1e30 = 0), packed as the A
    // fragments of P.V (one per 16 slots).
    uint32_t pa[KP][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = ex2(s[j][0] - m[0]);
      const float p1 = ex2(s[j][1] - m[0]);
      const float p2 = ex2(s[j][2] - m[1]);
      const float p3 = ex2(s[j][3] - m[1]);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V, two 8-wide column tiles of O per ldmatrix of V.
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tV + vrow + kp * 16 * LD + d * 8);
        mma_bf16(acc[d], pa[kp], bv[0], bv[1]);
        mma_bf16(acc[d + 1], pa[kp], bv[2], bv[3]);
      }
    }
  }
  async_wait<0>();

  // ---- merge the four warps --------------------------------------------
  // The four threads of a row group hold partial sums of the same rows.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // every warp is done with Q and its ring
  float* sM = reinterpret_cast<float*>(smem_raw);  // [kWarps][kRows]
  float* sL = sM + kWarps * kRows;                  // [kWarps][kRows]
  float* sO = sL + kWarps * kRows;                  // [kWarps][kRows][D]
  if (t == 0) {
    sM[warp * kRows + g] = m[0];
    sM[warp * kRows + g + 8] = m[1];
    sL[warp * kRows + g] = l[0];
    sL[warp * kRows + g + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float mx = sM[row];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sM[w * kRows + row]);
    const float f = ex2(m[r] - mx);  // 0 for a warp that saw no slot
    float* orow = sO + (warp * kRows + row) * D + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<float2*>(orow + d * 8) =
          make_float2(acc[d][2 * r] * f, acc[d][2 * r + 1] * f);
    }
  }
  __syncthreads();

  // Rows < G: O summed over the warps with its (m, l); the output if the
  // cache has one split, else this split's partial.
  const long long row0 = static_cast<long long>(b) * p.heads + kvh * G;
  for (int c = threadIdx.x; c < G * D4; c += kThreads) {
    const int row = c / D4;
    const int col = (c - row * D4) * 4;
    float mx = sM[row];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sM[w * kRows + row]);
    float lsum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lsum += sL[w * kRows + row] * ex2(sM[w * kRows + row] - mx);
      const float4 x =
          *reinterpret_cast<const float4*>(sO + (w * kRows + row) * D + col);
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    if (p.splits == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      store_bf16x4(p.o + b * p.o_b + (kvh * G + row) * p.o_h + col,
                   make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
    } else {
      const long long part = (row0 + row) * p.splits + split;
      *reinterpret_cast<float4*>(p.part_acc + part * D + col) = o;
      if (col == 0) {
        p.part_m[part] = mx;
        p.part_l[part] = lsum;
      }
    }
  }
  if (p.splits == 1) return;

  // ---- the last split of this (batch, KV head) combines ------------------
  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  __shared__ int last_split;
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(p.counters + bk, 1);
    last_split = arrived == p.splits - 1;
    if (last_split) {
      atomicExch(p.counters + bk, 0);  // ready for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!last_split) return;

  combine_splits<D>(p, b, kvh, reinterpret_cast<float*>(smem_raw));
}

template <int D>
cudaError_t configure() {
  return cudaFuncSetAttribute(decode_mma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<D>::kSmem);
}

template <int D>
int launch(const Params& p, int batch, int tile, cudaStream_t stream) {
  if (tile != Cfg<D>::kTile) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.splits, batch * p.kv_heads);
  decode_mma_kernel<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int* blocks_per_sm, int* tile) {
  *tile = Cfg<D>::kTile;
  cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_mma_kernel<D>, kThreads, Cfg<D>::kSmem);
  return static_cast<int>(err);
}

}  // namespace

// Resident blocks per SM of the kernel at this head_dim on the current
// device (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the slots of
// one tile, the unit of a split. `group` changes neither here.
extern "C" int repro_decode_attention_mma_occupancy(int head_dim, int group,
                                                    int* blocks_per_sm,
                                                    int* tile) {
  (void)group;
  switch (head_dim) {
    case 16: return occupancy<16>(blocks_per_sm, tile);
    case 32: return occupancy<32>(blocks_per_sm, tile);
    case 64: return occupancy<64>(blocks_per_sm, tile);
    case 128: return occupancy<128>(blocks_per_sm, tile);
    case 256: return occupancy<256>(blocks_per_sm, tile);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o = decode attention as described at the top of this file, bfloat16.
// strides: 11 element strides, (batch, head, seq) of q, k and v, then
// (batch, head) of o; unit stride on the head dimension d (16, 32, 64, 128
// or 256). length: int32 on the device, length_stride 0 (one value) or 1
// ([B]). The cache's ceil(S / tile) tiles are cut into `splits` balanced
// parts (split s covers tiles [s*tiles/splits, (s+1)*tiles/splits)); tile
// must be the kernel's at d (32, or 16 at d = 256). With splits > 1, part_m/part_l: float32
// [B*H*splits], part_acc: float32 [B*H*splits*d] (16-byte aligned),
// scratch of the caller, and counters: int32 [B*KV], zeros, which the
// kernel leaves zeros. softcap <= 0 means none.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int repro_decode_attention_mma(
    const void* q, const void* k, const void* v, void* o, const int* length,
    long long length_stride, const long long* strides, float* part_m,
    float* part_l, float* part_acc, int* counters, int batch, int heads,
    int kv_heads, int len_s, int head_dim, int tile, int tiles, int splits,
    float softcap, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 ||
      heads / kv_heads > kMaxGroup || len_s < 0 ||
      tiles < 1 || splits < 1 || splits > tiles || splits > kMaxSplits ||
      (splits > 1 && (!part_m || !part_l || !part_acc || !counters))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.length = length;
  p.length_stride = length_stride;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.o_b = strides[9];
  p.o_h = strides[10];
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.counters = counters;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = heads / kv_heads;
  p.len_s = len_s;
  p.tiles = tiles;
  p.splits = splits;
  const float scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  p.scale_log2 = scale * kLog2e;
  p.cap_inv = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_log2 = softcap > 0.f ? softcap * kLog2e : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, batch, tile, s);
    case 32: return launch<32>(p, batch, tile, s);
    case 64: return launch<64>(p, batch, tile, s);
    case 128: return launch<128>(p, batch, tile, s);
    case 256: return launch<256>(p, batch, tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
