// Decode attention (one query per head against a KV cache) for NVIDIA
// Hopper (sm_90a) in float32: the "ffma" design of
// kernels/decode_attention.py. bfloat16 runs on the tensor cores in
// decode_attention_mma.cu.
//
// Replaces the TPU kernel `decode_attention` (body `_decode_kernel`) of
// src/repro/kernels/decode_attention.py for float32 operands:
//
//     o[b,h] = sum_{j < length[b]} softmax_j(cap*tanh((q_bh . k_j) * D^-0.5 / cap)) v_j
//
// with q [B,H,1,D], k/v [B,KV,S,D], KV head of query head h = h / (H/KV)
// (GQA), running (max, sum, acc) in float32, zeros for length = 0, and
// out = acc / max(l, 1e-30).
//
// Bound: bytes. Every cache element read feeds about 2*G flops (G = H/KV
// query heads per KV head), far under the card's flops-per-byte ridge, so
// the kernel can at best stream the valid part of the cache once at the
// memory's rate. What keeps it from that rate is latency: too few bytes in
// flight, too few blocks, serial chains inside a warp, and the serial steps
// at the start and the end of a launch. What the design does about it:
//   * one block of eight warps per (batch, KV head, split of the cache):
//     the G query heads of a KV head share every K/V tile, which is loaded
//     from device memory once (the TPU kernel's grid is per query head).
//     The splits are a balanced partition of the cache's tiles, chosen by
//     split_plan in kernels/decode_attention.py: the fewest whose
//     B*KV*splits blocks fill whole waves of kBlocksPerSm x SMs to 95 %;
//   * tiles of 32 cache slots (64 at D = 16) pass through a ring of
//     cp.async stages shared by the block: 96 KB a block at two blocks an
//     SM (head_dim <= 128, group <= 4), 192 KB at one (Cfg below,
//     static_assert'ed), so 128-184 KB of K and V are in flight an SM,
//     against the ~26 KB that the memory's rate times its latency asks for;
//   * every warp is busy at any group: warp w owns slots [w*W, (w+1)*W) of
//     each tile (W = tile / 8) and keeps its own (m, l, O) for all G heads;
//     the warps merge once, at the end of the block. For Q.K^T a warp's
//     lanes are W slots x P = 32 / W parts of the head dim, each part a
//     partial dot for every head (K read once a lane and tile, Q as 16-byte
//     loads), reduced by log2(P) shuffles; a lane's chunks are rotated by
//     its slot so that each 16-byte load is one wavefront. For P.V the
//     lanes are D/4 column chunks (up to 32) x slot phases, P going through
//     shared memory;
//   * the kernel is compiled for the group rounded up to 2, 4, 8 or 16
//     heads, rows of Q past the group zero: the loops over the heads have
//     no branch, so the compiler interleaves the heads' shuffle and FMA
//     chains, and a small group keeps few registers;
//   * one launch: each block writes its partial (m, l, acc) and the last
//     block of its (batch, KV head) to arrive (a counter in device memory,
//     which that block sets back to 0, so no memset is needed and the
//     launch replays in a CUDA graph) combines them: the partial acc of
//     every split and head by cp.async into the ring, all in flight at
//     once and beside the (m, l) loads, from which a warp per head computes
//     each split's weight 2^(m_s - M) once into shared memory; then all
//     threads sum over (heads x D/4 chunks, and splits where those are
//     fewer than the threads);
//   * the softmax runs in the log2 domain (one multiply folds D^-0.5 and
//     log2 e; the softcap folds scale/cap into its argument and cap*log2 e
//     into its result, with the accurate tanhf) and exp2f; scores, softmax
//     and P.V in full float32 on the FFMA pipe (no TF32, whose 10-bit
//     mantissa would break the 2e-5 tolerance);
//   * each block stops at length[b]: slots from length on are neither read
//     nor used; `length` is read on the device (a scalar broadcast or a
//     [B] vector), so a decode step never waits on the host; Q is loaded
//     before length is read, as it does not depend on it;
//   * element strides for batch, head and sequence (unit stride on D): the
//     model hands its [B,S,KV,D] cache as a transposed view, no copy.
//
// Plain C interface (loaded with ctypes); the launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 16;    // query heads per KV head
constexpr int kMaxSplits = 256;  // the combine keeps [kMaxGroup][splits] weights
constexpr int kSmemPerSm = 233472;  // 228 KB
constexpr int kSmemPerBlockReserved = 1024;

// The tile table. kernels/decode_attention.py mirrors it in tile_slots(),
// and a CPU test reads these two lines as text.
constexpr int kTileD16 = 64;  // cache slots of a tile at head_dim 16
constexpr int kTile = 32;     // cache slots of a tile at every other head_dim

// Query heads a block is compiled for: the group rounded up to 2, 4, 8 or
// 16 (Gemma2-2B's group of 2 and Qwen2-0.5B's of 7 each get a kernel of
// their size).
constexpr int group_bucket(int group) {
  return group <= 2 ? 2 : (group <= 4 ? 4 : (group <= 8 ? 8 : kMaxGroup));
}

template <int D, int kG>
struct Cfg {
  static constexpr int T = D == 16 ? kTileD16 : kTile;
  static constexpr int W = T / kWarps;          // slots of a tile a warp owns
  static constexpr int P = 32 / W;              // Q.K^T: lanes of a slot
  static constexpr int D4 = D / 4;              // 16-byte chunks of a row
  static constexpr int NC = D4 / P;             // Q.K^T: chunks of a lane
  static constexpr int CL = D4 < 32 ? D4 : 32;  // P.V: column lanes
  static constexpr int PH = 32 / CL;            // P.V: slot phases
  static constexpr int AC = D4 / CL;            // P.V: O chunks a lane and head
  static constexpr int GP = (kG + 3) / 4 * 4;   // a slot's P row (float4s)
  // Resident blocks per SM, and the ring that gives exactly that many: two
  // blocks of 96 KB, or one of 192 KB where a thread needs more than the
  // 128 registers two blocks leave it (O at head_dim 256, or 8 heads and
  // more, where ptxas spills under 128). One block an SM also halves the
  // splits, so the last block combines fewer partials.
  static constexpr int kBlocksPerSm = D == 256 || kG >= 8 ? 1 : 2;
  static constexpr int kStage = 2 * T * D;                 // K and V (floats)
  static constexpr int kStages = (kBlocksPerSm == 1 ? 192 : 96) * 256 / kStage;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kP = kWarps * W * GP;               // P of the warps
  // The ring, P and Q (bytes).
  static constexpr int kSmem = (kRing + kP + kG * D) * 4;
  static_assert(NC >= 1 && NC * P == D4 && (NC & (NC - 1)) == 0, "Q.K^T lanes");
  static_assert(AC * CL == D4 && W % PH == 0, "P.V lanes");
  static_assert(T * D4 % kThreads == 0 && kThreads % D4 == 0, "copies");
  static_assert(kStages >= 3, "ring depth");
  static_assert(kBlocksPerSm * (kSmem + kSmemPerBlockReserved) <= kSmemPerSm &&
                    (kBlocksPerSm + 1) * (kSmem + kSmemPerBlockReserved) >
                        kSmemPerSm,
                "shared memory must give exactly kBlocksPerSm blocks per SM");
  // The merge reuses the ring: O, then (m, l), of each warp; so does the
  // combine: the weights [kG][kMaxSplits], the heads' reciprocals, a float4
  // a thread, then the partial acc of at least one split of every head.
  static_assert(kWarps * kG * (D + 2) <= kRing, "merge scratch");
  static_assert(kG * kMaxSplits + GP + 4 * kThreads + kG * D <= kRing,
                "combine scratch");
};

struct Strides {
  long long b, h, s;  // elements; D has unit stride
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
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
  float cap_in;      // D^-0.5 / softcap
  float cap_out;     // softcap * log2 e; <= 0: no softcap
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global into shared memory, or 16 zero bytes if !ok (no
// global read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// Release this thread's earlier writes / acquire others' at device scope
// (lighter than __threadfence's sequentially consistent fence).
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
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

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ float4 scale4(const float4& x, float f) {
  return make_float4(x.x * f, x.y * f, x.z * f, x.w * f);
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// The splits' partials of (batch b, KV head kvh) into its G output rows:
// o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with w_s = 2^(m_s - max
// m) over the splits that saw a slot (an empty split has l = 0, acc = 0).
// The partials are read from L2 (other blocks wrote them), each once: acc
// by cp.async into the ring, a chunk of splits at a time (all of them at
// the models' shapes), its copies in flight together and with the (m, l)
// loads, which a warp per head turns into the weights meanwhile.
template <int D, int kG>
__device__ __forceinline__ void combine_splits(const Params& p, int b, int kvh,
                                               float* smem, int smem_floats) {
  constexpr int D4 = D / 4;
  constexpr int GP = (kG + 3) / 4 * 4;
  constexpr int kPerLane = kMaxSplits / 32;
  const int G = p.group;
  const int S = p.splits;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(b) * p.heads + kvh * G;
  float* sW = smem;                                      // [kG][kMaxSplits]
  float* sInv = sW + kG * kMaxSplits;                    // [GP]
  float4* sRed = reinterpret_cast<float4*>(sInv + GP);   // [kThreads]
  float* sA = sInv + GP + 4 * kThreads;                  // [G][chunk][D]
  const int chunk = min(S, (smem_floats - (kG * kMaxSplits + GP +
                                           4 * kThreads)) / (G * D));
  // acc of splits [s0, s0 + n) of every head into sA. kThreads is a
  // multiple of D/4, so a thread keeps one 16-byte column and walks the
  // (head, split) rows kThreads / (D/4) apart.
  auto copy = [&](int s0, int n) {
    constexpr int kRowStep = kThreads / D4;
    const int col = (tid % D4) * 4;
    int g = 0;
    int s = tid / D4;
    while (s >= n && g < G) {
      s -= n;
      ++g;
    }
    for (; g < G;) {
      cp_async16(sA + (g * n + s) * D + col,
                 p.part_acc + ((row0 + g) * S + s0 + s) * D + col, true);
      s += kRowStep;
      while (s >= n && g < G) {
        s -= n;
        ++g;
      }
    }
    async_commit();
  };
  copy(0, chunk);

  // A warp per head: its splits' (m, l), lanes over the splits.
  for (int g = warp; g < G; g += kWarps) {
    const float* pm = p.part_m + (row0 + g) * S;
    const float* pl = p.part_l + (row0 + g) * S;
    float ms[kPerLane], ls[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int s = lane + 32 * i;
      ms[i] = s < S ? __ldcg(pm + s) : kNegInf;
      ls[i] = s < S ? __ldcg(pl + s) : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (ls[i] > 0.f) mx = fmaxf(mx, ms[i]);
    }
    mx = warp_max(mx);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int s = lane + 32 * i;
      const float w = ls[i] > 0.f ? exp2f(ms[i] - mx) : 0.f;
      if (s < S) sW[g * kMaxSplits + s] = w;
      den = fmaf(w, ls[i], den);
    }
    den = warp_sum(den);
    if (lane == 0) sInv[g] = 1.f / fmaxf(den, 1e-30f);
  }

  // Threads over (head, 16-byte column chunk) and, where those are fewer
  // than the threads, R interleaved subsets of the splits.
  const int items = G * D4;
  const int R = max(1, min(kThreads / items, S));
  constexpr int kItems = (kG * D4 + kThreads - 1) / kThreads;
  float4 o[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < S; s0 += chunk) {
    const int n = min(chunk, S - s0);
    async_wait<0>();
    __syncthreads();  // this chunk (and the weights) visible
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      if (e < items * R) {
        const int r = e / items;
        const int it = e - r * items;
        const int g = it / D4;
        const int col = (it - g * D4) * 4;
        const float* w = sW + g * kMaxSplits + s0;
        const float* a = sA + g * n * D + col;
        for (int s = r; s < n; s += R) {
          fma4(o[i], w[s], *reinterpret_cast<const float4*>(a + s * D));
        }
      }
    }
    if (s0 + chunk < S) {
      __syncthreads();  // every thread is done with this chunk
      copy(s0 + chunk, min(chunk, S - s0 - chunk));
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = tid + i * kThreads;
    if (e < items * R) {
      const int r = e / items;
      const int it = e - r * items;
      const int g = it / D4;
      const int col = (it - g * D4) * 4;
      if (R == 1) {
        *reinterpret_cast<float4*>(p.o + b * p.o_b + (kvh * G + g) * p.o_h +
                                   col) = scale4(o[i], sInv[g]);
      } else {
        sRed[e] = o[i];
      }
    }
  }
  if (R == 1) return;
  __syncthreads();
  for (int it = tid; it < items; it += kThreads) {
    const int g = it / D4;
    const int col = (it - g * D4) * 4;
    float4 acc = sRed[it];
    for (int r = 1; r < R; ++r) add4(acc, sRed[r * items + it]);
    *reinterpret_cast<float4*>(p.o + b * p.o_b + (kvh * G + g) * p.o_h +
                               col) = scale4(acc, sInv[g]);
  }
}

template <int D, int kG>
__global__ void __launch_bounds__(kThreads, (Cfg<D, kG>::kBlocksPerSm))
decode_ffma_kernel(const Params p) {
  using C = Cfg<D, kG>;
  constexpr int T = C::T;
  constexpr int W = C::W;
  constexpr int P = C::P;
  constexpr int D4 = C::D4;
  constexpr int NC = C::NC;
  constexpr int CL = C::CL;
  constexpr int PH = C::PH;
  constexpr int AC = C::AC;
  constexpr int GP = C::GP;
  constexpr int NS = C::kStages;

  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                  // [NS][K, V][T][D]
  float* sP = ring + C::kRing;         // [kWarps][W][GP]
  float* sQ = sP + C::kP;              // [kG][D], rows past G zeros

  const int split = blockIdx.x;
  const int bk = blockIdx.y;
  const int b = bk / p.kv_heads;
  const int kvh = bk - b * p.kv_heads;
  const int G = p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Q of this KV head's G query heads, issued before length is read (it
  // does not depend on it); it completes with the first tile's group.
  const float* q = p.q + b * p.sq.b + static_cast<long long>(kvh) * G * p.sq.h;
  for (int c = tid; c < kG * D4; c += kThreads) {
    const int g = c / D4;
    const int col = (c - g * D4) * 4;
    const bool ok = g < G;
    cp_async16(sQ + g * D + col, q + (ok ? g * p.sq.h + col : 0), ok);
  }

  // This split's slots: tiles [t0, t1) of the balanced partition, cut at
  // the valid length.
  const int len = min(max(p.length[b * p.length_stride], 0), p.len_s);
  const int t0 = static_cast<int>(static_cast<long long>(split) * p.tiles /
                                  p.splits);
  const int t1 = static_cast<int>(static_cast<long long>(split + 1) *
                                  p.tiles / p.splits);
  const int s_begin = t0 * T;
  const int s_end = min(t1 * T, len);
  const int n_tiles = s_begin < s_end ? (s_end - s_begin + T - 1) / T : 0;

  const float* k = p.k + b * p.sk.b + kvh * p.sk.h;
  const float* v = p.v + b * p.sv.b + kvh * p.sv.h;
  // Tile i into stage i % NS; rows past s_end zero-filled, not read.
  auto load = [&](int i) {
    const int n0 = s_begin + i * T;
    const int valid = min(T, s_end - n0);
    float* dk = ring + (i % NS) * C::kStage;
    float* dv = dk + T * D;
#pragma unroll
    for (int it = 0; it < T * D4 / kThreads; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / D4;
      const int col = (c - r * D4) * 4;
      const bool ok = r < valid;
      const long long slot = ok ? n0 + r : 0;
      cp_async16(dk + r * D + col, k + slot * p.sk.s + col, ok);
      cp_async16(dv + r * D + col, v + slot * p.sv.s + col, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load(i);
    async_commit();
  }

  // Q.K^T: lane = (slot ws of the warp's W, part of the head dim); P.V:
  // lane = (slot phase ph, column lane cl).
  const int ws = lane / P;
  const int part = lane - ws * P;
  const int ph = lane / CL;
  const int cl = lane - ph * CL;
  const int slot_qk = warp * W + ws;  // the lane's slot of the tile
  float* pw = sP + warp * W * GP;
  const bool capped = p.cap_out > 0.f;

  float m[kG], l[kG];
  float4 acc[kG][AC];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int a = 0; a < AC; ++a) acc[g][a] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int i = 0; i < n_tiles; ++i) {
    async_wait<NS - 2>();
    __syncthreads();  // tile i (and Q) visible; stage (i - 1) % NS free
    if (i + NS - 1 < n_tiles) load(i + NS - 1);
    async_commit();
    const float* tK = ring + (i % NS) * C::kStage;
    const float* tV = tK + T * D;
    const int valid = min(T, s_end - (s_begin + i * T));

    // Partial dots of this lane's chunks for every head; chunk j of the
    // lane is part + P * ((j + ws) mod NC), so the lanes of one 8-lane
    // phase read 8 distinct 16-byte words of a bank row.
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.f;
    const float* krow = tK + slot_qk * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = 4 * (part + P * ((j + ws) & (NC - 1)));
      const float4 kc = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 qc = *reinterpret_cast<const float4*>(sQ + g * D + c);
        s[g] = fmaf(qc.x, kc.x, s[g]);
        s[g] = fmaf(qc.y, kc.y, s[g]);
        s[g] = fmaf(qc.z, kc.z, s[g]);
        s[g] = fmaf(qc.w, kc.w, s[g]);
      }
    }

    // Online softmax of the warp's W slots per head; P into shared memory.
    const bool live = slot_qk < valid;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int off = 1; off < P; off <<= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
    float mt[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float x = capped ? p.cap_out * tanhf(s[g] * p.cap_in)
                             : s[g] * p.scale_log2;
      s[g] = live ? x : kNegInf;
      mt[g] = s[g];
    }
#pragma unroll
    for (int off = P; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        mt[g] = fmaxf(mt[g], __shfl_xor_sync(0xffffffffu, mt[g], off));
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float m_new = fmaxf(m[g], mt[g]);
      const float alpha = exp2f(m[g] - m_new);
      m[g] = m_new;
      const float pe = live ? exp2f(s[g] - m_new) : 0.f;
      l[g] = fmaf(l[g], alpha, part == 0 ? pe : 0.f);
      s[g] = pe;
#pragma unroll
      for (int a = 0; a < AC; ++a) acc[g][a] = scale4(acc[g][a], alpha);
    }
    if (part == 0) {
#pragma unroll
      for (int g4 = 0; g4 < GP; g4 += 4) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[e] = g4 + e < kG ? s[min(g4 + e, kG - 1)] : 0.f;
        *reinterpret_cast<float4*>(pw + ws * GP + g4) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
      }
    }
    __syncwarp();

    // O += P V over the warp's live slots.
#pragma unroll
    for (int w2 = 0; w2 < W / PH; ++w2) {
      const int sl = ph + PH * w2;
      if (warp * W + sl < valid) {
        const float* vrow = tV + (warp * W + sl) * D;
        float4 vc[AC];
#pragma unroll
        for (int a = 0; a < AC; ++a) {
          vc[a] = *reinterpret_cast<const float4*>(vrow + 4 * (cl + CL * a));
        }
        const float* prow = pw + sl * GP;
#pragma unroll
        for (int g4 = 0; g4 < GP; g4 += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(prow + g4);
          const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
          for (int e = 0; e < 4 && g4 + e < kG; ++e) {
#pragma unroll
            for (int a = 0; a < AC; ++a) fma4(acc[g4 + e][a], pv[e], vc[a]);
          }
        }
      }
    }
  }
  async_wait<0>();  // no copy outstanding (Q of an empty split)

  // ---- merge the warps ---------------------------------------------------
  // In a warp: l over its lanes, O over its slot phases.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
  }
#pragma unroll
  for (int off = CL; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int a = 0; a < AC; ++a) {
        acc[g][a].x += __shfl_xor_sync(0xffffffffu, acc[g][a].x, off);
        acc[g][a].y += __shfl_xor_sync(0xffffffffu, acc[g][a].y, off);
        acc[g][a].z += __shfl_xor_sync(0xffffffffu, acc[g][a].z, off);
        acc[g][a].w += __shfl_xor_sync(0xffffffffu, acc[g][a].w, off);
      }
    }
  }
  __syncthreads();  // every warp is done with Q, P and the ring
  // Each warp's O (unscaled), m and l; the final pass below scales each
  // warp's share by 2^(m_w - max m) (0 for a warp that saw no slot).
  float* sO = ring;                         // [kWarps][kG][D]
  float* sM = sO + kWarps * kG * D;         // [kWarps][kG]
  float* sL = sM + kWarps * kG;             // [kWarps][kG]
  if (lane < kG) {
    // m and l are the same in every lane: lane g writes head g's.
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (lane == g) {
        sM[warp * kG + g] = m[g];
        sL[warp * kG + g] = l[g];
      }
    }
  }
  if (ph == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* orow = sO + (warp * kG + g) * D;
#pragma unroll
      for (int a = 0; a < AC; ++a) {
        *reinterpret_cast<float4*>(orow + 4 * (cl + CL * a)) = acc[g][a];
      }
    }
  }
  __syncthreads();

  // Rows < G: O summed over the warps with its (m, l); the output if the
  // cache has one split, else this split's partial.
  const long long row0 = static_cast<long long>(b) * p.heads + kvh * G;
  for (int c = tid; c < G * D4; c += kThreads) {
    const int g = c / D4;
    const int col = (c - g * D4) * 4;
    float mw[kWarps];
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = sM[w * kG + g];
      mx = fmaxf(mx, mw[w]);
    }
    float lsum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(mw[w] - mx);
      lsum = fmaf(sL[w * kG + g], f, lsum);
      fma4(o, f, *reinterpret_cast<const float4*>(sO + (w * kG + g) * D + col));
    }
    if (p.splits == 1) {
      *reinterpret_cast<float4*>(p.o + b * p.o_b + (kvh * G + g) * p.o_h +
                                 col) = scale4(o, 1.f / fmaxf(lsum, 1e-30f));
    } else {
      const long long part_row = (row0 + g) * p.splits + split;
      *reinterpret_cast<float4*>(p.part_acc + part_row * D + col) = o;
      if (col == 0) {
        p.part_m[part_row] = mx;
        p.part_l[part_row] = lsum;
      }
    }
  }
  if (p.splits == 1) return;

  // ---- the last split of this (batch, KV head) combines ------------------
  fence_acq_rel();  // this thread's partials before the block's arrival
  __syncthreads();
  int* last_split = reinterpret_cast<int*>(sP);  // P is no longer read
  if (tid == 0) {
    const int arrived = atomicAdd(p.counters + bk, 1);
    *last_split = arrived == p.splits - 1;
    if (*last_split) {
      fence_acq_rel();  // the other splits' partials before the reads below
      atomicExch(p.counters + bk, 0);  // ready for the next launch
    }
  }
  __syncthreads();
  if (!*last_split) return;
  combine_splits<D, kG>(p, b, kvh, ring, C::kRing);
}

template <int D, int kG>
cudaError_t configure() {
  return cudaFuncSetAttribute(decode_ffma_kernel<D, kG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<D, kG>::kSmem);
}

template <int D, int kG>
int launch(const Params& p, int batch, int tile, cudaStream_t stream) {
  if (tile != Cfg<D, kG>::T) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure<D, kG>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.splits, batch * p.kv_heads);
  decode_ffma_kernel<D, kG><<<grid, kThreads, Cfg<D, kG>::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Params& p, int batch, int tile, cudaStream_t stream) {
  switch (group_bucket(p.group)) {
    case 2: return launch<D, 2>(p, batch, tile, stream);
    case 4: return launch<D, 4>(p, batch, tile, stream);
    case 8: return launch<D, 8>(p, batch, tile, stream);
    default: return launch<D, kMaxGroup>(p, batch, tile, stream);
  }
}

template <int D, int kG>
int occupancy(int* blocks_per_sm, int* tile) {
  *tile = Cfg<D, kG>::T;
  const cudaError_t err = configure<D, kG>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_ffma_kernel<D, kG>, kThreads, Cfg<D, kG>::kSmem));
}

template <int D>
int occupancy(int group, int* blocks_per_sm, int* tile) {
  switch (group_bucket(group)) {
    case 2: return occupancy<D, 2>(blocks_per_sm, tile);
    case 4: return occupancy<D, 4>(blocks_per_sm, tile);
    case 8: return occupancy<D, 8>(blocks_per_sm, tile);
    default: return occupancy<D, kMaxGroup>(blocks_per_sm, tile);
  }
}

}  // namespace

// Resident blocks per SM of the kernel at this head_dim and group (query
// heads per KV head) on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the slots of one
// tile, the unit of a split.
extern "C" int repro_decode_attention_occupancy(int head_dim, int group,
                                                int* blocks_per_sm,
                                                int* tile) {
  if (group < 1 || group > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (head_dim) {
    case 16: return occupancy<16>(group, blocks_per_sm, tile);
    case 32: return occupancy<32>(group, blocks_per_sm, tile);
    case 64: return occupancy<64>(group, blocks_per_sm, tile);
    case 128: return occupancy<128>(group, blocks_per_sm, tile);
    case 256: return occupancy<256>(group, blocks_per_sm, tile);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o = decode attention as described at the top of this file, float32.
// strides: 11 element strides, (batch, head, seq) of q, k and v, then
// (batch, head) of o; unit stride on the head dimension d (16, 32, 64, 128
// or 256). length: int32 on the device, length_stride 0 (one value) or 1
// ([B]). The cache's ceil(S / tile) tiles are cut into `splits` balanced
// parts (split s covers tiles [s*tiles/splits, (s+1)*tiles/splits)); tile
// must be the kernel's at d (32, or 64 at d = 16). With splits > 1,
// part_m/part_l: float32 [B*H*splits], part_acc: float32 [B*H*splits*d]
// (16-byte aligned), scratch of the caller, and counters: int32 [B*KV],
// zeros, which the kernel leaves zeros. softcap <= 0 means none.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int repro_decode_attention(
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
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_out = softcap > 0.f ? softcap * kLog2e : 0.f;
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
