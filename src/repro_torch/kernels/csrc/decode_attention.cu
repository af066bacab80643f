// Decode attention (one query per head against a KV cache) for NVIDIA
// Hopper (sm_90a), split along the cache (flash-decoding): the float32
// "ffma" design of kernels/decode_attention.py. bfloat16 runs on the
// tensor cores in decode_attention_mma.cu.
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
// Bound: bytes. Every cache element read costs about 2*G flops (G = H/KV
// query heads per KV head), far under the card's flops-per-byte ridge, so
// the only lever is to read the valid part of the cache once, and fast.
// What the design does about that:
//   * one block per (batch, KV head, split of the cache): the G query heads
//     of a KV head share the block, so each K/V tile is loaded from device
//     memory once for all of them (the TPU kernel's grid is per query head);
//   * the cache is split along S into a balanced partition of its tiles
//     (split_plan in kernels/decode_attention.py: whole waves of the
//     resident blocks where the tiles allow) so that B*KV*splits blocks
//     fill the SMs even where B*KV is small; each split writes its partial
//     (m, l, acc) and a second small kernel combines them;
//   * K/V tiles are double-buffered with cp.async, so the next tile's copy
//     overlaps this tile's scores and products;
//   * each block stops at length[b]: the unwritten tail of the cache is
//     neither read nor masked (the TPU kernel streams and masks it); a
//     split that starts past length writes an empty partial;
//   * `length` is read on the device (a scalar broadcast or a [B] vector),
//     so a decode step never waits on the host;
//   * element strides for batch, head and sequence (unit stride on D): the
//     model hands its [B,S,KV,D] cache as a transposed view, no copy.
// Scores, softmax and P.V run on CUDA cores in full float32 (no TF32, whose
// 10-bit mantissa would break the 2e-5 tolerance), with the accurate expf.
//
// Plain C interface (loaded with ctypes); the launcher returns the
// cudaError_t of the launches as an int and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 16;                         // query heads per KV head
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;

struct Strides {
  long long b, h, s;  // elements; D has unit stride
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  long long length_stride;  // 0: one length for the batch; 1: [B]
  Strides sq, sk, sv;
  float* part_m;            // [B*H, splits]
  float* part_l;            // [B*H, splits]
  float* part_acc;          // [B*H, splits, D]
  int heads, kv_heads, group, len_s, tiles, splits;
  float scale;
  float softcap;            // <= 0: none
};

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

// The 4 floats of a 16-byte pack.
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

template <int D>
struct Layout {
  static constexpr int kPer = 4;                    // floats per 16 bytes
  // Cache slots per tile, the unit of a split: 64, except at D = 256,
  // where two stages of 64 slots of K and V would need 2 x 64 x (260 +
  // 256) x 4 B = 264 KB of shared memory, more than a block may have
  // (227 KB); 32 slots take 132 KB.
  static constexpr int kTile = D == 256 ? 32 : 64;
  static constexpr int kSlotsPerLane = kTile / 32;  // softmax: slots a lane holds
  // K rows padded by 16 bytes: lanes reading 16-byte packs of consecutive
  // rows hit distinct banks in each 8-lane phase.
  static constexpr int LDK = D + kPer;
  static constexpr int kPairs = (D / 2 + 31) / 32;  // column pairs per lane
  static size_t smem(int group) {                   // two stages of K and V
    return 2 * static_cast<size_t>(kTile) * (LDK + D) * sizeof(float) +
           static_cast<size_t>(group) * (D + kTile) * sizeof(float);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows x D floats from global (row stride `stride`) into smem (row stride
// ld) by 16-byte cp.async; rows >= valid are zero-filled.
__device__ __forceinline__ void async_rows(float* dst, int ld,
                                           const float* src, long long stride,
                                           int rows, int valid, int d) {
  const int packs = d / 4;
  for (int c = threadIdx.x; c < rows * packs; c += blockDim.x) {
    const int r = c / packs;
    const int col = (c - r * packs) * 4;
    const bool ok = r < valid;
    const float* from = src + (ok ? r * stride + col : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(smem_addr(dst + r * ld + col)), "l"(from),
                   "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int kTile = L::kTile;
  constexpr int LDK = L::LDK;
  constexpr int kPer = L::kPer;
  constexpr int kPairs = L::kPairs;
  constexpr int kSlots = L::kSlotsPerLane;
  const int G = p.group;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);        // [2][kTile][LDK]
  float* sV = sK + 2 * kTile * LDK;                      // [2][kTile][D]
  float* sQ = sV + 2 * kTile * D;                        // [G, D]
  float* sS = sQ + G * D;                                // [G, kTile]

  // This split's slots: tiles [split*tiles/splits, (split+1)*tiles/splits),
  // cut at the valid length.
  const int split = blockIdx.x;
  const int b = blockIdx.y / p.kv_heads;
  const int kvh = blockIdx.y - b * p.kv_heads;
  const int len = min(max(p.length[b * p.length_stride], 0), p.len_s);
  const int s_begin = static_cast<int>(
      static_cast<long long>(split) * p.tiles / p.splits) * kTile;
  const int s_end = min(static_cast<int>(static_cast<long long>(split + 1) *
                                         p.tiles / p.splits) * kTile,
                        len);

  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  auto load_kv = [&](int n0, int stage) {
    const int rows = min(kTile, s_end - n0);
    async_rows(sK + stage * kTile * LDK, LDK, k + n0 * p.sk.s, p.sk.s, kTile,
               rows, D);
    async_rows(sV + stage * kTile * D, D, v + n0 * p.sv.s, p.sv.s, kTile,
               rows, D);
  };
  if (s_begin < s_end) load_kv(s_begin, 0);
  async_commit();

  const float* q = static_cast<const float*>(p.q) + b * p.sq.b;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i - g * D;
    sQ[i] = q[(kvh * G + g) * p.sq.h + d];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float m[kHeadsPerWarp], l[kHeadsPerWarp], acc[kHeadsPerWarp][2 * kPairs];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * kPairs; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = s_begin; n0 < s_end; n0 += kTile) {
    const int stage = ((n0 - s_begin) / kTile) & 1;
    const int rows = min(kTile, s_end - n0);
    if (n0 + kTile < s_end) {
      load_kv(n0 + kTile, stage ^ 1);  // overlaps this tile's work
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();  // tile visible (and sQ written) for every warp
    const float* tK = sK + stage * kTile * LDK;
    const float* tV = sV + stage * kTile * D;

    // Scores of all G heads: thread -> slot j = tid % kTile, heads
    // g = tid / kTile, + 128 / kTile, ...; consecutive lanes read
    // consecutive K rows.
    for (int i = threadIdx.x; i < G * kTile; i += blockDim.x) {
      const int g = i / kTile;
      const int j = i - g * kTile;
      const float* qg = sQ + g * D;
      const float* kr = tK + j * LDK;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += kPer) {
        float f[kPer];
        unpack(*reinterpret_cast<const uint4*>(kr + d), f);
#pragma unroll
        for (int e = 0; e < kPer; ++e) dot = fmaf(qg[d + e], f[e], dot);
      }
      float x = dot * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      sS[i] = j < rows ? x : kNegInf;
    }
    __syncthreads();

    // Warp w owns heads w, w+4, ...: online softmax, then acc += p V.
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      const int g = warp + kWarps * hh;
      if (g >= G) break;
      float* srow = sS + g * kTile;
      float sv[kSlots];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        sv[c] = srow[lane + 32 * c];
        mt = fmaxf(mt, sv[c]);
      }
      const float m_new = fmaxf(m[hh], warp_max(mt));
      const float alpha = expf(m[hh] - m_new);
      m[hh] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        const float pc = sv[c] == kNegInf ? 0.f : expf(sv[c] - m_new);
        ps += pc;
        srow[lane + 32 * c] = pc;
      }
      l[hh] = l[hh] * alpha + warp_sum(ps);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 2 * kPairs; ++c) acc[hh][c] *= alpha;
      for (int j = 0; j < rows; ++j) {
        const float pj = srow[j];
        const float* vr = tV + j * D;
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          const int dp = lane + 32 * c;
          if (dp < D / 2) {
            const float2 vv = *reinterpret_cast<const float2*>(vr + 2 * dp);
            acc[hh][2 * c] = fmaf(pj, vv.x, acc[hh][2 * c]);
            acc[hh][2 * c + 1] = fmaf(pj, vv.y, acc[hh][2 * c + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }
  async_wait<0>();  // no copy outstanding at exit (an empty split)

  // Partials of this split (an empty split writes l = 0).
#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
    const int g = warp + kWarps * hh;
    if (g >= G) break;
    const long long row =
        (static_cast<long long>(b) * p.heads + kvh * G + g) * p.splits + split;
    if (lane == 0) {
      p.part_m[row] = m[hh];
      p.part_l[row] = l[hh];
    }
    float* out = p.part_acc + row * D;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int dp = lane + 32 * c;
      if (dp < D / 2) {
        out[2 * dp] = acc[hh][2 * c];
        out[2 * dp + 1] = acc[hh][2 * c + 1];
      }
    }
  }
}

// One warp per (batch, head): o = sum_s w_s acc_s / max(sum_s w_s l_s,
// 1e-30), w_s = exp(m_s - max m) over the splits that saw a key.
__global__ void __launch_bounds__(kThreads)
decode_reduce_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, float* __restrict__ o,
                     long long o_b, long long o_h, int rows, int heads,
                     int splits, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pm = part_m + static_cast<long long>(row) * splits;
  const float* pl = part_l + static_cast<long long>(row) * splits;
  float m_max = kNegInf;
  for (int s = 0; s < splits; ++s) {
    if (pl[s] > 0.f) m_max = fmaxf(m_max, pm[s]);
  }
  float denom = 0.f;
  for (int s = 0; s < splits; ++s) {
    if (pl[s] > 0.f) denom += expf(pm[s] - m_max) * pl[s];
  }
  denom = fmaxf(denom, 1e-30f);
  const int b = row / heads;
  const int h = row - b * heads;
  float* orow = o + b * o_b + h * o_h;
  const float* acc = part_acc + static_cast<long long>(row) * splits * d;
  for (int c = lane; c < d; c += 32) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      if (pl[s] > 0.f) sum += expf(pm[s] - m_max) * acc[s * d + c];
    }
    orow[c] = sum / denom;
  }
}

template <int D>
cudaError_t configure(int group) {
  return cudaFuncSetAttribute(decode_split_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Layout<D>::smem(group)));
}

template <int D>
int launch(const Params& p, int batch, float* o, long long o_b, long long o_h,
           cudaStream_t stream) {
  cudaError_t err = configure<D>(p.group);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.splits, batch * p.kv_heads);
  decode_split_kernel<D><<<grid, kThreads, Layout<D>::smem(p.group), stream>>>(
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * p.heads;
  decode_reduce_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      p.part_m, p.part_l, p.part_acc, o, o_b, o_h, rows, p.heads, p.splits, D);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int group, int* blocks_per_sm, int* tile) {
  *tile = Layout<D>::kTile;
  const cudaError_t err = configure<D>(group);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_split_kernel<D>, kThreads,
      Layout<D>::smem(group)));
}

}  // namespace

// Resident blocks per SM of the split kernel at this head_dim and group
// (query heads per KV head) on the current device, and the slots of one
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
// ([B]). part_m/part_l: float32 [B*H*splits], part_acc: float32
// [B*H*splits*d], scratch of the caller. The cache's ceil(S / tile) tiles
// are cut into `splits` balanced parts (split s covers tiles
// [s*tiles/splits, (s+1)*tiles/splits)); tile must be the kernel's at d
// (64, or 32 at d = 256). softcap <= 0 means none.
// Returns the launches' cudaError_t (0 = ok).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, const int* length,
    long long length_stride, const long long* strides, float* part_m,
    float* part_l, float* part_acc, int batch, int heads, int kv_heads,
    int len_s, int head_dim, int tile, int tiles, int splits, float softcap,
    void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  const int want_tile = head_dim == 256 ? 32 : 64;
  if (kv_heads <= 0 || heads % kv_heads != 0 ||
      heads / kv_heads > kMaxGroup || tile != want_tile || tiles < 1 ||
      splits < 1 || splits > tiles || len_s < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.length = length;
  p.length_stride = length_stride;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = heads / kv_heads;
  p.len_s = len_s;
  p.tiles = tiles;
  p.splits = splits;
  p.scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  p.softcap = softcap;
  float* out = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, batch, out, strides[9], strides[10], s);
    case 32: return launch<32>(p, batch, out, strides[9], strides[10], s);
    case 64: return launch<64>(p, batch, out, strides[9], strides[10], s);
    case 128: return launch<128>(p, batch, out, strides[9], strides[10], s);
    case 256: return launch<256>(p, batch, out, strides[9], strides[10], s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
