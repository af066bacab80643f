// Blocked online-softmax attention (prefill) in float32 for NVIDIA Hopper
// (sm_90a): design "ffma" of kernels/flash_attention.py, every head_dim
// (16, 32, 64, 128, 256). The bfloat16 design is flash_attention_wgmma.cu;
// the wrapper's design() is the table that picks.
//
// Replaces the TPU kernel `flash_attention` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention.py in float32:
//
//     o[b,h,i] = sum_j softmax_j(mask(cap*tanh((q_i . k_j) * D^-0.5 / cap))) v_j
//
// with q [B,H,Sq,D], k/v [B,KV,Sk,D], KV head of query head h = h / (H/KV)
// (GQA), key j valid for query i when j <= i (causal) and j > i - window
// (sliding window), running (max, sum, acc) in float32, a row with no valid
// key giving zeros, and out = acc / max(l, 1e-30).
//
// Bound: operations. 4*D flops per live (query, key) pair against 4 bytes
// per element moved once; full float32 (no TF32, whose 10-bit mantissa
// breaks the 2e-5 tolerance), so the peak is the FFMA pipe's. What the
// design does about it:
//   * one block of 256 threads per (b*h, 64-query tile), the heaviest
//     causal tiles of every head launched first; 64-key tiles over the
//     range the causal and window reach of its rows can see (the TPU
//     kernel's `pl.when(live)`);
//   * register blocking: the threads form 16 row groups x 16 key groups.
//     A thread holds a 4 x 4 tile of S (rows ty + 16i, keys tx + 16j) and
//     4 rows x D/16 columns of O in registers. Q.K^T reads one float4 of
//     each of its 4 Q rows and 4 K rows for 64 FFMA; P.V reads one float4
//     of P per row and the key's V columns for 4*D/16 FFMA a key;
//   * a warp is 4 row groups x 8 key groups, so each of its 16-byte shared
//     loads touches 4 (Q, P) or 8 (K, V) distinct 16-byte words in 8
//     distinct bank groups (rows padded by 16 bytes): one wavefront;
//   * K and V pass through a ring of cp.async slots, K(t), V(t), K(t+1),
//     ...: four slots (two stages of each) at D <= 128, two at D = 256,
//     where two 64-key stages of both would not fit beside Q. Each copy is
//     issued one product ahead of its use or more, so V(t) lands during
//     Q.K^T(t) and K(t+1) during P.V(t);
//   * the softmax runs in the log2 domain (one multiply folds D^-0.5 and
//     log2 e; the softcap folds scale/cap into its argument and cap*log2 e
//     into its result, with the accurate tanhf) and exp2f; the mask is
//     evaluated only on tiles that cross the causal diagonal, the window's
//     edge or the end of the keys. A row's max is reduced over its 16 key
//     groups (3 shuffles, then the two warps through shared memory) once a
//     tile; its sum is reduced once, at the end. P goes through shared
//     memory to the threads that own O's columns;
//   * the kernel takes element strides for batch, head and sequence (unit
//     stride on D), so the model hands it [B,S,H,D] activations as
//     transposed views and no copy is made.
//
// Plain C interface (loaded with ctypes); the launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The tile table. kernels/flash_attention.py mirrors it as ffma_tile(), and
// a CPU test reads these constants and the static_asserts below as text.
constexpr int kBM = 64;        // query rows of a block
constexpr int kBN = 64;        // keys of a tile
constexpr int kThreads = 256;  // 16 row groups x 16 key groups
constexpr int kPadKV = 4;      // floats of pad on a Q, K or V row (16 bytes)
constexpr int kPadP = 8;       // floats of pad on a P row
constexpr int kSlotsD256 = 2;  // K/V ring slots at head_dim 256
constexpr int kSlots = 4;      // K/V ring slots at every other head_dim

template <int D>
struct FfmaTile {
  static constexpr int LD = D + kPadKV;  // Q, K, V row (floats)
  static constexpr int PLD = kBN + kPadP;  // P row (floats)
  static constexpr int SLOTS = D == 256 ? kSlotsD256 : kSlots;
  static constexpr int VEC = D >= 64 ? 4 : D / 16;  // O columns a chunk
  static constexpr int NCH = D / 16 / VEC;          // O chunks a thread
  // Two blocks an SM (128 registers a thread) where ptxas fits the kernel
  // in them without a spill; at D = 32 it spills there (12 bytes).
  static constexpr int kMinBlocks = D == 16 || D == 64 ? 2 : 1;
  // Q, the K/V ring, P, and the two warps' row maxima / sums.
  static constexpr size_t kSmem =
      static_cast<size_t>(kBM * LD + SLOTS * kBN * LD + kBM * PLD +
                          2 * kBM) * sizeof(float);
};

static_assert(FfmaTile<16>::kSmem == 44544, "ffma_tile(16)");
static_assert(FfmaTile<32>::kSmem == 65024, "ffma_tile(32)");
static_assert(FfmaTile<64>::kSmem == 105984, "ffma_tile(64)");
static_assert(FfmaTile<128>::kSmem == 187904, "ffma_tile(128)");
static_assert(FfmaTile<256>::kSmem == 218624, "ffma_tile(256)");

struct Strides {
  long long b, h, s;  // elements; D has unit stride
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  Strides sq, sk, sv, so;
  int heads, kv_heads, len_q, len_k;
  int causal;
  int window;     // <= 0: none
  float scale;
  float softcap;  // <= 0: none
};

// Key tiles [kt_begin, kt_end) that rows [q0, q0 + kBM) can see.
__device__ __forceinline__ void key_tiles(const Params& p, int q0,
                                          int& kt_begin, int& kt_end) {
  int k_end = p.len_k;
  if (p.causal) k_end = min(k_end, q0 + kBM);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  kt_begin = k_begin / kBN;
  kt_end = (k_end + kBN - 1) / kBN;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows x D floats from global (row stride `stride`) into smem (row stride
// D + kPadKV) by 16-byte cp.async; rows >= valid are zero-filled.
template <int D>
__device__ __forceinline__ void async_rows(float* dst, const float* src,
                                           long long stride, int rows,
                                           int valid) {
  constexpr int packs = D / 4;
  constexpr int LD = D + kPadKV;
  for (int c = threadIdx.x; c < rows * packs; c += kThreads) {
    const int r = c / packs;
    const int col = (c - r * packs) * 4;
    const bool ok = r < valid;
    const float* from = src + (ok ? r * stride + col : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(smem_addr(dst + r * LD + col)), "l"(from),
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

// VEC consecutive floats: a load from shared memory, a store of O.
template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  float x[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Vec<2> {
  float x[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};
template <>
struct Vec<1> {
  float x[1];
  __device__ __forceinline__ void load(const float* p) { x[0] = *p; }
  __device__ __forceinline__ void store(float* p) const { *p = x[0]; }
};

template <int D>
__global__ void __launch_bounds__(kThreads, FfmaTile<D>::kMinBlocks)
flash_ffma_kernel(const Params p) {
  using Tile = FfmaTile<D>;
  constexpr int LD = Tile::LD, PLD = Tile::PLD, SLOTS = Tile::SLOTS;
  constexpr int VEC = Tile::VEC, NCH = Tile::NCH;

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                     // [kBM][LD]
  float* sKV = sQ + kBM * LD;           // [SLOTS][kBN][LD]
  float* sP = sKV + SLOTS * kBN * LD;   // [kBM][PLD]
  float* sRed = sP + kBM * PLD;         // [2][kBM]: one entry per warp half

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x - b * p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * kBM;

  const float* q = p.q + b * p.sq.b + h * p.sq.h;
  const float* k = p.k + b * p.sk.b + kvh * p.sk.h;
  const float* v = p.v + b * p.sv.b + kvh * p.sv.h;
  float* o = p.o + b * p.so.b + h * p.so.h;

  // Warp w covers row groups 4(w/2) .. +3 and key groups 8(w%2) .. +7.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = warp & 1;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty + 16i
  const int tx = half * 8 + (lane & 7);          // keys tx + 16j

  int kt_begin, kt_end;
  key_tiles(p, q0, kt_begin, kt_end);
  const int copies = 2 * (kt_end - kt_begin);

  // Copy c of the ring: K (c even) or V (c odd) of tile kt_begin + c/2,
  // into slot c % SLOTS; one commit group each, empty past the last tile.
  auto issue = [&](int c) {
    if (c < copies) {
      const int n0 = (kt_begin + (c >> 1)) * kBN;
      const bool is_v = c & 1;
      const long long stride = is_v ? p.sv.s : p.sk.s;
      async_rows<D>(sKV + (c % SLOTS) * kBN * LD,
                    (is_v ? v : k) + n0 * stride, stride, kBN,
                    min(kBN, p.len_k - n0));
    }
    async_commit();
  };

  async_rows<D>(sQ, q + q0 * p.sq.s, p.sq.s, kBM, min(kBM, p.len_q - q0));
#pragma unroll
  for (int c = 0; c < SLOTS - 1; ++c) issue(c);  // Q joins copy 0's group

  // Logits in the log2 domain: exp(x) = 2^(x log2 e).
  const float scale_log2 = p.scale * kLog2e;
  const bool capped = p.softcap > 0.f;
  const float cap_in = capped ? p.scale / p.softcap : 0.f;
  const float cap_out = p.softcap * kLog2e;

  float m[4], l[4];
  float acc[4][NCH][VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = 0; t < kt_end - kt_begin; ++t) {
    const int n0 = (kt_begin + t) * kBN;

    // ---- copy 2t: K(t). S = Q K^T for 4 rows x 4 keys.
    async_wait<SLOTS - 2>();
    __syncthreads();  // K(t) (and Q) landed; no thread still reads V(t-1)
    issue(2 * t + SLOTS - 1);
    const float* tK = sKV + ((2 * t) % SLOTS) * kBN * LD;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll(D / 4 < 8 ? D / 4 : 8)
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(tK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // Scale (and softcap) into the log2 domain; mask only where the tile
    // crosses the causal diagonal, the window's edge or the end of the keys.
    const bool need_mask = (p.causal && n0 + kBN - 1 > q0) ||
                           (p.window > 0 && n0 <= q0 + kBM - 1 - p.window) ||
                           n0 + kBN > p.len_k;
    float mt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mt[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = capped ? cap_out * tanhf(s[i][j] * cap_in)
                         : s[i][j] * scale_log2;
        if (need_mask) {
          const int row = q0 + ty + 16 * i;
          const int col = n0 + tx + 16 * j;
          bool ok = col < p.len_k;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && col > row - p.window;
          x = ok ? x : kNegInf;
        }
        s[i][j] = x;
        mt[i] = fmaxf(mt[i], x);
      }
      // over the 8 key groups of this warp, then the other half's
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 4));
    }
    if ((lane & 7) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sRed[half * kBM + ty + 16 * i] = mt[i];
    }
    __syncthreads();  // both halves' maxima (P of tile t-1 is read by now)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float m_new = fmaxf(m[i], fmaxf(sRed[r], sRed[kBM + r]));
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = s[i][j] == kNegInf ? 0.f : exp2f(s[i][j] - m_new);
        ls += pe;
        sP[r * PLD + tx + 16 * j] = pe;
      }
      l[i] = l[i] * alpha + ls;  // this thread's keys; summed at the end
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][c][e] *= alpha;
    }

    // ---- copy 2t + 1: V(t). O += P V for 4 rows x D/16 columns.
    async_wait<SLOTS - 2>();
    __syncthreads();  // V(t) landed and P visible; no thread still reads K(t)
    issue(2 * t + SLOTS);
    const float* tV = sKV + ((2 * t + 1) % SLOTS) * kBN * LD;
#pragma unroll 4
    for (int kk = 0; kk < kBN; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * PLD + kk);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const float* vrow = tV + (kk + e4) * LD;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          Vec<VEC> vb;
          vb.load(vrow + (c * 16 + tx) * VEC);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = e4 == 0 ? pa[i].x : e4 == 1 ? pa[i].y
                           : e4 == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][c][e] = fmaf(pi, vb.x[e], acc[i][c][e]);
          }
        }
      }
    }
  }
  async_wait<0>();  // no copy outstanding at exit (an empty key range)

  // Each row's sum over its 16 key groups: 8 lanes, then the two halves.
  // The last reads of sRed came before the last tile's second barrier.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
  if ((lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sRed[half * kBM + ty + 16 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= p.len_q) continue;
    const float denom = fmaxf(sRed[r] + sRed[kBM + r], 1e-30f);
    float* orow = o + row * p.so.s;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      Vec<VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) out.x[e] = acc[i][c][e] / denom;
      out.store(orow + (c * 16 + tx) * VEC);
    }
  }
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using Tile = FfmaTile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_ffma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_ffma_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: batch*head; y: query tile, taken heaviest first by every head
  const dim3 grid(batch * p.heads, (p.len_q + kBM - 1) / kBM);
  flash_ffma_kernel<D><<<grid, kThreads, Tile::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o = attention(q, k, v) in float32 as described at the top of this file.
// strides: 12 element strides, (batch, head, seq) of q, k, v and o in that
// order; every operand has unit stride on the head dimension d (16, 32,
// 64, 128 or 256), and every stride and pointer keeps 16-byte rows.
// window <= 0 means none; softcap <= 0 means none.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int repro_flash_attention_ffma(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int batch, int heads, int kv_heads, int len_q,
    int len_k, int head_dim, int causal, int window, float softcap,
    void* stream) {
  if (batch <= 0 || len_q <= 0) return static_cast<int>(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 || len_k < 0 ||
      (len_q + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.causal = causal;
  p.window = window;
  p.scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, batch, s);
    case 32: return launch<32>(p, batch, s);
    case 64: return launch<64>(p, batch, s);
    case 128: return launch<128>(p, batch, s);
    case 256: return launch<256>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
