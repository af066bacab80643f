// Blocked online-softmax attention (prefill) in bfloat16 for NVIDIA Hopper
// (sm_90a) at head_dim 16 and 32 (the smoke configs' widths): design
// "mma_sync" of kernels/flash_attention.py. bfloat16 at head_dim 64, 128 and
// 256, the models' widths, is served by flash_attention_wgmma.cu (wgmma +
// TMA), and float32 at every head_dim by flash_attention_ffma.cu; the
// wrapper's design() is the table that picks one.
//
// Replaces the TPU kernel `flash_attention` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention.py for those (dtype, head_dim) pairs:
//
//     o[b,h,i] = sum_j softmax_j(mask(cap*tanh((q_i . k_j) * D^-0.5 / cap))) v_j
//
// with q [B,H,Sq,D], k/v [B,KV,Sk,D], KV head of query head h = h / (H/KV)
// (GQA), key j valid for query i when j <= i (causal) and j > i - window
// (sliding window), running (max, sum, acc) in float32, a row with no valid
// key giving zeros, and out = acc / max(l, 1e-30).
//
// Bound: operations. A causal attention layer does 4*B*H*D flops
// per live (query, key) pair against 2 bytes per element moved once, far
// above the card's flops-per-byte ridge, so the work has to be on the
// tensor cores. What the design does about that:
//   * one block of 4 warps per (batch*head, 64-query tile); each warp owns
//     16 query rows and runs Q.K^T and P.V as mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate) out of shared memory; P stays in registers between
//     the two products (the accumulator fragment of S is the A fragment of
//     P.V). P is rounded to bf16 for the P.V product, as the JAX model path
//     rounds its probabilities; the row sums use the fp32 P. Q, K and V
//     fragments come from shared memory by ldmatrix (V transposed); rows
//     are padded by 16 bytes so that none of them has bank conflicts. K/V
//     tiles are double-buffered with cp.async, so the next tile's copy
//     overlaps this tile's products.
//   * the softmax runs in the log2 domain (one multiply folds D^-0.5 and
//     log2 e, then ex2.approx), and the mask is evaluated only on tiles
//     that cross the causal diagonal, the window's edge or the end of the
//     keys.
//   * the k-tile loop runs only over the tiles that the causal and window
//     reach of the block's rows can see (the TPU kernel's `pl.when(live)`),
//     and the q-tiles are scheduled heaviest first.
//   * the kernel takes element strides for batch, head and sequence (unit
//     stride on D), so the model hands it [B,S,H,D] activations as
//     transposed views and no copy is made.
//
// Plain C interface (loaded with ctypes); the launcher returns the
// cudaError_t of the launch as an int and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements; D has unit stride
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, kv_heads, len_q, len_k;
  int causal;
  int window;     // <= 0: none
  float scale;
  float softcap;  // <= 0: none
};

// Key tiles [kt_begin, kt_end) that rows [q0, q0 + rows) can see.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int rows,
                                          int bn, int& kt_begin,
                                          int& kt_end) {
  int k_end = p.len_k;
  if (p.causal) k_end = min(k_end, q0 + rows);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  kt_begin = k_begin / bn;
  kt_end = (k_end + bn - 1) / bn;
}

// ---- bfloat16: mma.sync ---------------------------------------------------

template <int D>
struct Bf16Tile {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BM = 16 * kWarps;        // query rows (16 per warp)
  static constexpr int BN = 64;                 // keys per tile
  static constexpr int LD = D + 8;              // padded smem row (elements)
  // Q, then two stages of K and of V.
  static constexpr size_t kSmem =
      static_cast<size_t>(BM + 4 * BN) * LD * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows x D tile from global (row stride `stride`) into smem (row stride
// ld) by 16-byte cp.async; rows >= valid are zero-filled (src-size 0).
__device__ __forceinline__ void async_tile_bf16(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* src,
                                                long long stride, int rows,
                                                int valid, int d) {
  const int packs = d / 8;
  for (int c = threadIdx.x; c < rows * packs; c += blockDim.x) {
    const int r = c / packs;
    const int col = (c - r * packs) * 8;
    const bool ok = r < valid;
    const __nv_bfloat16* from = src + (ok ? r * stride + col : 0);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

constexpr float kLog2e = 1.4426950408889634f;

// Fragment layouts of mma.m16n8k16 (lane = 4g + t): A holds rows g, g+8 at
// columns 2t, 2t+1 (+8); B holds k rows 2t, 2t+1 (+8) at column g; C holds
// rows g, g+8 at columns 2t, 2t+1. The C fragment of S = QK^T is thus the A
// fragment of P.V, and ldmatrix gives the others from row-major smem: Q
// (A, x4), K (B of K^T, x4 without transpose), V (B, x4 transposed).
template <int D>
__global__ void __launch_bounds__(Bf16Tile<D>::kThreads)
flash_bf16_kernel(const Params p) {
  using Tile = Bf16Tile<D>;
  constexpr int BM = Tile::BM, BN = Tile::BN, LD = Tile::LD;
  constexpr int NT = BN / 8;   // 8-key column tiles of S
  constexpr int DT = D / 8;    // 8-wide column tiles of O
  constexpr int KQ = D / 16;   // k-steps of Q.K^T
  constexpr int KP = BN / 16;  // k-steps of P.V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LD;       // [2][BN][LD]
  __nv_bfloat16* sV = sK + 2 * BN * LD;   // [2][BN][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * BM;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.sk.b + kvh * p.sk.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.sv.b + kvh * p.sv.h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b +
                     h * p.so.h;

  int kt_begin, kt_end;
  key_tiles(p, q0, BM, BN, kt_begin, kt_end);

  auto load_kv = [&](int kt, int stage) {
    const int n0 = kt * BN;
    const int valid = min(BN, p.len_k - n0);
    async_tile_bf16(sK + stage * BN * LD, LD, k + n0 * p.sk.s, p.sk.s, BN,
                    valid, D);
    async_tile_bf16(sV + stage * BN * LD, LD, v + n0 * p.sv.s, p.sv.s, BN,
                    valid, D);
  };

  async_tile_bf16(sQ, LD, q + q0 * p.sq.s, p.sq.s, BM, min(BM, p.len_q - q0),
                  D);
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row half of the fragment
  const int t = lane & 3;   // column pair within the fragment
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  // Logits are kept in the log2 domain: exp(x) = 2^(x log2 e).
  const float scale_log2 = p.scale * kLog2e;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, stage ^ 1);  // overlaps this tile's products
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q) visible to every warp
    const __nv_bfloat16* tK = sK + stage * BN * LD;
    const __nv_bfloat16* tV = sV + stage * BN * LD;
    const int n0 = kt * BN;

    // S = Q K^T for this warp's 16 rows x BN keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* qrow =
        sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
    if constexpr (KQ == 1) {
      uint32_t a[4];
      ldmatrix_x4(a, qrow);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, tK + (j * 8 + (lane & 7)) * LD +
                                ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], a, b0, b1);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KQ; kk += 2) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, qrow + kk * 16);
        ldmatrix_x4(a1, qrow + kk * 16 + 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bk[4];
          ldmatrix_x4(bk, tK + (j * 8 + (lane & 7)) * LD + kk * 16 +
                              (lane >> 3) * 8);
          mma_bf16(s[j], a0, bk[0], bk[1]);
          mma_bf16(s[j], a1, bk[2], bk[3]);
        }
      }
    }

    // Scale (and softcap) into the log2 domain; mask only where this tile
    // crosses the causal diagonal, the window's edge or the end of the keys.
    const bool need_mask = (p.causal && n0 + BN - 1 > q0) ||
                           (p.window > 0 && n0 <= q0 + BM - 1 - p.window) ||
                           n0 + BN > p.len_k;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (p.softcap > 0.f) {
          x = p.softcap * tanhf(s[j][e] * p.scale / p.softcap) * kLog2e;
        } else {
          x = s[j][e] * scale_log2;
        }
        if (need_mask) {
          const int row = row0 + (e >> 1) * 8;
          const int col = n0 + j * 8 + 2 * t + (e & 1);
          bool ok = col < p.len_k;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && col > row - p.window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }

    // P = 2^(S - m), packed as the A fragments of P.V.
    uint32_t pa[KP][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = s[j][e] == kNegInf ? 0.f : ex2(s[j][e] - m[e >> 1]);
      }
      ls[0] += pe[0] + pe[1];
      ls[1] += pe[2] + pe[3];
      const int half = (j & 1) * 2;
      pa[j >> 1][half + 0] = pack_bf16(pe[0], pe[1]);
      pa[j >> 1][half + 1] = pack_bf16(pe[2], pe[3]);
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V, two 8-wide column tiles of O per ldmatrix.
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const __nv_bfloat16* vrow =
          tV + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + i * 8);
        mma_bf16(acc[i], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[i + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }
  async_wait<0>();  // no copy outstanding at exit (an empty key range)

  // The four threads of a row group hold partial sums of the same rows.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float denom = fmaxf(lr, 1e-30f);
    const int row = row0 + r * 8;
    if (row >= p.len_q) continue;
    __nv_bfloat16* orow = o + row * p.so.s + 2 * t;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
          __floats2bfloat162_rn(acc[i][2 * r] / denom,
                                acc[i][2 * r + 1] / denom);
    }
  }
}

// ---- launch ---------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  using Tile = Bf16Tile<D>;
  cudaError_t err = allow_smem(flash_bf16_kernel<D>, Tile::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.len_q + Tile::BM - 1) / Tile::BM, batch * p.heads);
  flash_bf16_kernel<D><<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 at head_dim 64, 128 and 256 is served by
// flash_attention_wgmma.cu, so mma.sync is instantiated only at 16 and 32.
int dispatch_bf16(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_bf16<16>(p, batch, s);
    case 32: return launch_bf16<32>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// o = attention(q, k, v) in bfloat16 as described at the top of this file.
// strides: 12 element strides, (batch, head, seq) of q, k, v and o in that
// order; every operand has unit stride on the head dimension d (16 or 32).
// window <= 0 means none; softcap <= 0 means none.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int batch, int heads, int kv_heads, int len_q,
    int len_k, int head_dim, int causal, int window, float softcap,
    void* stream) {
  if (batch <= 0 || len_q <= 0) return static_cast<int>(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 || len_k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  return dispatch_bf16(p, batch, head_dim, s);
}
