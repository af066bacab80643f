// Blocked online-softmax attention (prefill) for NVIDIA Hopper (sm_90a):
// the bfloat16 design at every head_dim (16, 32, 64, 128, 256), on wgmma
// and TMA.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:96, body `_flash_kernel` :30) for bfloat16 operands
// (Qwen2-0.5B has D = 64; Mistral-Large, Mixtral, LLaVA-NeXT-34B and Jamba
// have 128; Gemma2-2B has 256; the smoke configs 16 and 32); float32 is
// served by csrc/flash_attention_ffma.cu. It computes the same function:
//
//     o[b,h,i] = sum_j softmax_j(mask(cap*tanh((q_i . k_j) * D^-0.5 / cap))) v_j
//
// with q [B,H,Sq,D], k/v [B,KV,Sk,D], KV head of query head h = h / (H/KV)
// (GQA), key j valid for query i when j <= i (causal) and j > i - window
// (sliding window), running (max, sum, acc) in float32, a row with no valid
// key giving zeros, and out = acc / max(l, 1e-30).
//
// Bound: operations. A causal layer does 4*D flops per live (query, key)
// pair and head against 2 bytes per element moved once, far above the
// card's flops-per-byte ridge, so the time is the tensor cores' and the
// softmax's. mma.sync cannot reach the tensor cores' rate on Hopper; only
// wgmma does. Every live pair also costs one ex2 on the SM's 16 MUFU lanes
// (and one tanh under a softcap): at D <= 32 that, not the tensor cores,
// is the bound (at D = 32 a score's 128 tensor flops take 1/30 of a clock
// of an SM, its ex2 1/16), so there the per-score instruction stream is
// the whole design: one FMAX for the row maximum, one FFMA (scale and
// maximum folded), ex2, one FADD into the row sum and half a packed
// cvt.rn.bf16x2, nothing else. At D = 256 a score costs 1024 tensor
// flops, about a quarter of an SM's clock at 989 TFLOP/s, and the
// softmax's scalar work per score (the softcap's tanh, ex2, the mask,
// rescaling O) is of the same order, so there the softmax may set the
// pace. Gemma2-2B's layers at 8 x 8192 tokens: the local one (window 4096,
// 2 requests) does 0.41 TFLOP of live pairs, 0.417 ms at 989 TFLOP/s; the
// global one (causal) 2.20 TFLOP, 2.224 ms. What the design does about
// that:
//   * one block per (128-query tile, batch*head), heaviest causal tiles
//     first. At D <= 128, in three warpgroups: warpgroup 0 is the
//     producer, one thread of which issues TMA copies of the block's Q
//     tile (once) and of K and V tiles into a ring of kStages slots, each
//     slot with a "full" mbarrier (the copy's bytes arrived) and an
//     "empty" one (both consumers are done with it). It gives its
//     registers up (setmaxnreg.dec) to the two consumer warpgroups
//     (setmaxnreg.inc), which own 64 query rows each;
//   * at D = 256 the block is the two consumer warpgroups alone. ptxas
//     allocates a kernel's registers for its launch (setmaxnreg changes
//     nothing there): 384 threads put 3 warps on each SM sub-partition's
//     16384 registers, 168 a thread, where a D = 256 consumer needs ~250
//     (on the H100, at 384 threads ptxas spilled about 1 KB a thread and
//     serialised every wgmma, and the kernel took twice as long as at 256
//     threads, 252 registers, no spill). So thread 0 copies Q and the first
//     kStages tiles, and each slot has a counter in place of its "empty"
//     barrier: lane 0 of each consumer warp adds one when its P.V of the
//     slot's tile has retired, and the eighth copies the slot's next tile
//     in (no thread waits for another to refill);
//   * per K/V tile a consumer computes S = Q.K^T as wgmma m64nBNk16 with
//     both operands in shared memory (K-major, swizzled at the row's
//     width: 32, 64 or 128 bytes at D = 16, 32, >= 64), runs the
//     online softmax on the accumulator registers, rounds P to bf16 in
//     registers (the accumulator fragment of S, packed in pairs, is the
//     register A fragment of the next product), and computes O += P.V as
//     wgmma m64nDk16 with A from registers and V from shared memory,
//     MN-major (transposed descriptor). The slot is released once that
//     product has retired;
//   * at D = 64 the two consumers take turns at the tensor cores (ping-pong
//     on named barriers): in its turn one issues Q.K^T of its next tile
//     and P.V of this one, waits only for Q.K^T, and runs the next softmax
//     while its own P.V and the other's products run, so the softmax of
//     one warpgroup hides behind the products. At D = 128 and 256 that
//     keeps S, P and O live at once, more than ptxas holds without spilling
//     and serialising the products, so there each consumer waits for each
//     product in turn and the two run side by side (measured faster on the
//     H100 at D = 128). So they do at D <= 32, where the products are short
//     beside the softmax and the turns only held each consumer back until
//     the other had finished its softmax (measured slower on the H100);
//   * 128-row blocks: each K/V tile is read by half as many blocks as with
//     64-row tiles, and a TMA copy costs the consumers few instructions
//     and no registers. K/V tiles are 128 keys at D <= 128 (BM == BN)
//     and 64 keys at D = 256: there O is m64n256 in fp32, 128
//     registers a consumer thread, and S (32) + P (16) of a 64-key tile
//     keep the total within 255, where a 128-key tile (64 + 32) would
//     spill. Shared memory at D = 256 is Q 64 KB + 2 stages x (K 32 KB +
//     V 32 KB) = 192 KB; a third stage would need 256 KB. Q.K^T is then
//     m64n64k16 over 16 k-steps (four 64-column swizzle atoms of Q and of
//     K, BM and BN rows apart) and P.V m64n256k16 (wgmma's widest N) over
//     4. At D = 16 and 32 a row is one swizzle atom wide (32 or 64
//     bytes, 8-row atoms of 256 or 512 bytes): Q.K^T is m64n128k16 over
//     1 or 2 k-steps, each 32 bytes further along the row, and P.V
//     m64n16k16 or m64n32k16 over 8 with V MN-major one atom wide. A K or
//     V tile is 4 or 8 KB, so the ring has 4 stages (37 / 73 KB in all);
//   * the softmax is the other half of the time (one ex2 per score, on 16
//     lanes an SM), so its instruction stream is kept short: log2 domain,
//     and on tiles that need no mask and no softcap the raw scores' row
//     maximum and one FFMA per score fold D^-0.5 * log2 e into the
//     exponent; maxima and sums run in independent chains. Tiles that carry
//     a softcap take one multiply, tanh.approx.f32 (one MUFU op, where the
//     precise tanhf is two and a dozen FMAs and was slower at Gemma2's
//     layers on the H100) and one multiply a score (scale/cap
//     and cap*log2 e folded); only tiles that cross the causal diagonal,
//     the window's edge or the end of the keys evaluate the mask (after
//     the softcap). P is rounded to bf16 for P.V (as the JAX model path
//     rounds its probabilities); row sums use fp32 P;
//   * the k-tile loop covers only the tiles that the causal and window
//     reach of the block's rows can see (the TPU kernel's `pl.when(live)`);
//   * each operand is described to TMA as a 4-D tensor (D, S, heads, B)
//     with its own byte strides (computed by the Python wrapper), so the
//     model's [B,S,H,D] activations go in as transposed views, no copy.
//     TMA fills rows past S with zeros, which is how any Sq/Sk is taken;
//     the output is written from registers into [B,Sq,H,D] memory and
//     rows >= Sq are not written.
// Every mbarrier wait is bounded: a wait that outlasts kHangCycles traps,
// so a fault in the pipeline becomes a launch error, not a hung card.
//
// Plain C interface (loaded with ctypes). The tensor maps are encoded on
// the host at each call through the driver's cuTensorMapEncodeTiled,
// reached by cudaGetDriverEntryPoint (cuda.h gives its types only; nothing
// links libcuda). The launcher returns 0, a cudaError_t, or a negative
// code for a tensor map that could not be encoded, and never synchronises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int BM = 128;          // query rows per block, 64 per consumer
constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr uint32_t kConsumerWarps = kConsumerThreads / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128*24 + 256*240 = 384*168 registers
constexpr size_t kMaxSmem = 232448;  // what one block may use (227 KB)
constexpr long long kHangCycles = 1LL << 32;  // about 2 s at 1.98 GHz

// Shared memory, from a 1024-byte-aligned base (the largest swizzle atom's
// alignment): Q [kSub][BM rows x kRowBytes], then kStages slots of K and of
// V, each [kSub][BN rows x kRowBytes] (column atom a holds columns
// kAtomCols*a onwards), then the mbarriers.
template <int D>
struct Cfg {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "wgmma design: head_dim 16, 32, 64, 128 or 256");
  // A swizzle row holds 64 bf16 columns (128 bytes) at D >= 64 and the
  // whole row (32 or 64 bytes) below; its swizzle span is its width, and
  // eight rows make one swizzle atom.
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr uint32_t kRowBytes = 2 * kAtomCols;
  static constexpr uint32_t kAtomBytes = 8 * kRowBytes;
  static constexpr int kSub = D / kAtomCols;
  // Matrix descriptor layout type (bits 62-63): 1 = 128-byte swizzle,
  // 2 = 64-byte, 3 = 32-byte.
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  // k16 steps (32 bytes each) along one swizzle row.
  static constexpr int kStepsPerRow = kRowBytes / 32;
  // Keys per K/V tile. At D = 256, O alone is 128 registers a consumer
  // thread; with S and P of a 64-key tile (32 + 16) it fits the 240 of
  // kConsumerRegs, with a 128-key tile (64 + 32) it would spill. Two
  // 64-key stages of K and V (128 KB) also fit beside Q (64 KB), where
  // one 128-key stage would take 128 KB and leave no ring.
  static constexpr int BN = D == 256 ? 64 : 128;
  // At D = 64 a slot is released only once P.V of its tile has run on
  // into the next tile's softmax, so the ring needs a third slot to keep
  // the next loads ahead of the products (112 KB at D = 64; 160 KB at
  // D = 128, 192 KB at D = 256). At D <= 32 a K or V tile is 4 or 8 KB,
  // and four slots are cheap.
  static constexpr int kStages = D <= 32 ? 4 : (D == 64 ? 3 : 2);
  // Ping-pong (see the file comment) keeps S, P and O in registers at once;
  // at D >= 128 that is more than ptxas can hold without serialising the
  // products, so there the two products of a tile are waited for in turn.
  // At D <= 32 the products are short beside the softmax, and the turns
  // only held each consumer back until the other had finished its softmax
  // (measured slower on the H100), so there too each product is waited
  // for in turn.
  static constexpr bool kPingPong = D == 64;
  // A producer warpgroup that hands its registers to the consumers
  // (setmaxnreg) at D <= 128. ptxas allocates every thread of the
  // kernel within one SM sub-partition's 16384 registers for the warps
  // placed there (3 of 12 warps -> 168), setmaxnreg or not, and at D =
  // 256 a consumer needs more (O 128 + S 32 + P 16 and addresses: 988 bytes
  // spilled and wgmma serialised at 384 threads, also at 288). So at D =
  // 256 the block is the two consumer warpgroups alone (2 warps a
  // sub-partition -> 255 registers): one consumer thread loads Q and the
  // first kStages tiles, and the last consumer warp done with a slot
  // loads the slot's next tile (a counter per slot, no wait).
  static constexpr bool kProducerWarpgroup = D != 256;
  static_assert(kProducerWarpgroup || !kPingPong, "ping-pong needs a producer");
  static constexpr int kThreads = kConsumerThreads + (kProducerWarpgroup ? 128 : 0);
  static constexpr uint32_t kQSubBytes = BM * kRowBytes;   // a column atom
  static constexpr uint32_t kKVSubBytes = BN * kRowBytes;  // of Q; of K or V
  static constexpr uint32_t kQBytes = kSub * kQSubBytes;
  static constexpr uint32_t kKVBytes = kSub * kKVSubBytes;  // a K or V tile
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  static constexpr size_t kSmem = kBar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kSmem <= kMaxSmem,
                "Q and the ring exceed a block's smem");
};

// The tile table that flash_attention.wgmma_tile() mirrors (the CPU test
// reads these lines): keys a tile, ring stages, swizzle bytes and shared
// memory of a block, at each head_dim.
static_assert(Cfg<16>::BN == 128 && Cfg<16>::kStages == 4 &&
              Cfg<16>::kRowBytes == 32 && Cfg<16>::kSmem == 37960, "D 16");
static_assert(Cfg<32>::BN == 128 && Cfg<32>::kStages == 4 &&
              Cfg<32>::kRowBytes == 64 && Cfg<32>::kSmem == 74824, "D 32");
static_assert(Cfg<64>::BN == 128 && Cfg<64>::kStages == 3 &&
              Cfg<64>::kRowBytes == 128 && Cfg<64>::kSmem == 115768, "D 64");
static_assert(Cfg<128>::BN == 128 && Cfg<128>::kStages == 2 &&
              Cfg<128>::kRowBytes == 128 && Cfg<128>::kSmem == 164904,
              "D 128");
static_assert(Cfg<256>::BN == 64 && Cfg<256>::kStages == 2 &&
              Cfg<256>::kRowBytes == 128 && Cfg<256>::kSmem == 197672,
              "D 256");

struct Params {
  void* o;
  long long o_b, o_h, o_s;  // elements; D has unit stride
  int heads, kv_heads, len_q, len_k;
  int causal;
  int window;     // <= 0: none
  float scale;
  float softcap;  // <= 0: none
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void smem_store(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Adds one to a shared counter and returns its old value; acq_rel orders
// this warp's finished reads of a slot before the load that refills it.
__device__ __forceinline__ uint32_t smem_inc(uint32_t addr) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "r"(addr)
               : "memory");
  return old;
}

// Waits for the phase of `bar` with this parity to complete; traps (a
// launch error at the next synchronisation) after kHangCycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kHangCycles) __trap();
  }
}

// One box (a column atom x BM or BN rows of one head of one batch entry) of a
// 4-D tensor map (D, S, heads, B) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled operand: start address,
// leading- and stride-dimension byte offsets (16-byte units) and the
// layout type (Cfg::kLayout) in bits 62-63; base offset 0, as every tile
// starts on its swizzle atom. K-major (Q, K): rows kRowBytes apart inside
// an 8-row atom, SBO from one atom to the next, LBO unused (1). MN-major
// (V): LBO from one column atom to the next, SBO from one 8-key atom to
// the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Named barrier `id` (1 or 2) over the two consumer warpgroups: wait for
// the turn, or pass it to the warpgroup that waits on `id`. The ids are
// immediates (a register id makes ptxas reserve all 16 barriers).
__device__ __forceinline__ void turn_wait(int id) {
  if (id == 1) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
  }
}

__device__ __forceinline__ void turn_pass(int id) {
  if (id == 1) {
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  } else {
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  }
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
  }
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T with A and B in shared memory,
// both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T with A and B in shared memory,
// both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                uint64_t desc_a,
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16] with A in registers (bf16 pairs)
// and B in shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32] with A in registers (bf16 pairs)
// and B in shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64] with A in registers (bf16 pairs)
// and B in shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128] with A in registers (bf16 pairs)
// and B in shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256] with A in registers (bf16 pairs)
// and B in shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S (+)= Q.K^T over one k16 step of a BN-key tile.
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2], uint64_t desc_q,
                                         uint64_t desc_k, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n64k16_ss(s, desc_q, desc_k, scale_d);
  } else {
    wgmma_m64n128k16_ss(s, desc_q, desc_k, scale_d);
  }
}

// O += P.V over one k16 step, N = D.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 16) {
    wgmma_m64n16k16_rs(o, a, desc_v);
  } else if constexpr (D == 32) {
    wgmma_m64n32k16_rs(o, a, desc_v);
  } else if constexpr (D == 64) {
    wgmma_m64n64k16_rs(o, a, desc_v);
  } else if constexpr (D == 128) {
    wgmma_m64n128k16_rs(o, a, desc_v);
  } else {
    wgmma_m64n256k16_rs(o, a, desc_v);
  }
}

// ---- the kernel ---------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One MUFU op (relative error about 2^-11) where tanhf takes two and a
// dozen FMAs. The softcap's logits are bounded by cap, so its error in a
// logit is at most cap * 2^-11 absolute and usually |logit| * 2^-11; held
// on the card against the plain version's precise tanh at the data-scaled
// limit (chip_smoke.py), whose largest error over the limit did not move
// from the tanhf build's.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment layouts (PTX ISA, wgmma m64nNk16): warp w of a warpgroup holds
// rows 16w + g and 16w + g + 8 (lane = 4g + t). Accumulator element 4j + e
// is row 16w + g + 8*(e >> 1), column 8j + 2t + (e & 1). The register A
// fragment of a k16 step holds the same rows at columns 2t, 2t+1 (regs 0,
// 1) and 2t+8, 2t+9 (regs 2, 3): the S accumulator's chunks 2kk and 2kk+1,
// packed in pairs, are P's A fragment for keys 16kk .. 16kk+15.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + C::kK;
  const uint32_t sV = base + C::kV;
  const uint32_t q_full = base + C::kBar;
  const uint32_t full0 = q_full + 8;                 // [kStages]
  const uint32_t empty0 = full0 + 8 * kStages;       // [kStages]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * BM;

  // Key tiles [kt_begin, kt_end) that rows q0 .. q0 + BM - 1 can see.
  int k_end = p.len_k;
  if (p.causal) k_end = min(k_end, q0 + BM);
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_begin / BN;
  const int n_tiles = max(0, (k_end + BN - 1) / BN - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      if constexpr (C::kProducerWarpgroup) {
        mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
      } else {
        smem_store(empty0 + 8 * s, 0u);  // releases of the slot so far
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The Q tile, and tile i of the k-tile loop into its slot.
  auto load_q = [&]() {
    mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
    for (int a = 0; a < C::kSub; ++a) {
      tma_load(sQ + a * C::kQSubBytes, &tq, a * C::kAtomCols, q0, h, b,
               q_full);
    }
  };
  auto load_kv = [&](int i) {
    const int stage = i % kStages;
    const uint32_t full = full0 + 8 * stage;
    mbar_expect_tx(full, 2 * C::kKVBytes);
    const int n0 = (kt_begin + i) * BN;
#pragma unroll
    for (int a = 0; a < C::kSub; ++a) {
      const uint32_t off = stage * C::kKVBytes + a * C::kKVSubBytes;
      tma_load(sK + off, &tk, a * C::kAtomCols, n0, kvh, b, full);
      tma_load(sV + off, &tv, a * C::kAtomCols, n0, kvh, b, full);
    }
  };
  if constexpr (!C::kProducerWarpgroup) {
    if (threadIdx.x == 0) {
      load_q();
      for (int i = 0; i < min(kStages, n_tiles); ++i) load_kv(i);
    }
  }

  // Threads [0, 128) are the producer warpgroup and [128, 384) the two
  // consumers; without a producer warpgroup, [0, 256) are the consumers.
  const int wg = threadIdx.x / 128;
  if (C::kProducerWarpgroup && wg == 0) {
    // ---- producer -----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      load_q();
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(empty0 + 8 * (i % kStages), ((i / kStages) & 1) ^ 1);
        load_kv(i);
      }
    }
  } else {
    // ---- consumers: rows q0w .. q0w + 63 ------------------------------------
    if constexpr (C::kProducerWarpgroup) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    }
    const int cw = C::kProducerWarpgroup ? wg - 1 : wg;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int q0w = q0 + 64 * cw;
    const int row0 = q0w + 16 * warp + g;  // this thread's rows: row0, row0+8
    const float scale_log2 = p.scale * kLog2e;
    const bool capped = p.softcap > 0.f;
    const float cap_in = capped ? p.scale / p.softcap : 0.f;
    const float cap_log2 = p.softcap * kLog2e;
    // This warpgroup's 64 rows of Q: 8 swizzle atoms down each column atom.
    const uint32_t sQw = sQ + 64 * cw * C::kRowBytes;

    float o[D / 2];
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    // S = Q K^T of the tile in `slot`: D/16 k-steps; a step moves 32 bytes
    // along a swizzled row (kStepsPerRow steps a row: 1, 2 or 4), then on
    // to the next column atom (Q's and K's atoms lie BM and BN rows apart).
    auto issue_qk = [&](int slot) {
      const uint32_t tK = sK + slot * C::kKVBytes;
      constexpr int kRow = C::kStepsPerRow;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % kRow) * 32;
        wgmma_qk<BN>(
            s,
            smem_desc(sQw + (kk / kRow) * C::kQSubBytes + col, 16,
                      C::kAtomBytes, C::kLayout),
            smem_desc(tK + (kk / kRow) * C::kKVSubBytes + col, 16,
                      C::kAtomBytes, C::kLayout),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: BN/16 k-steps of 16 keys (2 swizzle atoms); V is MN-major:
    // SBO steps 8 keys, LBO steps to the next column atom (none at D <= 64,
    // where N = D is one atom wide).
    auto issue_pv = [&](int slot, const uint32_t (&pa)[BN / 16][4]) {
      const uint32_t tV = sV + slot * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_pv<D>(o, pa[kk],
                    smem_desc(tV + kk * 2 * C::kAtomBytes, C::kKVSubBytes,
                              C::kAtomBytes, C::kLayout));
      }
      wgmma_commit();
    };

    // With kPingPong the two consumers take turns at the tensor cores
    // (named barriers 1 and 2, 256 threads each): in its turn a warpgroup
    // issues Q.K^T of the next tile and P.V of this one, then passes the
    // turn and runs the next softmax while its P.V and the other's
    // products run. Each warpgroup takes n_tiles + 1 turns; consumer 0
    // goes first, and consumer 1 passes one turn fewer than it is given,
    // so every barrier phase completes. Without it each product is waited
    // for in turn.
    const int my_turn = 1 + cw;
    const int their_turn = 2 - cw;
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if constexpr (C::kPingPong) {
        if (cw == 1) turn_pass(1);
        turn_wait(my_turn);
      }
      mbar_wait(full0, 0);
      wgmma_fence();
      issue_qk(0);
      if constexpr (C::kPingPong) turn_pass(their_turn);
      wgmma_wait_all();
      fence_regs(s);
    }
    uint32_t pa[BN / 16][4];
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int n0 = (kt_begin + i) * BN;

      // Online softmax in the log2 domain (exp(x) = 2^(x log2 e)). Tiles
      // that cross the causal diagonal, the window's edge or the end of the
      // keys for this warpgroup's rows, and every tile under softcap, take
      // the general path: s becomes the scaled (capped) logit, and only
      // tiles that need the mask evaluate it. Every other tile keeps its
      // raw scores (scale_log2 > 0 commutes with max) and has the scale
      // folded into the exponent's FFMA. Maxima and sums run in four
      // independent chains per row.
      const bool need_mask = (p.causal && n0 + BN - 1 > q0w) ||
                             (p.window > 0 && n0 <= q0w + 63 - p.window) ||
                             n0 + BN > p.len_k;
      const bool general = need_mask || capped;
      float mc[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) mc[r][c] = kNegInf;
      }
      if (general) {
        if (capped) {
          // cap * tanh(s * scale / cap) * log2 e, one multiply on each side
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            s[i] = cap_log2 * tanh_approx(s[i] * cap_in);
          }
        } else {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) s[i] *= scale_log2;
        }
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row0 + (e >> 1) * 8;
              const int col = n0 + j * 8 + 2 * t + (e & 1);
              bool ok = col < p.len_k;
              if (p.causal) ok = ok && col <= row;
              if (p.window > 0) ok = ok && col > row - p.window;
              s[4 * j + e] = ok ? s[4 * j + e] : kNegInf;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (j & 1) * 2 + (e & 1);
            mc[e >> 1][c] = fmaxf(mc[e >> 1][c], s[4 * j + e]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (j & 1) * 2 + (e & 1);
            mc[e >> 1][c] = fmaxf(mc[e >> 1][c], s[4 * j + e]);
          }
        }
      }
      // x -> 2^(x * sc - m): sc folds the scale in on the fast path.
      const float sc = general ? 1.f : scale_log2;
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = fmaxf(fmaxf(mc[r][0], mc[r][1]), fmaxf(mc[r][2], mc[r][3]));
        mt = general ? mt : mt * scale_log2;
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[r], mt);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        // A row that has seen no valid key yet keeps m = kNegInf; its masked
        // logits (kNegInf) must still give 2^(kNegInf - 0) = 0.
        m_use[r] = m_new == kNegInf ? 0.f : m_new;
      }

      // P = 2^(S - m), packed as the register A fragments of P.V.
      uint32_t pn[BN / 16][4];
      float lc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pe[e] = ex2(fmaf(s[4 * j + e], sc, -m_use[e >> 1]));
          lc[e >> 1][(j & 1) * 2 + (e & 1)] += pe[e];
        }
        const int half = (j & 1) * 2;
        pn[j >> 1][half + 0] = pack_bf16(pe[0], pe[1]);
        pn[j >> 1][half + 1] = pack_bf16(pe[2], pe[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] +
               ((lc[r][0] + lc[r][1]) + (lc[r][2] + lc[r][3]));
      }
      if constexpr (C::kPingPong) {
        // P.V of the previous tile ran during this softmax (nothing is
        // pending at i == 0).
        wgmma_wait_all();
        fence_regs(o);
        if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % kStages));
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // P and O are final before the turn: none of this work moves into it.
      if constexpr (C::kPingPong) {
        // pa still feeds the P.V in flight until the wait above; the next
        // P was built in pn.
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[k][e] = pn[k][e];
        }
        fence_regs(pa);
      } else {
        fence_regs(pn);
      }
      fence_regs(o);

      if constexpr (C::kPingPong) {
        // Q.K^T of the next tile, then P.V of this one; waiting for all but
        // the last group lets P.V run into the next softmax. The body is
        // the same on every tile (on the last, Q.K^T of this tile again,
        // unused) so that no product wait sits on a divergent path.
        turn_wait(my_turn);
        wgmma_fence();
        int next = stage;
        if (i + 1 < n_tiles) {
          next = (i + 1) % kStages;
          mbar_wait(full0 + 8 * next, ((i + 1) / kStages) & 1);
        }
        issue_qk(next);
        issue_pv(stage, pa);
        if (cw == 0 || i + 1 < n_tiles) turn_pass(their_turn);
        wgmma_wait_one();
        fence_regs(s);
      } else {
        wgmma_fence();
        issue_pv(stage, pn);
        wgmma_wait_all();
        fence_regs(o);
        if (lane == 0) {
          if constexpr (C::kProducerWarpgroup) {
            mbar_arrive(empty0 + 8 * stage);
          } else if (smem_inc(empty0 + 8 * stage) % kConsumerWarps ==
                         kConsumerWarps - 1 &&
                     i + kStages < n_tiles) {
            load_kv(i + kStages);  // the last warp done with the slot
          }
        }
        if (i + 1 < n_tiles) {
          const int next = (i + 1) % kStages;
          mbar_wait(full0 + 8 * next, ((i + 1) / kStages) & 1);
          wgmma_fence();
          issue_qk(next);
          wgmma_wait_all();
          fence_regs(s);
        }
      }
    }

    if constexpr (C::kPingPong) {
      if (n_tiles > 0) {
        wgmma_wait_all();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty0 + 8 * ((n_tiles - 1) % kStages));
      }
    }

    // The four threads of a quad hold partial sums of the same rows.
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_b +
                         h * p.o_h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      const int row = row0 + r * 8;
      if (row >= p.len_q) continue;
      __nv_bfloat16* orow = out + row * p.o_s + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kNoEncoder = -1000;  // the driver has no cuTensorMapEncodeTiled

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// 4-D map (D, S, heads, B) of a bf16 operand with byte strides (S, heads,
// B); boxes of `cols` columns x `rows` rows, swizzled over `cols` * 2
// bytes (32, 64 or 128: the box's inner bytes never exceed the span),
// zeros past S.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d, int s,
           int heads, int batch, const long long* strides, int cols,
           int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[0]),
                               static_cast<cuuint64_t>(strides[1]),
                               static_cast<cuuint64_t>(strides[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

// Encodes the three maps (Q in BM-row boxes, K and V in BN-row boxes) and
// launches. Zeroed maps for K and V when there are no keys: no tile is
// loaded.
template <int D>
int launch(const void* q, const void* k, const void* v,
           const long long* tma_strides, const Params& p, int batch,
           cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap tq = {}, tk = {}, tv = {};
  int res = encode(fn, &tq, q, D, p.len_q, p.heads, batch, tma_strides,
                   C::kAtomCols, BM);
  if (res == 0 && p.len_k > 0) {
    res = encode(fn, &tk, k, D, p.len_k, p.kv_heads, batch, tma_strides + 3,
                 C::kAtomCols, C::BN);
  }
  if (res == 0 && p.len_k > 0) {
    res = encode(fn, &tv, v, D, p.len_k, p.kv_heads, batch, tma_strides + 6,
                 C::kAtomCols, C::BN);
  }
  if (res != 0) return res;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.len_q + BM - 1) / BM, batch * p.heads);
  flash_wgmma_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv,
                                                                 p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o = attention(q, k, v) as described at the top of this file, bfloat16,
// head_dim 16, 32, 64, 128 or 256. tma_strides: 9 byte strides, (seq, head, batch)
// of q, k and v in that order, each a positive multiple of 16 (the
// wrapper's tensor_map_strides); out_strides: 3 element strides (batch,
// head, seq) of o. Every operand has unit stride on the head dimension and
// a 16-byte aligned start. window <= 0 means none; softcap <= 0 means
// none. Returns 0, the launch's cudaError_t, -CUresult of a refused tensor
// map, or -1000 when the driver offers no cuTensorMapEncodeTiled.
extern "C" int repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o,
    const long long* tma_strides, const long long* out_strides, int batch,
    int heads, int kv_heads, int len_q, int len_k, int head_dim, int causal,
    int window, float softcap, void* stream) {
  if (batch <= 0 || len_q <= 0) return static_cast<int>(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 || len_k < 0 ||
      (head_dim != 16 && head_dim != 32 && head_dim != 64 &&
       head_dim != 128 && head_dim != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.o = o;
  p.o_b = out_strides[0];
  p.o_h = out_strides[1];
  p.o_s = out_strides[2];
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.causal = causal;
  p.window = window;
  p.scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 16) return launch<16>(q, k, v, tma_strides, p, batch, s);
  if (head_dim == 32) return launch<32>(q, k, v, tma_strides, p, batch, s);
  if (head_dim == 64) return launch<64>(q, k, v, tma_strides, p, batch, s);
  if (head_dim == 128) return launch<128>(q, k, v, tma_strides, p, batch, s);
  return launch<256>(q, k, v, tma_strides, p, batch, s);
}
