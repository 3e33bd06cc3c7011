// Flash attention forward for the FFT blocks' self-attention, on Hopper.
//
// Replaces the TPU kernel `_flash_kernel` / `_flash_forward` of
// smart_nar_fast_tts_tpu/ops/pallas/attention.py:52-118: masked
// softmax(QK^T/sqrt(D))V with an online softmax over key tiles, so the
// (Lq, Lk) scores never reach device memory.  It computes the TPU kernel's
// function, rounding where it rounds: q is multiplied by scale = 1/sqrt(D) in
// f32 and then rounded to bf16; k and v are rounded to bf16; scores are
// summed in f32; p = exp(s - m_new) is computed in f32 and only then rounded
// to bf16 for the PV product, which sums in f32; m, l and alpha stay f32.
// exp(x) is taken as exp2(x * log2(e)), the factor applied to f32 scores
// after the product.  An invalid key gets score -1e30 and probability 0; a
// row with no valid key writes 0 (l is clamped at 1e-37).  Query rows past an
// item's length are computed like any other row.
//
// Bound on the H100: at the decoder's serving shapes (D 128, Lq = Lk = 4096,
// a third to all of the keys valid) the two products are ~1000 bf16 FLOP per
// byte of f32 q, k, v and out, above the card's bf16 ridge (~295), so the
// least time is the tensor cores' over the valid keys.
// Design for that (one block per 128 query rows of one (batch, head)):
//  * both products run on the tensor cores as `wgmma` (sm_90a), bf16
//    operands and f32 accumulators in registers: two consumer warpgroups of
//    64 query rows each compute S = Q K^T (m64n128k16, Q and K from shared
//    memory), then P V (m64nDk16) with P rounded to bf16 in registers as the
//    A operand and V's tile read from shared memory, transposed by the
//    instruction;
//  * a warpgroup's tile n S product is issued together with its tile n - 1
//    P V product, so that the softmax of tile n (exp on the special-function
//    units) runs while P V is on the tensor cores.  The softmax never writes
//    S's registers while P V runs (ptxas would serialize the wgmmas), and
//    the first tile is peeled off the loop, so that both products are
//    issued on every pass;
//  * a producer warpgroup gives its registers to the consumers (setmaxnreg
//    24 / 240); one of its warps keeps a ring of bf16 K and V tiles in
//    shared memory filled by TMA (`cp.async.bulk.tensor`, 128-byte swizzle,
//    completion on an mbarrier); a stage is released through a second
//    mbarrier once its P V product is done;
//  * the key tile and the ring's depth follow the head dim (struct Tiling):
//    128 keys and 3 stages at D 64 and 128; at D 192 and 256 the q tiles
//    (48 or 64 KB) and a ring of 128-key tiles would not fit in a block's
//    227 KB, so the tile is 64 keys, with 3 stages at D 192 (192 KB) and 2
//    at D 256 (192 KB).  The accumulators then take 64·D/128 registers a
//    consumer thread for O (96 or 128) and 32 for S, P V is one m64n192k16
//    or m64n256k16 instruction per 16 keys, and Q K^T takes 12 or 16
//    k-steps over 3 or 4 swizzled slabs;
//  * a key tile with no valid key for the block's item is skipped by every
//    warp alike: such a tile would give alpha = 1 and p = 0, so skipping it
//    changes no bit.  The block first writes each tile's valid-key words to
//    shared memory (warp ballots, all loads in flight at once, while up to
//    D 128 the consumers' q loads are in flight too; past it q is stored
//    first, since 64·D/128 values a thread held across the build spilled);
//    every warp reads them there.
//    They take one bit a key (16 bytes a 128-key tile) beside the q tiles
//    and the ring, which bounds Lk at 16,000 keys at D 128 (225 KB before
//    the masks) and at 278,000 at D 192 and 256 (the model's longest: 8192);
//  * f32 inputs (the model's case) first pass through `kv_to_bf16_kernel`,
//    which rounds k and v to bf16 into scratch the caller allocates (only
//    the 128-key tiles that hold a valid key, so every attention tile that
//    is read: 12 bytes per element read and written), so TMA reads bf16
//    tiles; q is scaled, rounded and stored swizzled by the consumers
//    themselves, once per block;
//  * the ragged edges of Lq and Lk are masked in the kernel (TMA fills keys
//    past Lk with zeros, rows past Lq are computed and not stored): no
//    padding copies.
// What it leaves on the table: one block per SM (registers and shared
// memory), so a block's q load, output store and set-up are not hidden
// behind another block's products; `chip_smoke.py` times them as the
// kernel with one valid key tile per item.  Taking turns between the two
// warpgroups (ping-pong) and a persistent grid that loads the next block's
// q during this one's stores were each measured no faster here; removing
// the K/V loads altogether did not speed the loop up either, so it is
// bound by the consumers' instructions, not by L2.  Head dims past 256 run
// on the wide kernel further down (flash_wide_kernel).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;                  // query rows per block
constexpr int CONVERT_TILE = 128;        // keys per block of kv_to_bf16
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128; // and a producer warpgroup
constexpr int ROW_BYTES = 128;           // a swizzled row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_FAILED = -1;        // status: no tensor map
constexpr int TOO_MANY_KEYS = -2;        // status: masks exceed shared memory
constexpr int MAX_SMEM = 232448;         // a block's shared memory on sm_90

// The key tile (BN keys) and the ring's depth (STAGES tiles) of head dim D:
// as many stages of the widest tile as fit beside the q tiles.
template <int D> struct Tiling { static constexpr int BN = 128, STAGES = 3; };
template <> struct Tiling<192> { static constexpr int BN = 64, STAGES = 3; };
template <> struct Tiling<256> { static constexpr int BN = 64, STAGES = 2; };

// A key tile's valid-key words: bit j of w[c] is key 32 c + j of the tile.
template <int BN>
struct alignas(BN / 8) KeyWords {
  uint32_t w[BN / 32];
};

// Shared memory, from a 1024-byte aligned base: each warpgroup's q tile,
// then the K ring, the V ring, the mbarriers and each key tile's valid-key
// words (BN / 8 bytes a tile, sized at launch).  Every tile is stored as
// D / 64 slabs of 64 columns, one 128-byte row per key (or query row), with
// the 16-byte chunks of row r XOR-ed by r % 8 (TMA's 128-byte swizzle).
template <int D, int BN, int STAGES>
struct Smem {
  static constexpr int SLABS = D / 64;
  static constexpr int Q_WG = 64 * D * 2;            // one warpgroup's q
  static constexpr int Q_SLAB = 64 * ROW_BYTES;
  static constexpr int TILE = BN * D * 2;            // one K or V tile
  static constexpr int TILE_SLAB = BN * ROW_BYTES;
  static constexpr int K = 2 * Q_WG;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;
  static constexpr int MASKS = BARS + 2 * STAGES * 8;
  static constexpr int BYTES = MASKS + 1024;  // + alignment; + the masks
  static constexpr int MASK_BYTES = BN / 8;   // a key tile's words
  static_assert(MASKS % 16 == 0, "the masks' alignment");
  static_assert(BYTES + MASK_BYTES <= MAX_SMEM, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lbo >> 4) << 16)
       | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {   // N groups may stay open
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from touching registers that an asynchronous wgmma
// reads or writes before the wait that ends it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define ACC8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define ACC96 ACC64, ACC8(64), ACC8(72), ACC8(80), ACC8(88)
#define ACC128 ACC96, ACC8(96), ACC8(104), ACC8(112), ACC8(120)
#define LIST32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define LIST64                                                            \
  LIST32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"
#define LIST96                                                            \
  LIST64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95"
#define LIST128                                                           \
  LIST96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "     \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "    \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d (64 x N, f32) = or += A (64 x 16) B (16 x N): A and B^T K-major in
// shared memory; N = 128 or 64 keys.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LIST64
      "}, %64, %65, p, 1, 1, 0, 0;\n\t}"
      : ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" LIST32
      "}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 pairs in registers) B (16 x N): B
// N-major in shared memory (transposed by the instruction); N = D.
// A_REGS: the operand numbers of A's four registers, B's descriptor and
// the scale-d flag, which follow the accumulators.
#define WGMMA_RS(N, ACC, LIST, A_REGS, B_REG, P_REG)                      \
  asm volatile(                                                           \
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, " P_REG ", 0;\n\t"             \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" LIST   \
      "}, {" A_REGS "}, " B_REG ", p, 1, 1, 1;\n\t}"                       \
      : ACC                                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  WGMMA_RS(64, ACC32, LIST32, "%32, %33, %34, %35", "%36", "%37");
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  WGMMA_RS(128, ACC64, LIST64, "%64, %65, %66, %67", "%68", "%69");
}
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t* a,
                                         uint64_t b) {
  WGMMA_RS(192, ACC96, LIST96, "%96, %97, %98, %99", "%100", "%101");
}
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t b) {
  WGMMA_RS(256, ACC128, LIST128, "%128, %129, %130, %131", "%132", "%133");
}

#undef WGMMA_RS
#undef ACC8
#undef ACC32
#undef ACC64
#undef ACC96
#undef ACC128
#undef LIST32
#undef LIST64
#undef LIST96
#undef LIST128

// O += P V over a tile's BN keys in steps of 16 (issued and committed, not
// waited for): V is the N-major B operand, 8-key groups 1024 bytes apart,
// 64-column slabs TILE_SLAB apart.
template <int D, int BN, int STAGES>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[BN / 4],
                                           uint32_t v_smem) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(o, pa + 4 * kk,
             wgmma_desc(v_smem + kk * 16 * ROW_BYTES,
                        Smem<D, BN, STAGES>::TILE_SLAB, 1024));
  wgmma_commit();
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The valid keys of tile [key0, key0 + 128) as four 32-bit words (bit j of
// word c: key key0 + 32 c + j); keys past Lk are invalid.  Every lane of the
// warp gets the same words.
__device__ __forceinline__ void tile_mask(const uint8_t* valid_b, int Lk,
                                          int key0, int lane,
                                          uint32_t (&w)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = key0 + 32 * c + lane;
    w[c] = __ballot_sync(0xffffffffu, key < Lk && valid_b[key] != 0);
  }
}

// Every key tile's words into masks[t]: warp w takes tiles w, w + WARPS, ...,
// four at a time with all their loads in flight before the ballots.
template <int BN>
__device__ __forceinline__ void build_masks(const uint8_t* valid_b, int Lk,
                                            int n_tiles, int warp, int lane,
                                            KeyWords<BN>* masks) {
  constexpr int WARPS = THREADS / 32, W = BN / 32;
  for (int t0 = warp; t0 < n_tiles; t0 += 4 * WARPS) {
    bool ok[4][W];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const int key = (t0 + u * WARPS) * BN + 32 * c + lane;
        ok[u][c] = key < Lk && valid_b[key] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      KeyWords<BN> words;
#pragma unroll
      for (int c = 0; c < W; ++c)
        words.w[c] = __ballot_sync(0xffffffffu, ok[u][c]);
      if (lane == 0 && t0 + u * WARPS < n_tiles) masks[t0 + u * WARPS] = words;
    }
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One warpgroup's 64 query rows from row0 in two steps, so that other work
// can overlap the loads: load_q reads chunks g .. g + G - 1 of a thread's
// (rows past Lq are zeros), store_q writes them as bf16(q * scale) swizzled
// at dst.  Up to D 192 a thread's chunks are loaded at once; at D 256 in
// two halves (128 values in flight would spill).
template <int D>
constexpr int Q_CHUNKS = 64 * (D / 8) / 128;   // 8-column chunks a thread
template <int D>
constexpr int Q_GROUP = D > 192 ? Q_CHUNKS<D> / 2 : Q_CHUNKS<D>;

template <int D, int G, typename T>
__device__ __forceinline__ void load_q(const T* q_bh, int Lq, int row0,
                                       int wl, int g, float (&x)[G][8]) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int c = wl + 128 * (g + i), r = c / (D / 8), j = c % (D / 8);
    if (row0 + r < Lq) {
      load8(q_bh + (size_t)(row0 + r) * D + 8 * j, x[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[i][e] = 0.f;
    }
  }
}

template <int D, int G>
__device__ __forceinline__ void store_q(const float (&x)[G][8], uint8_t* dst,
                                        int wl, int g, float scale) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int c = wl + 128 * (g + i), r = c / (D / 8), j = c % (D / 8);
    uint4 u;
    u.x = bf16x2(x[i][0] * scale, x[i][1] * scale);
    u.y = bf16x2(x[i][2] * scale, x[i][3] * scale);
    u.z = bf16x2(x[i][4] * scale, x[i][5] * scale);
    u.w = bf16x2(x[i][6] * scale, x[i][7] * scale);
    *reinterpret_cast<uint4*>(dst + (j / 8) * 64 * ROW_BYTES
                              + r * ROW_BYTES + ((j % 8) ^ (r % 8)) * 16) = u;
  }
}

// One tile's online softmax for a thread's two rows (a row's BN scores
// sit in the four lanes of a quad): an invalid key's score is -1e30 (if
// MASKED), m and l move on, alpha = exp(m_old - m_new), and p = exp(s - m)
// in f32 is summed into l and rounded to bf16 pairs in the A layout of
// m64n*k16: keys 16 kk .. 16 kk + 15 in pn[4 kk .. 4 kk + 3].
template <bool MASKED, int BN>
__device__ __forceinline__ void tile_softmax(const float (&sc)[BN / 2],
                                             const KeyWords<BN>& w, int quad,
                                             float& m0, float& m1,
                                             float& l0, float& l1,
                                             float& alpha0, float& alpha1,
                                             uint32_t (&pn)[BN / 4]) {
  uint32_t wq[BN / 32];
#pragma unroll
  for (int c = 0; c < BN / 32; ++c) wq[c] = w.w[c] >> (2 * quad);
  auto score = [&](int i) {
    return !MASKED || ((wq[i / 16] >> (8 * (i / 4 % 4) + i % 2)) & 1u)
               ? sc[i] : NEG_INF;
  };
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(score(4 * i), score(4 * i + 1)));
    mx1 = fmaxf(mx1, fmaxf(score(4 * i + 2), score(4 * i + 3)));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  alpha0 = exp2_approx((m0 - mn0) * LOG2E);
  alpha1 = exp2_approx((m1 - mn1) * LOG2E);
  m0 = mn0;
  m1 = mn1;
  const float ms0 = mn0 * LOG2E, ms1 = mn1 * LOG2E;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {   // an invalid key's -1e30 gives p = 0
    const float p0 = exp2_approx(fmaf(score(4 * i), LOG2E, -ms0));
    const float p1 = exp2_approx(fmaf(score(4 * i + 1), LOG2E, -ms0));
    const float p2 = exp2_approx(fmaf(score(4 * i + 2), LOG2E, -ms1));
    const float p3 = exp2_approx(fmaf(score(4 * i + 3), LOG2E, -ms1));
    ps0 += p0 + p1;
    ps1 += p2 + p3;
    pn[2 * i] = bf16x2(p0, p1);
    pn[2 * i + 1] = bf16x2(p2, p3);
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
}

// tile_softmax for a tile with any keys masked, or with none
template <int BN>
__device__ __forceinline__ void tile_softmax(const float (&sc)[BN / 2],
                                             const KeyWords<BN>& w, int quad,
                                             float& m0, float& m1,
                                             float& l0, float& l1,
                                             float& alpha0, float& alpha1,
                                             uint32_t (&pn)[BN / 4]) {
  uint32_t all = 0xffffffffu;
#pragma unroll
  for (int c = 0; c < BN / 32; ++c) all &= w.w[c];
  if (all == 0xffffffffu)
    tile_softmax<false, BN>(sc, w, quad, m0, m1, l0, l1, alpha0, alpha1, pn);
  else
    tile_softmax<true, BN>(sc, w, quad, m0, m1, l0, l1, alpha0, alpha1, pn);
}

template <int BN>
__device__ __forceinline__ bool any_key(const KeyWords<BN>& w) {
  uint32_t any = 0;
#pragma unroll
  for (int c = 0; c < BN / 32; ++c) any |= w.w[c];
  return any != 0;
}

// S = (q scale) K^T for the tile in ring stage n % STAGES, once it has
// arrived (issued and committed, not waited for): over D in steps of 16;
// within a 64-column slab the start address moves 32 bytes a step, and
// 8-row groups are 1024 bytes apart.
template <int D, int BN, int STAGES>
__device__ __forceinline__ void s_product(float (&sc)[BN / 2],
                                          uint32_t q_smem, uint32_t k_smem,
                                          uint32_t full, int n) {
  using S = Smem<D, BN, STAGES>;
  mbar_wait(full + 8 * (n % STAGES), (n / STAGES) & 1);
  __syncwarp();                                // wgmma needs whole warps
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(sc, wgmma_desc(q_smem + (kk / 4) * S::Q_SLAB + off, 16, 1024),
             wgmma_desc(k_smem + (kk / 4) * S::TILE_SLAB + off, 16, 1024),
             kk > 0);
  }
  wgmma_commit();
}

template <int D, int BN, int STAGES, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const T* __restrict__ q,
                       const uint8_t* __restrict__ key_valid,
                       T* __restrict__ out, int H, int Lq, int Lk,
                       float scale) {
  using S = Smem<D, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t full = base + S::BARS;        // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;    // empty[s] at empty + 8 s

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const uint8_t* valid_b = key_valid + (size_t)(bh / H) * Lk;
  const int n_tiles = (Lk + BN - 1) / BN;
  KeyWords<BN>* masks = reinterpret_cast<KeyWords<BN>*>(base_ptr + S::MASKS);

  // the consumers: warpgroup wg owns query rows q0 .. q0 + 63.  Up to D
  // 128 their q loads are in flight while every warp builds the key tiles'
  // masks; past it q is stored first, since its registers would spill
  // across the mask build (before setmaxnreg a thread has 168)
  const int wg = warp / 4, wl = tid % 128;
  const int q0 = blockIdx.x * BM + 64 * wg;
  const T* q_bh = q + (size_t)bh * Lq * D;
  constexpr int QG = Q_GROUP<D>;
  float x[QG][8];
  if (warp < CONSUMERS / 32) {
    load_q<D, QG>(q_bh, Lq, q0, wl, 0, x);
    if constexpr (D > 128) {
      store_q<D, QG>(x, base_ptr + wg * S::Q_WG, wl, 0, scale);
#pragma unroll
      for (int g = QG; g < Q_CHUNKS<D>; g += QG) {
        load_q<D, QG>(q_bh, Lq, q0, wl, g, x);
        store_q<D, QG>(x, base_ptr + wg * S::Q_WG, wl, g, scale);
      }
    }
  }
  build_masks<BN>(valid_b, Lk, n_tiles, warp, lane, masks);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // the producer warpgroup gives its registers to the consumers; one
    // warp fills the ring with the tiles that hold a valid key
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp != CONSUMERS / 32) return;
    int n = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (!any_key(masks[t])) continue;
      const int s = n % STAGES;
      if (lane == 0) {
        mbar_wait(empty + 8 * s, ((n / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * S::TILE);
#pragma unroll
        for (int h = 0; h < S::SLABS; ++h) {
          tma_load(base + S::K + s * S::TILE + h * S::TILE_SLAB, &k_map,
                   full + 8 * s, 64 * h, t * BN, bh);
          tma_load(base + S::V + s * S::TILE + h * S::TILE_SLAB, &v_map,
                   full + 8 * s, 64 * h, t * BN, bh);
        }
      }
      __syncwarp();
      ++n;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int quad = lane % 4;
  const uint32_t q_smem = base + wg * S::Q_WG;
  if constexpr (D <= 128)
    store_q<D, QG>(x, base_ptr + wg * S::Q_WG, wl, 0, scale);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1 + wg, 128);

  // accumulator layout (m64nN f32): d[4 i + e] holds row 16 (warp % 4) +
  // lane / 4 + 8 (e / 2), column 8 i + 2 quad + e % 2
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // Tile n's S = Q K^T is issued together with tile n - 1's O += P V, so
  // tile n's softmax runs while that product is on the tensor cores; stage
  // n - 1 is released once it is done, and only then is O rescaled and the
  // next P put in place.  The first tile is peeled off, so that the loop
  // issues both products every time (a product issued on one branch only
  // would make the compiler copy accumulators while it runs).
  uint32_t pa[BN / 4];
  int n = 0, t = 0;
  while (t < n_tiles && !any_key(masks[t])) ++t;
  if (t < n_tiles) {
    float sc[BN / 2];
    s_product<D, BN, STAGES>(sc, q_smem, base + S::K, full, 0);
    wgmma_wait<0>();
    pin(sc);
    float alpha0, alpha1;
    tile_softmax(sc, masks[t], quad, m0, m1, l0, l1, alpha0, alpha1, pa);
    uint32_t v_prev = base + S::V;
    for (n = 1, ++t; t < n_tiles; ++t) {
      if (!any_key(masks[t])) continue;
      const int s = n % STAGES;
      s_product<D, BN, STAGES>(sc, q_smem, base + S::K + s * S::TILE, full,
                               n);
      pv_product<D, BN, STAGES>(o, pa, v_prev);
      wgmma_wait<1>();                         // S is done, P V runs on
      pin(sc);
      uint32_t pn[BN / 4];
      tile_softmax(sc, masks[t], quad, m0, m1, l0, l1, alpha0, alpha1, pn);
      wgmma_wait<0>();                         // tile n - 1's P V is done
      pin(o);
      pin(pa);
      mbar_arrive(empty + 8 * ((n - 1) % STAGES));
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) pa[i] = pn[i];
      v_prev = base + S::V + s * S::TILE;
      ++n;
    }
    pv_product<D, BN, STAGES>(o, pa, v_prev);  // the last tile's P V
    wgmma_wait<0>();
    pin(o);
    pin(pa);
    mbar_arrive(empty + 8 * ((n - 1) % STAGES));
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // l clamped at 1e-37; with no valid key at all (o = 0) dividing by 1
  // writes the same zeros without the divider's slow path
  const float den0 = n ? fmaxf(l0, 1e-37f) : 1.f;
  const float den1 = n ? fmaxf(l1, 1e-37f) : 1.f;
  const int r0 = q0 + 16 * (warp % 4) + lane / 4, r1 = r0 + 8;
  T* out_bh = out + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * quad;
    if (r0 < Lq)
      store2(out_bh + (size_t)r0 * D + col, o[4 * i] / den0,
             o[4 * i + 1] / den0);
    if (r1 < Lq)
      store2(out_bh + (size_t)r1 * D + col, o[4 * i + 2] / den1,
             o[4 * i + 3] / den1);
  }
}

// k and v (B H, Lk, D) f32 -> bf16 scratch, for the 128-key tiles that
// hold a valid key of their item (an attention tile of 128 or 64 keys that
// the attention kernel reads lies in one of them).
template <int D>
__global__ void __launch_bounds__(256)
kv_to_bf16_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  const uint8_t* __restrict__ key_valid,
                  __nv_bfloat16* __restrict__ k16,
                  __nv_bfloat16* __restrict__ v16, int H, int Lk) {
  const int key0 = blockIdx.x * CONVERT_TILE, bh = blockIdx.y;
  uint32_t w[4];
  tile_mask(key_valid + (size_t)(bh / H) * Lk, Lk, key0, threadIdx.x % 32,
            w);
  if ((w[0] | w[1] | w[2] | w[3]) == 0) return;
  const size_t off = ((size_t)bh * Lk + key0) * D;
  const int chunks = min(CONVERT_TILE, Lk - key0) * D / 8;
  for (int c = threadIdx.x; c < chunks; c += 256) {
    float x[8];
    uint4 u;
    load8(k + off + 8 * c, x);
    u = make_uint4(bf16x2(x[0], x[1]), bf16x2(x[2], x[3]),
                   bf16x2(x[4], x[5]), bf16x2(x[6], x[7]));
    *reinterpret_cast<uint4*>(k16 + off + 8 * c) = u;
    load8(v + off + 8 * c, x);
    u = make_uint4(bf16x2(x[0], x[1]), bf16x2(x[2], x[3]),
                   bf16x2(x[4], x[5]), bf16x2(x[6], x[7]));
    *reinterpret_cast<uint4*>(v16 + off + 8 * c) = u;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library links against no libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A TMA map of a (BH, Lk, D) bf16 tensor in boxes of BN keys x 64 columns
// with the 128-byte swizzle; keys past Lk read as zeros.
bool encode(CUtensorMap* map, const void* base, int D, int Lk, int BH,
            int BN) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Lk, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Lk * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The attention kernel's dynamic shared memory at head dim D and Lk keys.
template <int D>
int smem_bytes(int Lk) {
  constexpr int BN = Tiling<D>::BN;
  using S = Smem<D, BN, Tiling<D>::STAGES>;
  return S::BYTES + S::MASK_BYTES * ((Lk + BN - 1) / BN);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v,
           const uint8_t* key_valid, void* out, void* kv_scratch, int B,
           int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  constexpr int BN = Tiling<D>::BN, STAGES = Tiling<D>::STAGES;
  const void* k16 = k;
  const void* v16 = v;
  if (std::is_same<T, float>::value) {
    __nv_bfloat16* s = static_cast<__nv_bfloat16*>(kv_scratch);
    k16 = s;
    v16 = s + (size_t)B * H * Lk * D;
    kv_to_bf16_kernel<D><<<dim3((Lk + CONVERT_TILE - 1) / CONVERT_TILE,
                                B * H), 256, 0, stream>>>(
        static_cast<const float*>(k), static_cast<const float*>(v),
        key_valid, s, s + (size_t)B * H * Lk * D, H, Lk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  CUtensorMap k_map, v_map;
  if (!encode(&k_map, k16, D, Lk, B * H, BN) ||
      !encode(&v_map, v16, D, Lk, B * H, BN))
    return ENCODE_FAILED;
  const int smem = smem_bytes<D>(Lk);
  if (smem > MAX_SMEM) return TOO_MANY_KEYS;
  static int allowed = 0;               // the largest size granted so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D, BN, STAGES, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  flash_attention_kernel<D, BN, STAGES, T>
      <<<dim3((Lq + BM - 1) / BM, B * H), THREADS, smem, stream>>>(
          k_map, v_map, static_cast<const T*>(q), key_valid,
          static_cast<T*>(out), H, Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Head dims past 256: the wide kernel.
//
// The same function, rounding points and key-tile skipping as the kernel
// above, for any head dim D that is a multiple of 64 (the wrapper zero-pads
// D past 256 to the next multiple of 64; the scale stays 1/sqrt of the true
// D).  What stops the design above at 256 is the output accumulator (64 x D
// f32 a warpgroup: 128 of a consumer's 240 registers at D 256) and the q
// tiles and K/V stages in shared memory.  So here:
//  * the output's columns are split across blocks: a block computes the full
//    scores over all of D and writes a slice of 2 to 4 chunks of 64 columns
//    (128-256), the slices of a D as even as whole chunks allow (D 320: 192 +
//    128; 384: 192 + 192; 512: 256 + 256; 1024: 4 x 256), so that every
//    block of a launch does about the same work; the price is Q K^T once per
//    slice (2x at D 320-512);
//  * K and the slice's V go through the TMA ring in chunks of 64 keys x 64
//    columns (8 KB), so a stage does not grow with D: a key tile is D / 64
//    K chunks, then its slice's V chunks.  Q K^T accumulates over the K
//    chunks in m64n64k16 steps, a chunk's stage released as soon as the next
//    chunk's product is issued; P V is m64n64k16 per V chunk, from P in
//    registers;
//  * q (bf16(q * scale), written by `to_bf16_kernel` into scratch) is loaded
//    by TMA once per block and stays in shared memory while it fits beside a
//    ring of 6-8 stages (D up to 704 with 128-row blocks); past that each K
//    chunk's stage also holds the block's 128 x 64 chunk of q, re-read from
//    L2 for every key tile;
//  * as above, tile n's Q K^T is issued before tile n - 1's P V, so the
//    softmax of tile n runs while P V is on the tensor cores; the producer
//    loads in the order the consumers read: K of tile n, then V of tile
//    n - 1, so a ring of NV + 2 stages never stalls on a stage held back.
// Bound: the products over the valid keys at the bf16 tensor-core rate, D x
// Lk x Lq twice; this design does the Q K^T part once per slice.  What it
// leaves on the table: with 64-key tiles each Q K^T step (m64n64k16, both
// operands from shared memory) reads 4 KB of shared memory for 32 cycles of
// the tensor cores, the SM's whole 128 bytes a cycle, as the kernel above
// does at D 192 and 256; a wider key tile needs registers that the output
// slice holds.
constexpr int WIDE_BN = 64;                  // keys per tile
constexpr int CHUNK = 64 * ROW_BYTES;        // 64 rows x 64 columns, bf16
constexpr int Q_CHUNK = 2 * CHUNK;           // the block's 128 rows x 64
constexpr int WIDE_MAX_STAGES = 8, WIDE_MIN_STAGES = 6;
constexpr int WIDE_MAX_SLICE = 4;            // chunks of 64 columns a slice
// shared memory beside q and the ring: alignment slack, the mbarriers
// (full, empty, q), then the key tiles' words
constexpr int WIDE_FIXED = 1024 + 16 * WIDE_MAX_STAGES + 16;

// The output slices over NC chunks of 64 columns: as few as hold at most
// WIDE_MAX_SLICE chunks each.
__host__ __device__ inline int wide_slices(int nc) {
  return (nc + WIDE_MAX_SLICE - 1) / WIDE_MAX_SLICE;
}
// Slice `slice` of `slices`: its first chunk and its width in chunks (the
// first NC % slices slices take one more).
__host__ __device__ inline void wide_slice(int nc, int slices, int slice,
                                           int& first, int& width) {
  const int base = nc / slices, rem = nc % slices;
  width = base + (slice < rem ? 1 : 0);
  first = slice * base + (slice < rem ? slice : rem);
}

// Layout of the wide kernel's dynamic shared memory, from a 1024-byte
// aligned base: [q, NC chunks of 16 KB, if resident] [the ring: STAGES
// stages] [mbarriers] [key-tile words].  A stage holds one 8 KB K or V
// chunk; where q streams, a K stage holds the q chunk first (24 KB).
struct WideLayout {
  bool q_resident;
  int stages;
  uint32_t q_bytes, stage_bytes, k_off;
};

__host__ __device__ inline WideLayout wide_layout(int nc, bool q_resident,
                                                  int stages) {
  WideLayout w;
  w.q_resident = q_resident;
  w.stages = stages;
  w.q_bytes = q_resident ? nc * Q_CHUNK : 0;
  w.stage_bytes = q_resident ? CHUNK : Q_CHUNK + CHUNK;
  w.k_off = q_resident ? 0 : Q_CHUNK;
  return w;
}

// O (64 x DV) += P V for one key tile: V's DV / 64 chunks in ring positions
// vpos .. (issued and committed, not waited for)
template <int DV>
__device__ __forceinline__ void wide_pv(float (&o)[DV / 2],
                                        const uint32_t (&pa)[WIDE_BN / 4],
                                        uint32_t ring, uint32_t full,
                                        const WideLayout& w, int vpos) {
#pragma unroll
  for (int j = 0; j < DV / 64; ++j) {
    const int p = vpos + j;
    mbar_wait(full + 8 * (p % w.stages), (p / w.stages) & 1);
  }
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < DV / 64; ++j) {
    const uint32_t st = ring + ((vpos + j) % w.stages) * w.stage_bytes;
#pragma unroll
    for (int kk = 0; kk < WIDE_BN / 16; ++kk)
      wgmma_rs(*reinterpret_cast<float(*)[32]>(o + 32 * j), pa + 4 * kk,
               wgmma_desc(st + kk * 16 * ROW_BYTES, CHUNK, 1024));
  }
  wgmma_commit();
}

// S = (q scale) K^T for one key tile over its NC K chunks in ring positions
// pos .. pos + NC - 1: each chunk's four k-steps are one group, and chunk
// c - 1's stage is released once chunk c is issued; the last chunk's group
// stays open.
__device__ __forceinline__ void wide_qk(float (&sc)[WIDE_BN / 2],
                                        uint32_t q_res, uint32_t ring,
                                        uint32_t full, uint32_t empty,
                                        const WideLayout& w, int nc, int wg,
                                        int pos) {
  for (int c = 0; c < nc; ++c) {
    const int p = pos + c;
    const uint32_t st = ring + (p % w.stages) * w.stage_bytes;
    const uint32_t qa = (w.q_resident ? q_res + c * Q_CHUNK : st) + wg * CHUNK;
    mbar_wait(full + 8 * (p % w.stages), (p / w.stages) & 1);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sc, wgmma_desc(qa + kk * 32, 16, 1024),
               wgmma_desc(st + w.k_off + kk * 32, 16, 1024), c > 0 || kk > 0);
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      mbar_arrive(empty + 8 * ((p - 1) % w.stages));
    }
  }
}

template <int DV, typename T>
__device__ __forceinline__ void wide_body(
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, const uint8_t* __restrict__ key_valid,
    T* __restrict__ out, int H, int Lq, int Lk, int D, const WideLayout& w,
    int row0, int first, uint32_t base, uint8_t* base_ptr) {
  constexpr int NV = DV / 64;
  const int nc = D / 64;
  const uint32_t ring = base + w.q_bytes;
  const uint32_t full = ring + w.stages * w.stage_bytes;
  const uint32_t empty = full + 8 * WIDE_MAX_STAGES;
  const uint32_t q_full = empty + 8 * WIDE_MAX_STAGES;
  KeyWords<WIDE_BN>* masks =
      reinterpret_cast<KeyWords<WIDE_BN>*>(base_ptr + (q_full + 16 - base));
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const uint8_t* valid_b = key_valid + (size_t)(bh / H) * Lk;
  const int n_tiles = (Lk + WIDE_BN - 1) / WIDE_BN;

  build_masks<WIDE_BN>(valid_b, Lk, n_tiles, warp, lane, masks);
  if (tid == 0) {
    for (int s = 0; s < w.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // the producer: q once (if resident), then for each tile with a valid
    // key its K chunks and the previous such tile's V chunks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp != CONSUMERS / 32 || lane != 0) return;
    if (w.q_resident) {
      mbar_expect_tx(q_full, nc * Q_CHUNK);
      for (int c = 0; c < nc; ++c)
        tma_load(base + c * Q_CHUNK, q_map, q_full, 64 * c, row0, bh);
    }
    int pos = 0, prev = -1;
    auto acquire = [&](uint32_t bytes) {
      const int s = pos % w.stages;
      mbar_wait(empty + 8 * s, ((pos / w.stages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, bytes);
      ++pos;
      return s;
    };
    auto load_v = [&](int t) {
      for (int j = 0; j < NV; ++j) {
        const int s = acquire(CHUNK);
        tma_load(ring + s * w.stage_bytes, v_map, full + 8 * s,
                 64 * (first + j), t * WIDE_BN, bh);
      }
    };
    for (int t = 0; t < n_tiles; ++t) {
      if (!any_key(masks[t])) continue;
      for (int c = 0; c < nc; ++c) {
        const int s = acquire(w.stage_bytes);
        const uint32_t st = ring + s * w.stage_bytes;
        if (!w.q_resident)
          tma_load(st, q_map, full + 8 * s, 64 * c, row0, bh);
        tma_load(st + w.k_off, k_map, full + 8 * s, 64 * c, t * WIDE_BN, bh);
      }
      if (prev >= 0) load_v(prev);
      prev = t;
    }
    if (prev >= 0) load_v(prev);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = warp / 4, quad = lane % 4;
  if (w.q_resident) mbar_wait(q_full, 0);

  // accumulator layout (m64n64 per 64 columns): o[32 j + 4 i + e] holds row
  // 16 (warp % 4) + lane / 4 + 8 (e / 2), column 64 j + 8 i + 2 quad + e % 2
  // of the slice
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  uint32_t pa[WIDE_BN / 4];
  int n = 0, t = 0, pos = 0;
  while (t < n_tiles && !any_key(masks[t])) ++t;
  if (t < n_tiles) {
    float sc[WIDE_BN / 2];
    wide_qk(sc, base, ring, full, empty, w, nc, wg, pos);
    pos += nc;
    wgmma_wait<0>();
    pin(sc);
    mbar_arrive(empty + 8 * ((pos - 1) % w.stages));
    float alpha0, alpha1;
    tile_softmax(sc, masks[t], quad, m0, m1, l0, l1, alpha0, alpha1, pa);
    for (n = 1, ++t; t < n_tiles; ++t) {
      if (!any_key(masks[t])) continue;
      wide_qk(sc, base, ring, full, empty, w, nc, wg, pos);
      const int vpos = pos + nc;
      wide_pv<DV>(o, pa, ring, full, w, vpos);
      wgmma_wait<1>();                         // S is done, P V runs on
      pin(sc);
      mbar_arrive(empty + 8 * ((vpos - 1) % w.stages));
      uint32_t pn[WIDE_BN / 4];
      tile_softmax(sc, masks[t], quad, m0, m1, l0, l1, alpha0, alpha1, pn);
      wgmma_wait<0>();                         // the last tile's P V is done
      pin(o);
      pin(pa);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        mbar_arrive(empty + 8 * ((vpos + j) % w.stages));
      pos = vpos + NV;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
#pragma unroll
      for (int i = 0; i < WIDE_BN / 4; ++i) pa[i] = pn[i];
      ++n;
    }
    wide_pv<DV>(o, pa, ring, full, w, pos);    // the last tile's P V
    wgmma_wait<0>();
    pin(o);
    pin(pa);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      mbar_arrive(empty + 8 * ((pos + j) % w.stages));
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = n ? fmaxf(l0, 1e-37f) : 1.f;
  const float den1 = n ? fmaxf(l1, 1e-37f) : 1.f;
  const int r0 = row0 + 64 * wg + 16 * (warp % 4) + lane / 4, r1 = r0 + 8;
  T* out_bh = out + (size_t)bh * Lq * D + 64 * first;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int col = 8 * i + 2 * quad;
    if (r0 < Lq)
      store2(out_bh + (size_t)r0 * D + col, o[4 * i] / den0,
             o[4 * i + 1] / den0);
    if (r1 < Lq)
      store2(out_bh + (size_t)r1 * D + col, o[4 * i + 2] / den1,
             o[4 * i + 3] / den1);
  }
}

// One block per (128 query rows, slice) of one (batch, head): blockIdx.x =
// row tile x slices + slice, so that the slices of a row tile, which read
// the same K chunks, run side by side.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const uint8_t* __restrict__ key_valid, T* __restrict__ out,
                  int H, int Lq, int Lk, int D, int q_resident, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const int nc = D / 64, slices = wide_slices(nc);
  int first, width;
  wide_slice(nc, slices, blockIdx.x % slices, first, width);
  const WideLayout w = wide_layout(nc, q_resident != 0, stages);
  const int row0 = (blockIdx.x / slices) * BM;
  if (width == 2)
    wide_body<128, T>(&q_map, &k_map, &v_map, key_valid, out, H, Lq, Lk, D, w,
                      row0, first, base, base_ptr);
  else if (width == 3)
    wide_body<192, T>(&q_map, &k_map, &v_map, key_valid, out, H, Lq, Lk, D, w,
                      row0, first, base, base_ptr);
  else
    wide_body<256, T>(&q_map, &k_map, &v_map, key_valid, out, H, Lq, Lk, D, w,
                      row0, first, base, base_ptr);
}

// src (B H, L, D) -> bf16(src * scale) in dst, in tiles of 64 rows; with
// key_valid, only the tiles that hold a valid key of their item (the wide
// kernel reads no other).
template <typename T>
__global__ void __launch_bounds__(256)
to_bf16_kernel(const T* __restrict__ src, __nv_bfloat16* __restrict__ dst,
               const uint8_t* __restrict__ key_valid, int H, int L, int D,
               float scale) {
  const int row0 = blockIdx.x * WIDE_BN, bh = blockIdx.y;
  if (key_valid != nullptr) {
    const uint8_t* valid_b = key_valid + (size_t)(bh / H) * L;
    const int r = row0 + threadIdx.x;
    if (!__syncthreads_or(threadIdx.x < WIDE_BN && r < L && valid_b[r] != 0))
      return;
  }
  const size_t off = ((size_t)bh * L + row0) * D;
  const int chunks = min(WIDE_BN, L - row0) * D / 8;
  for (int c = threadIdx.x; c < chunks; c += 256) {
    float x[8];
    load8(src + off + 8 * c, x);
    *reinterpret_cast<uint4*>(dst + off + 8 * c) = make_uint4(
        bf16x2(x[0] * scale, x[1] * scale), bf16x2(x[2] * scale, x[3] * scale),
        bf16x2(x[4] * scale, x[5] * scale), bf16x2(x[6] * scale, x[7] * scale));
  }
}

// The wide kernel's shared-memory plan at head dim D and Lk keys: q
// resident with as many stages as fit (at most 8, at least 6), else q
// streamed; false if neither fits.
bool wide_plan(int D, int Lk, WideLayout& w, int& smem) {
  const int nc = D / 64;
  const int fixed = WIDE_FIXED + 8 * ((Lk + WIDE_BN - 1) / WIDE_BN);
  for (int resident = 1; resident >= 0; --resident) {
    const WideLayout probe = wide_layout(nc, resident != 0, 1);
    const int room = MAX_SMEM - fixed - static_cast<int>(probe.q_bytes);
    const int stages = min(WIDE_MAX_STAGES,
                           room / static_cast<int>(probe.stage_bytes));
    if (room > 0 && stages >= WIDE_MIN_STAGES) {
      w = wide_layout(nc, resident != 0, stages);
      smem = fixed + w.q_bytes + stages * w.stage_bytes;
      return true;
    }
  }
  return false;
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v,
                const uint8_t* key_valid, void* out, void* scratch, int B,
                int H, int Lq, int Lk, int D, float scale,
                cudaStream_t stream) {
  const int BH = B * H;
  WideLayout w;
  int smem;
  if (D % 64 != 0 || D < 128) return static_cast<int>(cudaErrorInvalidValue);
  if (!wide_plan(D, Lk, w, smem)) return TOO_MANY_KEYS;
  __nv_bfloat16* q16 = static_cast<__nv_bfloat16*>(scratch);
  const void* k16 = k;
  const void* v16 = v;
  to_bf16_kernel<T><<<dim3((Lq + WIDE_BN - 1) / WIDE_BN, BH), 256, 0,
                      stream>>>(static_cast<const T*>(q), q16, nullptr, H, Lq,
                                D, scale);
  if (std::is_same<T, float>::value) {
    __nv_bfloat16* k_s = q16 + (size_t)BH * Lq * D;
    __nv_bfloat16* v_s = k_s + (size_t)BH * Lk * D;
    const dim3 grid((Lk + WIDE_BN - 1) / WIDE_BN, BH);
    to_bf16_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(k), k_s,
                                                 key_valid, H, Lk, D, 1.f);
    to_bf16_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(v), v_s,
                                                 key_valid, H, Lk, D, 1.f);
    k16 = k_s;
    v16 = v_s;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_map, k_map, v_map;
  if (!encode(&q_map, q16, D, Lq, BH, BM) ||
      !encode(&k_map, k16, D, Lk, BH, WIDE_BN) ||
      !encode(&v_map, v16, D, Lk, BH, WIDE_BN))
    return ENCODE_FAILED;
  static int allowed = 0;               // the largest size granted so far
  if (smem > allowed) {
    err = cudaFuncSetAttribute(flash_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const int slices = wide_slices(D / 64);
  flash_wide_kernel<T><<<dim3((Lq + BM - 1) / BM * slices, BH), THREADS, smem,
                         stream>>>(q_map, k_map, v_map, key_valid,
                                   static_cast<T*>(out), H, Lq, Lk, D,
                                   w.q_resident ? 1 : 0, w.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Lq, D), k and v (B, H, Lk, D), out (B, H, Lq, D): contiguous and
// 16-byte aligned, all f32 (dtype 0) or all bf16 (dtype 1); key_valid
// (B, Lk) one byte per key.  D is 64, 128, 192 or 256.  For f32,
// kv_scratch holds 2 B H Lk D bf16 (the rounded k, then v); for bf16 it is
// unused.  Returns the cudaError_t of the launches, -1 if no TMA map could
// be made, or -2 if Lk's key-tile masks do not fit in shared memory.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, const void* key_valid,
                                       void* out, void* kv_scratch, int B,
                                       int H, int Lq, int Lk, int D,
                                       int dtype, float scale, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lk == 0)  // no key: every row writes 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, (size_t)B * H * Lq * D * (dtype == 0 ? 4 : 2), s));
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
#define LAUNCH(DIM)                                                         \
  if (D == DIM)                                                             \
    return dtype == 0                                                       \
               ? launch<DIM, float>(q, k, v, valid, out, kv_scratch, B, H,  \
                                    Lq, Lk, scale, s)                       \
               : launch<DIM, __nv_bfloat16>(q, k, v, valid, out,            \
                                            kv_scratch, B, H, Lq, Lk,       \
                                            scale, s);
  LAUNCH(64)
  LAUNCH(128)
  LAUNCH(192)
  LAUNCH(256)
#undef LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The attention kernel's dynamic shared memory at head dim D (64, 128, 192
// or 256) and Lk keys, in bytes; 0 for another D.
extern "C" int flash_attention_smem_bytes(int D, int Lk) {
  return D == 64    ? smem_bytes<64>(Lk)
         : D == 128 ? smem_bytes<128>(Lk)
         : D == 192 ? smem_bytes<192>(Lk)
         : D == 256 ? smem_bytes<256>(Lk)
                    : 0;
}

// q (B, H, Lq, D), k and v (B, H, Lk, D), out (B, H, Lq, D) as for
// flash_attention_forward, D a multiple of 64 past 256.  scratch holds
// B H Lq D bf16 (the scaled, rounded q) and, for f32, 2 B H Lk D more (the
// rounded k, then v).  Returns the cudaError_t of the launches, -1 if no
// TMA map could be made, or -2 if the key tiles' words do not fit in shared
// memory beside a ring of 6 stages.
extern "C" int flash_attention_wide_forward(const void* q, const void* k,
                                            const void* v,
                                            const void* key_valid, void* out,
                                            void* scratch, int B, int H,
                                            int Lq, int Lk, int D, int dtype,
                                            float scale, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lk == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, (size_t)B * H * Lq * D * (dtype == 0 ? 4 : 2), s));
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
  if (dtype == 0)
    return launch_wide<float>(q, k, v, valid, out, scratch, B, H, Lq, Lk, D,
                              scale, s);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16>(q, k, v, valid, out, scratch, B, H, Lq,
                                      Lk, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide kernel's dynamic shared memory at head dim D (a multiple of 64)
// and Lk keys, in bytes (0 if it does not fit); *stages gets the ring's
// depth, negative where q streams through the ring instead of staying.
extern "C" int flash_attention_wide_smem_bytes(int D, int Lk, int* stages) {
  WideLayout w;
  int smem = 0;
  if (D % 64 != 0 || !wide_plan(D, Lk, w, smem)) return 0;
  *stages = w.q_resident ? w.stages : -w.stages;
  return smem;
}

extern "C" const char* flash_attention_error_string(int status) {
  if (status == ENCODE_FAILED)
    return "cuTensorMapEncodeTiled is unavailable or refused the tensor map";
  if (status == TOO_MANY_KEYS)
    return "Lk too large: the key tiles' masks do not fit in shared memory "
           "(at most 16,000 keys at D 128, 278,000 at D 192 and 256, 670,000 "
           "or more past 256)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
