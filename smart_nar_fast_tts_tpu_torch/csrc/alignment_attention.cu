// Alignment cross-attention of the MelEncoder, with its two loss reductions.
//
// Replaces the TPU kernel `_kernel` / `_forward` of
// smart_nar_fast_tts_tpu/ops/pallas/alignment.py.  For mel-frame queries q
// (B, H, T, D) over text keys and values k, v (B, H, L, D) it computes
//   out  = softmax(mask(QK^T / sqrt(D))) V                      (B, H, T, D)
//   idx  = argmax over the text axis of head 0's masked scores  (B, T) int32
//   gnum = sum over t < mel_len, n < src_len of W[t, n] p[t, n], head 0,
//          W = 1 - exp(-(n / src_len - t / mel_len)^2 / (2 sigma^2))   (B,)
// and the (B, H, T, L) probabilities never reach device memory.  An invalid
// key scores -1e30 and gets probability 0; the denominator is floored at
// 1e-37; the argmax takes the first index among equal maxima.
//
// Precision: both products run on the tensor cores in 3xTF32 with f32
// accumulators, the counterpart of the TPU kernel's Precision.HIGHEST (three
// bf16 passes on the MXU), because near-ties in the argmax decide the
// duration targets.  Each operand x (q, k, the unnormalised probabilities
// e, v) is split as hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest with ties away (the bits of cvt.rna; a register handed to the
// tensor core unrounded would just lose its low 13 bits), and a product sums
// lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of it, is dropped): about f32
// accuracy.  out = (3xTF32 e V) / l.
//
// Bound on the H100: the function moves q and out once (4 B H T D bytes
// each), k and v once; its products are 4 B H T D L_valid operations, three
// times over in 3xTF32, at the TF32 rate of 495 TFLOP/s.  At the flagship
// training shape (48, 2, 896, 128, 128) the two take ~0.030 ms each (at the
// f32 CUDA-core rate the products would take 0.074 ms).  mma.sync reaches
// ~316 TFLOP/s in TF32 on an H100 (profile_alignment.py), and with hi and
// lo both read from shared memory each m16n8k8 takes ~171 bytes of B
// operand a warp: at that rate ~114 of the SM's 128 bytes a cycle.  The
// products are bound by the tensor pipe and shared memory alike.
//
// Design for that:
// - mma.sync m16n8k8 tf32: a warp holds 16 frames' scores (a chunk of 64
//   keys) and 16 x D output as accumulator fragments in registers.  The
//   softmax, the argmax and the guided numerator run on those registers,
//   reduced across each quad of lanes by shuffles; no score tile is written
//   anywhere.  The three passes of a product go across 4 independent
//   accumulators, so that no tensor-core instruction waits on the last.
// - A persistent block (8 warps, one per SM: 215 KB of shared memory at D
//   128) walks a contiguous range of 16-frame units, in rounds of one unit
//   per warp within each (batch, head).  Keys go through shared memory in
//   chunks of KC (64 at D up to 128), split into hi and lo once for the
//   block (splitting in every warp cost 8x the ALU work), with an online
//   softmax across chunks; rounds take the chunks in alternating order, so
//   that each round starts on the chunk the last one ended with (L <= KC
//   stages K and V once per (b, h)).  Each warp loads its next unit's q by
//   cp.async while it finishes the current one, and its output stores
//   drain during the next round.
// - The block's shape follows the padded depth DP (struct Shape): each warp
//   keeps its 16 q rows in shared memory, and with KC 64 that is 314 KB at
//   DP 192, over a block's 227 KB.  So DP 192 takes chunks of KC 32 (210
//   KB) and DP 256 chunks of 16 (207 KB), both with 8 warps: more chunks a
//   round, but the warps that hide the tensor pipe's latency stay (4 warps
//   with chunks of 32 took 0.46 ms at DP 256 and the training shape, 8
//   warps with chunks of 16 0.39 on an H100).  The output fragment takes
//   16·DP/32 registers a lane (96 or 128).
// - Keys from an item's last valid one on are masked and change no output:
//   no chunk or key tile past it is staged or multiplied.
// - The exponentials and sums of key tile nt issue beside the PV product's
//   tensor-core instructions of tile nt - 1.
// - Operand layouts for 16-byte shared-memory reads without bank conflicts:
//   QK^T takes depth 4t..4t+3 of each 16-deep chunk as the k slots of two
//   k-steps (a float4 of q, K hi and K lo per lane), q and K rows padded to
//   D + 16 floats; V's key rows are staged permuted within each group of 8
//   ([0, 2, 4, 6, 1, 3, 5, 7]) so that the score accumulator (columns 2t,
//   2t + 1) is the PV product's A fragment (k slots t, t + 4) as it stands;
//   output columns are permuted so that a lane reads float4s of a V row
//   (rows padded to D + 4) and a row's four lanes store 64 contiguous bytes.
// - gnum: each 16-frame unit writes its partial sum, added in a fixed order,
//   and a second, one-thread-per-item launch adds the units' sums in frame
//   order: gnum and idx are bit-identical from run to run (no float atomics).
// The ragged edges of T, L and D are masked or zero-filled in the kernel: no
// padding copies.  Head dims past 256 run on the team and wide kernels at
// the end of this file.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;

// A block's shape at padded depth DP: KC keys per shared-memory chunk (NT
// 8-key tiles), WARPS warps of 16 frames each.
template <int DP> struct Shape {
  static constexpr int KC = 64, WARPS = 8;
};
template <> struct Shape<192> { static constexpr int KC = 32, WARPS = 8; };
template <> struct Shape<256> { static constexpr int KC = 16, WARPS = 8; };

// 16-frame units per (batch, head): the unit of work of a warp, and of the
// guided numerator's partial sums
__host__ __device__ inline int units_of(int T) { return (T + 15) / 16; }

// Row strides in floats for a depth padded to DP (32, 64, 128, 192 or
// 256): q and K rows ≡ 16 (mod 32) banks apart, V rows 4 apart, so that the
// 16-byte fragment reads below hit no bank twice.  Shared memory: 16 q rows
// per warp, a chunk of K and of V split into tf32 hi and lo (keys of V
// permuted), the chunk's key mask, two words per warp.
template <int DP> struct Layout {
  static constexpr int KC = Shape<DP>::KC, WARPS = Shape<DP>::WARPS;
  static constexpr int NT = KC / 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int QS = DP + 16;
  static constexpr int KS = DP + 16;
  static constexpr int VS = DP + 4;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)16 * WARPS * QS + 2 * (size_t)KC * KS +
                       2 * (size_t)KC * VS + KC + 2 * WARPS);
  static_assert(SMEM <= MAX_SMEM, "shared memory");
  static_assert(NT % 2 == 0, "key tiles go to the tensor cores in pairs");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// x rounded to tf32 (10 explicit mantissa bits), to nearest with ties away
// from zero: the bits of cvt.rna.tf32.f32, in two integer operations
// (cvt.rna compiles to a longer sequence)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 x), hi and lo tf32, both rounded to nearest
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ uint32_t word(const float4& v, int i) {
  return __float_as_uint(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

// c[i] += a b[i] for N (2 or 4) independent accumulators in 3xTF32: the
// three passes (lo·hi, hi·lo, hi·hi: the small terms first) go across the
// accumulators, so that no tensor-core instruction waits on the one before
// it
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[N][2],
                                           const uint32_t (&blo)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], ahi, blo[i][0], blo[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], ahi, bhi[i][0], bhi[i][1]);
}

// mma_3xtf32 with the two small passes summed apart from hi·hi: big[i] +=
// ahi bhi[i], small[i] += alo bhi[i] + ahi blo[i]
template <int N>
__device__ __forceinline__ void mma_3xtf32_apart(
    float (*big)[4], float (*small)[4], const uint32_t (&ahi)[4],
    const uint32_t (&alo)[4], const uint32_t (&bhi)[N][2],
    const uint32_t (&blo)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(small[i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(small[i], ahi, blo[i][0], blo[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(big[i], ahi, bhi[i][0], bhi[i][1]);
}

// cp.async rows [r0, r0 + nrows) of a (rows_total, D) matrix into dst with
// row stride `stride`, depth zero-padded to DP, rows past rows_total zero,
// by `threads` threads from `tid`; with `perm`, row r goes to (r & ~7) +
// ((r & 7) >> 1) + 4 (r & 1): keys 0, 2, 4, 6, 1, 3, 5, 7 of each group of 8
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int nrows, int rows_total,
                                           int D, int stride, bool perm,
                                           int tid, int threads) {
  constexpr int C4 = DP / 4;
  for (int i = tid; i < nrows * C4; i += threads) {
    const int r = i / C4, c = i % C4;
    const int n = r0 + r;
    const bool ok = n < rows_total && 4 * c < D;
    const int row = perm ? (r & ~7) + ((r & 7) >> 1) + ((r & 1) << 2) : r;
    cp_async16(dst + row * stride + 4 * c,
               ok ? src + (size_t)n * D + 4 * c : src, ok);
  }
}

// A block's chunk of keys [c0, c0 + KC): K and V (permuted) land in the lo
// buffers, and the mask (1 valid, 0 masked, -1 past L) in kval
template <int DP>
__device__ __forceinline__ void stage_chunk(float* klo, float* vlo,
                                            float* kval, const float* kb,
                                            const float* vb,
                                            const uint8_t* validb, int c0,
                                            int L, int D) {
  using Lay = Layout<DP>;
  constexpr int KC = Lay::KC, THREADS = Lay::THREADS;
  stage_rows<DP>(klo, kb, c0, KC, L, D, Lay::KS, false, threadIdx.x,
                 THREADS);
  stage_rows<DP>(vlo, vb, c0, KC, L, D, Lay::VS, true, threadIdx.x,
                 THREADS);
  cp_async_commit();
  for (int r = threadIdx.x; r < KC; r += THREADS) {
    const int n = c0 + r;
    kval[r] = n < L ? (validb[n] ? 1.f : 0.f) : -1.f;
  }
}

// Split a staged chunk in place: lo holds the f32 values, hi gets tf32(x),
// lo gets tf32(x - hi)
template <int DP>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int stride) {
  constexpr int C4 = DP / 4, KC = Layout<DP>::KC;
  for (int i = threadIdx.x; i < KC * C4; i += Layout<DP>::THREADS) {
    const int off = (i / C4) * stride + 4 * (i % C4);
    const float4 x = *reinterpret_cast<const float4*>(lo + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// The per-warp state of 16 frames: lane (g, t) holds rows g and g + 8
struct Rows {
  int t[2];                            // frame index
  bool frame_ok[2];                    // t < T and t < mel_len
  float tpos[2];                       // t / mel_len
  float m[2], lsum[2], gacc[2];        // running max; the lane's sums of
  int best[2];                         // e = exp(s - m) and W e; argmax
};

__device__ __forceinline__ void init_rows(Rows& r, int t0, int g, int T,
                                          float olen) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r.t[i] = t0 + g + 8 * i;
    r.frame_ok[i] = r.t[i] < T && (float)r.t[i] < olen;
    r.tpos[i] = (float)r.t[i] / olen;
    r.m[i] = -INFINITY;
    r.lsum[i] = r.gacc[i] = 0.f;
    r.best[i] = 0;
  }
}

// S = Q K^T over the chunk's first `ntiles` key tiles (in steps of G, 4
// or all of a chunk's 2), 3xTF32.  k-step 2c takes depths d0, d0 + 1 as
// k slots t, t + 4, k-step 2c + 1 depths d0 + 2, d0 + 3 (d0 = 16 c + 4 t):
// one float4 of q, of K hi and of K lo per lane and key tile.  Past DP 128
// the small passes (lo·hi, hi·lo) are summed apart and added to hi·hi at
// the end, as the 3xTF32 plain version groups them: a chain of 3·DP/8
// tensor-core sums into one score drifts from either plain version by more
// than the f32 tolerances allow at DP 192 and 256 (up to 8.9e-6 against the
// 3xTF32 one at DP 192, L 1000, where DP 128 stays within 5e-6).  Up to DP
// 128 the one chain stays: summed apart there, the kernel at the training
// shape took 0.1712 and 0.1722 ms against 0.1694 and 0.1688 (one call on an
// H100, chip_smoke.py's timing).
template <int DP>
__device__ __forceinline__ void qk_product(float (&s)[Layout<DP>::NT][4],
                                           const float* q0, const float* q1,
                                           const float* khi, const float* klo,
                                           int g, int tq, int ntiles) {
  constexpr int NT = Layout<DP>::NT, G = NT < 4 ? NT : 4;
  constexpr bool APART = DP > 128;
  float small[APART ? NT : 1][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < (APART ? NT : 1); ++nt)
    small[nt][0] = small[nt][1] = small[nt][2] = small[nt][3] = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    const int d0 = 16 * c + 4 * tq;
    uint32_t ah[2][4], al[2][4];
    {
      const float4 xa = *reinterpret_cast<const float4*>(q0 + d0);
      const float4 xb = *reinterpret_cast<const float4*>(q1 + d0);
      const float a0[4] = {xa.x, xb.x, xa.y, xb.y};
      const float a1[4] = {xa.z, xb.z, xa.w, xb.w};
      split4(a0, ah[0], al[0]);
      split4(a1, ah[1], al[1]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += G) {
      if (n0 >= ntiles) break;
      uint32_t bh[2][G][2], bl[2][G][2];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int off = (8 * (n0 + i) + g) * Layout<DP>::KS + d0;
        const float4 h4 = *reinterpret_cast<const float4*>(khi + off);
        const float4 l4 = *reinterpret_cast<const float4*>(klo + off);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bh[j >> 1][i][j & 1] = word(h4, j);
          bl[j >> 1][i][j & 1] = word(l4, j);
        }
      }
      if constexpr (APART) {
        mma_3xtf32_apart<G>(s + n0, small + n0, ah[0], al[0], bh[0], bl[0]);
        mma_3xtf32_apart<G>(s + n0, small + n0, ah[1], al[1], bh[1], bl[1]);
      } else {
        mma_3xtf32<G>(s + n0, ah[0], al[0], bh[0], bl[0]);
        mma_3xtf32<G>(s + n0, ah[1], al[1], bh[1], bl[1]);
      }
    }
  }
  if constexpr (APART) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += small[nt][e];
  }
}

// Scale and mask the chunk's scores and fold them into the running max and
// argmax (first index among equal maxima, whatever the order of chunks);
// returns the factor exp(m_old - m) for the sums and the output.
template <int NT>
__device__ __forceinline__ void chunk_max(float (&s)[NT][4], Rows& r,
                                          float (&alpha)[2],
                                          const float* kval, int c0, int tq,
                                          float inv_sqrt_d) {
  float cmax[2] = {-INFINITY, -INFINITY};
  int cidx[2] = {0, 0};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * tq + (e & 1), i = e >> 1;
      const float kv = kval[col];
      const float x = kv > 0.f ? s[nt][e] * inv_sqrt_d
                               : (kv == 0.f ? NEG_INF : -INFINITY);
      s[nt][e] = x;
      if (x > cmax[i]) { cmax[i] = x; cidx[i] = c0 + col; }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cmax[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, cidx[i], off);
      if (ov > cmax[i] || (ov == cmax[i] && oi < cidx[i])) {
        cmax[i] = ov;
        cidx[i] = oi;
      }
    }
    const float m_new = fmaxf(r.m[i], cmax[i]);
    if (cmax[i] > r.m[i] || (cmax[i] == r.m[i] && cidx[i] < r.best[i]))
      r.best[i] = cidx[i];
    alpha[i] = expf(r.m[i] - m_new);   // 0 on the first chunk
    r.m[i] = m_new;
    r.lsum[i] *= alpha[i];
    r.gacc[i] *= alpha[i];
  }
}

// For each of the chunk's first `ntiles` key tiles: e = exp(s - m), its
// sums and the guided numerator's terms, then O += P V for the tile in
// 3xTF32 (the exponentials of one tile issue beside the tensor-core
// instructions of the last; the tiles past it hold masked keys only).  The
// score fragment of key tile nt (columns 2t, 2t + 1) is the A fragment of
// k-step nt (k slots t, t + 4), V's rows being staged permuted.  Output
// column tile j, slot n is column col(j, n) = 32 (j / 4) + 16 (n % 2) +
// 4 (n / 2) + j % 4: a lane reads float4s of a V row, and the four lanes of
// a row store 64 contiguous bytes.
template <int DP>
__device__ __forceinline__ void exp_pv_product(
    float (&o)[DP / 8][4], const float (&s)[Layout<DP>::NT][4], Rows& r,
    const float* kval, const float* vhi, const float* vlo, int c0, int g,
    int tq, int ntiles, bool guided, float ilen, float inv_ilen,
    float inv_2s2) {
  constexpr int NJ = DP / 8, VS = Layout<DP>::VS, NT = Layout<DP>::NT;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= ntiles) break;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * tq + (e & 1), i = e >> 1;
      p[e] = kval[col] > 0.f ? expf(s[nt][e] - r.m[i]) : 0.f;
      r.lsum[i] += p[e];
      const float n = (float)(c0 + col);
      if (guided && r.frame_ok[i] && n < ilen) {
        const float dn = n * inv_ilen - r.tpos[i];
        r.gacc[i] += (1.f - expf(-(dn * dn) * inv_2s2)) * p[e];
      }
    }
    uint32_t ph[4], pl[4];
    const float a[4] = {p[0], p[2], p[1], p[3]};
    split4(a, ph, pl);
    const int off = (8 * nt + tq) * VS + 16 * (g & 1) + 4 * (g >> 1);
#pragma unroll
    for (int f = 0; f < NJ / 4; ++f) {
      const float4 h0 = *reinterpret_cast<const float4*>(vhi + off + 32 * f);
      const float4 h1 =
          *reinterpret_cast<const float4*>(vhi + off + 4 * VS + 32 * f);
      const float4 l0 = *reinterpret_cast<const float4*>(vlo + off + 32 * f);
      const float4 l1 =
          *reinterpret_cast<const float4*>(vlo + off + 4 * VS + 32 * f);
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bh[i][0] = word(h0, i);
        bh[i][1] = word(h1, i);
        bl[i][0] = word(l0, i);
        bl[i][1] = word(l1, i);
      }
      mma_3xtf32<4>(o + 4 * f, ph, pl, bh, bl);
    }
  }
}

// out = O / max(l, 1e-37) for the warp's rows; head 0 also writes idx and
// returns, in every lane, the guided numerator of the 16 frames summed in a
// fixed order
template <int DP>
__device__ __forceinline__ float finish_rows(Rows& r,
                                             const float (&o)[DP / 8][4],
                                             float* out_bh, int* idx_b,
                                             int T, int D, int tq,
                                             bool head0) {
  constexpr int NJ = DP / 8;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.lsum[i] += __shfl_xor_sync(0xffffffffu, r.lsum[i], off);
      r.gacc[i] += __shfl_xor_sync(0xffffffffu, r.gacc[i], off);
    }
    inv[i] = 1.f / fmaxf(r.lsum[i], 1e-37f);
  }
  // lane (g, t) holds columns col(j, 2t + half) = 32 f + 16 half + 4 t + i
  // for j = 4 f + i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r.t[i] >= T) continue;
    float* orow = out_bh + (size_t)r.t[i] * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int f = 0; f < NJ / 4; ++f) {
        const int col0 = 32 * f + 16 * half + 4 * tq;
        if (col0 >= D) continue;
        const int e = 2 * i + half;
        *reinterpret_cast<float4*>(orow + col0) = make_float4(
            o[4 * f][e] * inv[i], o[4 * f + 1][e] * inv[i],
            o[4 * f + 2][e] * inv[i], o[4 * f + 3][e] * inv[i]);
      }
    }
  }
  float gsum = 0.f;
  if (head0) {
    if (tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r.t[i] < T) idx_b[r.t[i]] = r.best[i];
      gsum = (r.frame_ok[0] ? r.gacc[0] * inv[0] : 0.f) +
             (r.frame_ok[1] ? r.gacc[1] * inv[1] : 0.f);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
  }
  return gsum;
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* key_valid;
  const int* src_lens;
  const int* mel_lens;
  float* out;
  int* idx;
  float* partial;                      // (B, units_of(T))
  int H, T, L, D;
  float inv_sqrt_d, inv_2s2;
};

// A persistent block walks a contiguous range of 16-frame units (b, h, u),
// in rounds of one unit per warp within each (b, h).  The keys go through
// shared memory in chunks of KC, split into tf32 hi and lo once for the
// block, with an online softmax (running max, rescaled sums) across chunks;
// the rounds take the chunks in alternating order, so that a round starts
// on the chunk the last one ended with and stages one chunk fewer (none at
// all where L <= KC).  Each warp loads its next unit's q while it finishes
// the current one, and its stores drain during the next round.
template <int DP>
__global__ void __launch_bounds__(Layout<DP>::THREADS, 1)
alignment_kernel(const Args a, int total_units) {
  using Lay = Layout<DP>;
  constexpr int KC = Lay::KC, NT = Lay::NT, WARPS = Lay::WARPS;
  constexpr int THREADS = Lay::THREADS;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  float* qs = smem + warp * 16 * Lay::QS;   // this warp's 16 q rows
  float* khi = smem + 16 * WARPS * Lay::QS;
  float* klo = khi + KC * Lay::KS;
  float* vhi = klo + KC * Lay::KS;
  float* vlo = vhi + KC * Lay::VS;
  float* kval = vlo + KC * Lay::VS;
  int* kend_of = reinterpret_cast<int*>(kval + KC);   // 2 x WARPS
  const int U = units_of(a.T);
  const int u_begin = (int)((long long)blockIdx.x * total_units / gridDim.x);
  const int u_end = (int)((long long)(blockIdx.x + 1) * total_units / gridDim.x);

  auto stage_q = [&](int unit) {
    const size_t bh = unit / U;
    stage_rows<DP>(qs, a.q + bh * a.T * a.D, 16 * (unit % U), 16, a.T, a.D,
                   Lay::QS, false, lane, 32);
    cp_async_commit();
  };

  int parity = 0;
  for (int seg = u_begin; seg < u_end;) {
    const int bh = seg / U;
    const int seg_end = min(u_end, (bh + 1) * U);
    const int b = bh / a.H, h = bh % a.H;
    const float* kb = a.k + (size_t)bh * a.L * a.D;
    const float* vb = a.v + (size_t)bh * a.L * a.D;
    const uint8_t* validb = a.key_valid + (size_t)b * a.L;
    const float ilen = (float)a.src_lens[b], olen = (float)a.mel_lens[b];
    const float inv_ilen = 1.f / ilen;
    float* out_bh = a.out + (size_t)bh * a.T * a.D;
    int* idx_b = a.idx + (size_t)b * a.T;
    // keys from the last valid one on are masked: they change no output
    // (an argmax over masked keys only is key 0), so no chunk or key tile
    // past it is staged or multiplied.  Two slots, by segment parity: each
    // warp reads the slot right after the barrier below, and no warp writes
    // it again before every warp has passed the next segment's barrier.
    int last = 0;
    for (int n = threadIdx.x; n < a.L; n += THREADS)
      if (validb[n]) last = n + 1;
    last = __reduce_max_sync(0xffffffffu, last);
    int* slot = kend_of + (parity ^= 1) * WARPS;
    if (lane == 0) slot[warp] = last;
    __syncthreads();
    int kend = 0;
    for (int w = 0; w < WARPS; ++w) kend = max(kend, slot[w]);
    const int chunks = max(1, (kend + KC - 1) / KC);
    int resident = -1;                 // the chunk in shared memory
    if (seg + warp < seg_end) stage_q(seg + warp);

    for (int round = seg; round < seg_end; round += WARPS) {
      const int unit = round + warp;
      const bool active = unit < seg_end;
      const bool reverse = ((round - seg) / WARPS) & 1;
      const bool prefetch = unit + WARPS < seg_end;
      Rows r;
      init_rows(r, 16 * (unit % U), g, a.T, olen);
      float o[DP / 8][4];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

      for (int i = 0; i < chunks; ++i) {
        const int ch = reverse ? chunks - 1 - i : i;
        if (ch != resident) {
          __syncthreads();             // every warp is done with the chunk
          stage_chunk<DP>(klo, vlo, kval, kb, vb, validb, KC * ch, a.L, a.D);
          cp_async_wait_all();
          __syncthreads();
          split_rows<DP>(khi, klo, Lay::KS);
          split_rows<DP>(vhi, vlo, Lay::VS);
          __syncthreads();
          resident = ch;
        }
        if (!active) continue;
        const int ntiles = min(NT, max(0, (kend - KC * ch + 7) / 8));
        float s[NT][4];
        qk_product<DP>(s, qs + g * Lay::QS, qs + (g + 8) * Lay::QS, khi, klo,
                       g, tq, ntiles);
        if (i == chunks - 1 && prefetch) {
          __syncwarp();                // every lane is done with q
          stage_q(unit + WARPS);
        }
        float alpha[2];
        chunk_max(s, r, alpha, kval, KC * ch, tq, a.inv_sqrt_d);
        if (i > 0) {
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
            o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
          }
        }
        exp_pv_product<DP>(o, s, r, kval, vhi, vlo, KC * ch, g, tq, ntiles,
                           h == 0, ilen, inv_ilen, a.inv_2s2);
      }
      if (active) {
        const float gsum =
            finish_rows<DP>(r, o, out_bh, idx_b, a.T, a.D, tq, h == 0);
        if (h == 0 && lane == 0) a.partial[(size_t)b * U + unit % U] = gsum;
      }
      cp_async_wait_all();              // the next unit's q
      __syncwarp();
    }
    seg = seg_end;
  }
}

// gnum[b] = the 16-frame units' partial sums of item b, added in order.
__global__ void gnum_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ gnum, int B,
                                   int units) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float total = 0.f;
  for (int i = 0; i < units; ++i) total += partial[(size_t)b * units + i];
  gnum[b] = total;
}

template <int DP>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = Layout<DP>::SMEM;
  const int units = B * a.H * units_of(a.T);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(alignment_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  alignment_kernel<DP><<<min(sms, units), Layout<DP>::THREADS, smem, s>>>(
      a, units);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims past 256: the wide kernel.
//
// The same function, contract and 3xTF32 products as the kernel above, for
// any D (a multiple of 4).  What stops that design at 256 is the output
// fragment (16·DP/32 registers a lane, 160 at DP 320) and each warp's q rows
// beside a K chunk in shared memory.  So here:
//  * the output's columns are split into slices of at most WIDE_SLICE
//    columns, as even as 32-column groups allow (D 320: 160 + 160; 384:
//    192 + 192; 512: 192 + 160 + 160); a warp computes the full scores of
//    its 16 frames and writes one slice, so every slice runs its own online
//    softmax over the same scores (Q K^T once per slice);
//  * scores accumulate over D in chunks of `dc` columns (the widest
//    multiple of 32, at most 256, that fits: 192): the block stages a chunk
//    of WIDE_KC keys x dc columns of K, split into tf32 hi and lo once for
//    the block, as the kernel above stages a whole key chunk, and each warp
//    stages its 16 q rows' dc columns beside it; the small passes (lo·hi,
//    hi·lo) are summed apart from hi·hi across all of D;
//  * only slice 0 writes idx and the guided numerator's partial sums, so no
//    term is counted twice and the fixed order of the sums holds.
// The team kernel below does the scores once for all slices where its
// shared memory fits (D up to 512); this kernel takes every other D.
// Bound: as for the kernel above, the 3xTF32 products over the valid keys
// at the TF32 rate; this kernel does Q K^T once per slice.
// The persistent-block walk over 16-frame units (now of (batch, head,
// slice)), the alternating order of key chunks, the skipping of keys past an
// item's last valid one and the second launch that adds the partial sums
// are those of the kernel above.
constexpr int WIDE_KC = 32, WIDE_NT = WIDE_KC / 8;  // keys a chunk, tiles
constexpr int WIDE_NJ = 24;                   // 8-column tiles of a slice
constexpr int WIDE_SLICE = 8 * WIDE_NJ;       // 192 columns
constexpr int WIDE_VS = WIDE_SLICE + 4;       // V row stride, ≡ 4 (mod 32)
constexpr int WIDE_MAX_WARPS = 8;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The runtime shape of a wide launch
struct Wide {
  int slices;          // output column slices
  int dq;              // depth swept: D rounded up to 16
  int dc, ndc;         // columns a K chunk, K chunks over dq
  int ks;              // q and K row stride (≡ 16 mod 32 floats)
};

// slice `slice`'s first column and width (multiples of 32)
__host__ __device__ inline void wide_cols(int D, int slices, int slice,
                                          int& c0, int& dv) {
  const int groups = (D + 31) / 32;
  const int base = groups / slices, rem = groups % slices;
  dv = 32 * (base + (slice < rem ? 1 : 0));
  c0 = 32 * (slice * base + (slice < rem ? slice : rem));
}

__host__ __device__ inline size_t wide_smem(int ks) {
  return sizeof(float) * ((size_t)WIDE_MAX_WARPS * 16 * ks +
                          2 * (size_t)WIDE_KC * ks +
                          2 * (size_t)WIDE_KC * WIDE_VS + WIDE_KC +
                          2 * WIDE_MAX_WARPS);
}

// cp.async rows [r0, r0 + nrows) and columns [c0, c0 + ncols) (multiples
// of 4) of a (rows_total, D) matrix into dst with row stride `stride`,
// zeros past D and rows_total; `perm` as stage_rows
__device__ __forceinline__ void stage_block(float* dst, const float* src,
                                            int r0, int nrows, int rows_total,
                                            int D, int c0, int ncols,
                                            int stride, bool perm, int tid,
                                            int threads) {
  const int c4 = ncols / 4;
#pragma unroll 1
  for (int i = tid; i < nrows * c4; i += threads) {
    const int r = i / c4, c = i % c4;
    const int n = r0 + r, col = c0 + 4 * c;
    const bool ok = n < rows_total && col < D;
    const int row = perm ? (r & ~7) + ((r & 7) >> 1) + ((r & 1) << 2) : r;
    cp_async16(dst + row * stride + 4 * c,
               ok ? src + (size_t)n * D + col : src, ok);
  }
}

// split_rows over nrows x ncols at stride `stride`
__device__ __forceinline__ void split_block(float* hi, float* lo, int nrows,
                                            int ncols, int stride, int tid,
                                            int threads) {
  const int c4 = ncols / 4;
#pragma unroll 1
  for (int i = tid; i < nrows * c4; i += threads) {
    const int off = (i / c4) * stride + 4 * (i % c4);
    const float4 x = *reinterpret_cast<const float4*>(lo + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// big += q_hi K_hi^T, small += q_lo K_hi^T + q_hi K_lo^T over `width`
// depths (a multiple of 16) of a staged K chunk: as qk_product, with q rows
// q0 and q1 and K rows starting at the chunk's first column.  hi·hi goes
// through the tensor cores in runs of WIDE_RUN depths, each into a zeroed
// accumulator then added to big in f32: the tensor cores' f32 sums drift
// with the length of a chain (with one chain over all of D, `out` at D 512
// and L 1000 lay 8.4e-6 from the 3xTF32 plain version on an H100, beyond
// the 8e-6 of tests/test_torch_kernels_cuda.py).
constexpr int WIDE_RUN = 128;

template <int NT>
__device__ __forceinline__ void wide_qk(float (&big)[NT][4],
                                        float (&small)[NT][4],
                                        const float* q0, const float* q1,
                                        const float* khi, const float* klo,
                                        int ks, int g, int tq, int width) {
  float run[NT][4];
  for (int c = 0; c < width / 16; ++c) {
    if (c % (WIDE_RUN / 16) == 0) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        run[i][0] = run[i][1] = run[i][2] = run[i][3] = 0.f;
    }
    const int d0 = 16 * c + 4 * tq;
    uint32_t ah[2][4], al[2][4];
    {
      const float4 xa = *reinterpret_cast<const float4*>(q0 + d0);
      const float4 xb = *reinterpret_cast<const float4*>(q1 + d0);
      const float a0[4] = {xa.x, xb.x, xa.y, xb.y};
      const float a1[4] = {xa.z, xb.z, xa.w, xb.w};
      split4(a0, ah[0], al[0]);
      split4(a1, ah[1], al[1]);
    }
    uint32_t bh[2][NT][2], bl[2][NT][2];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int off = (8 * i + g) * ks + d0;
      const float4 h4 = *reinterpret_cast<const float4*>(khi + off);
      const float4 l4 = *reinterpret_cast<const float4*>(klo + off);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bh[j >> 1][i][j & 1] = word(h4, j);
        bl[j >> 1][i][j & 1] = word(l4, j);
      }
    }
    mma_3xtf32_apart<NT>(run, small, ah[0], al[0], bh[0], bl[0]);
    mma_3xtf32_apart<NT>(run, small, ah[1], al[1], bh[1], bl[1]);
    if ((c + 1) % (WIDE_RUN / 16) == 0 || c + 1 == width / 16) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[i][e] += run[i][e];
    }
  }
}

// exp_pv_product for a slice of `nf` 32-column groups (V staged at stride
// WIDE_VS from the slice's first column)
template <int NT>
__device__ __forceinline__ void wide_exp_pv(
    float (&o)[WIDE_NJ][4], const float (&s)[NT][4], Rows& r,
    const float* kval, const float* vhi, const float* vlo, int c0, int g,
    int tq, int ntiles, bool guided, float ilen, float inv_ilen,
    float inv_2s2, int nf) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= ntiles) break;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * tq + (e & 1), i = e >> 1;
      p[e] = kval[col] > 0.f ? expf(s[nt][e] - r.m[i]) : 0.f;
      r.lsum[i] += p[e];
      const float n = (float)(c0 + col);
      if (guided && r.frame_ok[i] && n < ilen) {
        const float dn = n * inv_ilen - r.tpos[i];
        r.gacc[i] += (1.f - expf(-(dn * dn) * inv_2s2)) * p[e];
      }
    }
    uint32_t ph[4], pl[4];
    const float a[4] = {p[0], p[2], p[1], p[3]};
    split4(a, ph, pl);
    const int off = (8 * nt + tq) * WIDE_VS + 16 * (g & 1) + 4 * (g >> 1);
#pragma unroll
    for (int f = 0; f < WIDE_NJ / 4; ++f) {
      if (f >= nf) break;
      const float4 h0 = *reinterpret_cast<const float4*>(vhi + off + 32 * f);
      const float4 h1 =
          *reinterpret_cast<const float4*>(vhi + off + 4 * WIDE_VS + 32 * f);
      const float4 l0 = *reinterpret_cast<const float4*>(vlo + off + 32 * f);
      const float4 l1 =
          *reinterpret_cast<const float4*>(vlo + off + 4 * WIDE_VS + 32 * f);
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bh[i][0] = word(h0, i);
        bh[i][1] = word(h1, i);
        bl[i][0] = word(l0, i);
        bl[i][1] = word(l1, i);
      }
      mma_3xtf32<4>(o + 4 * f, ph, pl, bh, bl);
    }
  }
}

// finish_rows for a slice from column c0 of `nf` 32-column groups; `first`
// (head 0, slice 0) also writes idx and returns the guided numerator
__device__ __forceinline__ float wide_finish(Rows& r,
                                             const float (&o)[WIDE_NJ][4],
                                             float* out_bh, int* idx_b,
                                             int T, int D, int tq, int c0,
                                             int nf, bool first) {
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.lsum[i] += __shfl_xor_sync(0xffffffffu, r.lsum[i], off);
      r.gacc[i] += __shfl_xor_sync(0xffffffffu, r.gacc[i], off);
    }
    inv[i] = 1.f / fmaxf(r.lsum[i], 1e-37f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r.t[i] >= T) continue;
    float* orow = out_bh + (size_t)r.t[i] * D + c0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int f = 0; f < WIDE_NJ / 4; ++f) {
        const int col0 = 32 * f + 16 * half + 4 * tq;
        if (f >= nf || c0 + col0 >= D) continue;
        const int e = 2 * i + half;
        *reinterpret_cast<float4*>(orow + col0) = make_float4(
            o[4 * f][e] * inv[i], o[4 * f + 1][e] * inv[i],
            o[4 * f + 2][e] * inv[i], o[4 * f + 3][e] * inv[i]);
      }
    }
  }
  float gsum = 0.f;
  if (first) {
    if (tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r.t[i] < T) idx_b[r.t[i]] = r.best[i];
      gsum = (r.frame_ok[0] ? r.gacc[0] * inv[0] : 0.f) +
             (r.frame_ok[1] ? r.gacc[1] * inv[1] : 0.f);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
  }
  return gsum;
}

// The walk of alignment_kernel over units (b, h, slice, 16 frames); each
// key chunk's scores sum over the chunks of K, then its softmax, argmax,
// guided numerator and P V as there.
__global__ void __launch_bounds__(32 * WIDE_MAX_WARPS, 1)
alignment_wide_kernel(const Args a, const Wide w, int total_units) {
  constexpr int KC = WIDE_KC, NT = WIDE_NT;
  extern __shared__ __align__(16) float smem[];
  // WIDE_MAX_WARPS warps, read at run time: as compile-time constants they
  // let the staging loops take registers enough to spill (255 registers
  // and 112 spill bytes in chip_smoke.py's build report on an H100)
  const int warps = blockDim.x / 32, threads = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  float* qs = smem + warp * 16 * w.ks;       // this warp's 16 q rows
  float* khi = smem + warps * 16 * w.ks;
  float* klo = khi + KC * w.ks;
  float* vhi = klo + KC * w.ks;
  float* vlo = vhi + KC * WIDE_VS;
  float* kval = vlo + KC * WIDE_VS;
  int* kend_of = reinterpret_cast<int*>(kval + KC);   // 2 x WIDE_MAX_WARPS
  const int U = units_of(a.T);
  const int u_begin = (int)((long long)blockIdx.x * total_units / gridDim.x);
  const int u_end =
      (int)((long long)(blockIdx.x + 1) * total_units / gridDim.x);

  int parity = 0;
  for (int seg = u_begin; seg < u_end;) {
    const int sg = seg / U;                  // (b, h, slice)
    const int seg_end = min(u_end, (sg + 1) * U);
    const int bh = sg / w.slices, slice = sg % w.slices;
    const int b = bh / a.H, h = bh % a.H;
    int c0, dv;
    wide_cols(a.D, w.slices, slice, c0, dv);
    const int nf = dv / 32;
    const bool first = h == 0 && slice == 0;
    const float* kb = a.k + (size_t)bh * a.L * a.D;
    const float* vb = a.v + (size_t)bh * a.L * a.D;
    const uint8_t* validb = a.key_valid + (size_t)b * a.L;
    const float ilen = (float)a.src_lens[b], olen = (float)a.mel_lens[b];
    const float inv_ilen = 1.f / ilen;
    float* out_bh = a.out + (size_t)bh * a.T * a.D;
    int* idx_b = a.idx + (size_t)b * a.T;
    int last = 0;
    for (int n = threadIdx.x; n < a.L; n += threads)
      if (validb[n]) last = n + 1;
    last = __reduce_max_sync(0xffffffffu, last);
    int* slot = kend_of + (parity ^= 1) * WIDE_MAX_WARPS;
    if (lane == 0) slot[warp] = last;
    __syncthreads();
    int kend = 0;
    for (int i = 0; i < warps; ++i) kend = max(kend, slot[i]);
    const int chunks = max(1, (kend + KC - 1) / KC);
    int res_k = -1, res_v = -1;              // the staged K chunk, V chunk
    const float* q_bh = a.q + (size_t)bh * a.T * a.D;

    for (int round = seg; round < seg_end; round += warps) {
      const int unit = round + warp;
      const bool active = unit < seg_end;
      const bool reverse = ((round - seg) / warps) & 1;
      Rows r;
      init_rows(r, 16 * (unit % U), g, a.T, olen);
      float o[WIDE_NJ][4];
#pragma unroll
      for (int j = 0; j < WIDE_NJ; ++j)
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

      for (int i = 0; i < chunks; ++i) {
        const int ch = reverse ? chunks - 1 - i : i;
        float s[NT][4], small[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = small[nt][e] = 0.f;
        for (int j = 0; j < w.ndc; ++j) {
          const int d0 = j * w.dc, width = min(w.dc, w.dq - d0);
          const int piece = ch * w.ndc + j;
          const bool need_k = piece != res_k, need_v = ch != res_v;
          __syncthreads();                 // every warp is done with them
          if (need_k)
            stage_block(klo, kb, KC * ch, KC, a.L, a.D, d0, width, w.ks,
                        false, threadIdx.x, threads);
          if (need_v) {
            stage_block(vlo, vb, KC * ch, KC, a.L, a.D, c0, dv, WIDE_VS,
                        true, threadIdx.x, threads);
            for (int k = threadIdx.x; k < KC; k += threads) {
              const int n = KC * ch + k;
              kval[k] = n < a.L ? (validb[n] ? 1.f : 0.f) : -1.f;
            }
          }
          if (active)                        // q rows, with every chunk
            stage_block(qs, q_bh, 16 * (unit % U), 16, a.T, a.D, d0, width,
                        w.ks, false, lane, 32);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
          if (need_k)
            split_block(khi, klo, KC, width, w.ks, threadIdx.x, threads);
          if (need_v)
            split_block(vhi, vlo, KC, dv, WIDE_VS, threadIdx.x, threads);
          __syncthreads();
          res_k = piece;
          res_v = ch;
          if (active)
            wide_qk(s, small, qs + g * w.ks, qs + (g + 8) * w.ks, khi, klo,
                    w.ks, g, tq, width);
        }
        if (!active) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += small[nt][e];
        float alpha[2];
        chunk_max<NT>(s, r, alpha, kval, KC * ch, tq, a.inv_sqrt_d);
        if (i > 0) {
#pragma unroll
          for (int j = 0; j < WIDE_NJ; ++j) {
            o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
            o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
          }
        }
        const int ntiles = min(NT, max(0, (kend - KC * ch + 7) / 8));
        wide_exp_pv(o, s, r, kval, vhi, vlo, KC * ch, g, tq, ntiles,
                    h == 0, ilen, inv_ilen, a.inv_2s2, nf);
      }
      if (active) {
        const float gsum = wide_finish(r, o, out_bh, idx_b, a.T, a.D, tq, c0,
                                       nf, first);
        if (first && lane == 0) a.partial[(size_t)b * U + unit % U] = gsum;
      }
    }
    seg = seg_end;
  }
}

// The wide kernel in teams, where its shared memory fits (D up to 512 with
// 8 or 6 warps): a team of as many warps as there are output slices takes
// one 16-frame unit, and its warp s computes the unit's scores over the
// columns of slice s only (its q rows over those columns stay in shared
// memory); the warps add their partial scores through shared memory, in
// the same order in every warp, so each warp of the team holds the same
// scores, runs the same softmax and then its own slice's P V.  So Q K^T is
// done once, not once per slice, and a key chunk is staged over all of D
// at once (chunks of TEAM_KC keys).
constexpr int TEAM_KC = 16, TEAM_NT = TEAM_KC / 8;

struct Team {
  int slices;          // warps a team: output slices
  int dk;              // K's staged depth: D rounded up to 32
  int qs, ks;          // q and K row strides
  int warps;           // teams x slices
};

__host__ __device__ inline size_t team_smem(const Team& t) {
  return sizeof(float) *
         ((size_t)t.warps * 16 * t.qs + 2 * (size_t)TEAM_KC * t.ks +
          2 * (size_t)t.slices * TEAM_KC * WIDE_VS + TEAM_KC +
          (size_t)t.warps * 32 * TEAM_NT * 4 + 2 * WIDE_MAX_WARPS);
}

__device__ __forceinline__ void team_sync(int team, int warps) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + team), "r"(32 * warps)
               : "memory");
}

__global__ void __launch_bounds__(32 * WIDE_MAX_WARPS, 1)
alignment_team_kernel(const Args a, const Team t, int total_units) {
  constexpr int KC = TEAM_KC, NT = TEAM_NT;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32, threads = blockDim.x;
  const int S = t.slices, teams = warps / S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int team = warp / S, slice = warp % S;
  int c0, dv;
  wide_cols(a.D, S, slice, c0, dv);
  const int nf = dv / 32;
  float* qs = smem + warp * 16 * t.qs;       // this warp's q rows, its slice
  float* khi = smem + warps * 16 * t.qs;
  float* klo = khi + KC * t.ks;
  float* vhi = klo + KC * t.ks;              // slice s at s KC WIDE_VS
  float* vlo = vhi + S * KC * WIDE_VS;
  float* kval = vlo + S * KC * WIDE_VS;
  float* part = kval + KC;                   // warps x 32 lanes x NT x 4
  int* kend_of = reinterpret_cast<int*>(part + warps * 32 * NT * 4);
  const int U = units_of(a.T);
  const int u_begin = (int)((long long)blockIdx.x * total_units / gridDim.x);
  const int u_end =
      (int)((long long)(blockIdx.x + 1) * total_units / gridDim.x);

  auto stage_q = [&](int unit) {
    stage_block(qs, a.q + (size_t)(unit / U) * a.T * a.D, 16 * (unit % U), 16,
                a.T, a.D, c0, dv, t.qs, false, lane, 32);
    cp_async_commit();
  };

  int parity = 0;
  for (int seg = u_begin; seg < u_end;) {
    const int bh = seg / U;
    const int seg_end = min(u_end, (bh + 1) * U);
    const int b = bh / a.H, h = bh % a.H;
    const bool first = h == 0 && slice == 0;
    const float* kb = a.k + (size_t)bh * a.L * a.D;
    const float* vb = a.v + (size_t)bh * a.L * a.D;
    const uint8_t* validb = a.key_valid + (size_t)b * a.L;
    const float ilen = (float)a.src_lens[b], olen = (float)a.mel_lens[b];
    const float inv_ilen = 1.f / ilen;
    float* out_bh = a.out + (size_t)bh * a.T * a.D;
    int* idx_b = a.idx + (size_t)b * a.T;
    int last = 0;
    for (int n = threadIdx.x; n < a.L; n += threads)
      if (validb[n]) last = n + 1;
    last = __reduce_max_sync(0xffffffffu, last);
    int* slot = kend_of + (parity ^= 1) * WIDE_MAX_WARPS;
    if (lane == 0) slot[warp] = last;
    __syncthreads();
    int kend = 0;
    for (int i = 0; i < warps; ++i) kend = max(kend, slot[i]);
    const int chunks = max(1, (kend + KC - 1) / KC);
    int resident = -1;                       // the chunk staged
    if (seg + team < seg_end) stage_q(seg + team);

    for (int round = seg; round < seg_end; round += teams) {
      const int unit = round + team;
      const bool active = unit < seg_end;
      const bool reverse = ((round - seg) / teams) & 1;
      const bool prefetch = unit + teams < seg_end;
      Rows r;
      init_rows(r, 16 * (unit % U), g, a.T, olen);
      float o[WIDE_NJ][4];
#pragma unroll
      for (int j = 0; j < WIDE_NJ; ++j)
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

      for (int i = 0; i < chunks; ++i) {
        const int ch = reverse ? chunks - 1 - i : i;
        if (ch != resident) {
          __syncthreads();                   // every warp is done with it
          stage_block(klo, kb, KC * ch, KC, a.L, a.D, 0, t.dk, t.ks, false,
                      threadIdx.x, threads);
          for (int sl = 0; sl < S; ++sl) {
            int s0, sw;
            wide_cols(a.D, S, sl, s0, sw);
            stage_block(vlo + sl * KC * WIDE_VS, vb, KC * ch, KC, a.L, a.D,
                        s0, sw, WIDE_VS, true, threadIdx.x, threads);
          }
          cp_async_commit();
          for (int k = threadIdx.x; k < KC; k += threads) {
            const int n = KC * ch + k;
            kval[k] = n < a.L ? (validb[n] ? 1.f : 0.f) : -1.f;
          }
          cp_async_wait_all();
          __syncthreads();
          split_block(khi, klo, KC, t.dk, t.ks, threadIdx.x, threads);
          split_block(vhi, vlo, S * KC, WIDE_SLICE, WIDE_VS, threadIdx.x,
                      threads);
          __syncthreads();
          resident = ch;
        }
        if (!active) continue;
        float s[NT][4], small[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = small[nt][e] = 0.f;
        wide_qk(s, small, qs + g * t.qs, qs + (g + 8) * t.qs, khi + c0,
                klo + c0, t.ks, g, tq, dv);
        // the team's partial scores, added in slice order in every warp
        float4* mine = reinterpret_cast<float4*>(part) +
                       (warp * 32 + lane) * (NT * 4 / 4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mine[nt] = make_float4(s[nt][0] + small[nt][0],
                                 s[nt][1] + small[nt][1],
                                 s[nt][2] + small[nt][2],
                                 s[nt][3] + small[nt][3]);
        team_sync(team, S);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4* p = reinterpret_cast<const float4*>(part) +
                            (team * S * 32 + lane) * NT + nt;
          float4 x = p[0];
          for (int w = 1; w < S; ++w) {
            const float4 y = p[w * 32 * NT];
            x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
          }
          s[nt][0] = x.x; s[nt][1] = x.y; s[nt][2] = x.z; s[nt][3] = x.w;
        }
        team_sync(team, S);                  // the partials are read
        if (i == chunks - 1 && prefetch) {
          __syncwarp();                      // every lane is done with q
          stage_q(unit + teams);
        }
        float alpha[2];
        chunk_max<NT>(s, r, alpha, kval, KC * ch, tq, a.inv_sqrt_d);
        if (i > 0) {
#pragma unroll
          for (int j = 0; j < WIDE_NJ; ++j) {
            o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
            o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
          }
        }
        const int ntiles = min(NT, max(0, (kend - KC * ch + 7) / 8));
        wide_exp_pv(o, s, r, kval, vhi + slice * KC * WIDE_VS,
                    vlo + slice * KC * WIDE_VS, KC * ch, g, tq, ntiles,
                    first, ilen, inv_ilen, a.inv_2s2, nf);
      }
      if (active) {
        const float gsum = wide_finish(r, o, out_bh, idx_b, a.T, a.D, tq, c0,
                                       nf, first);
        if (first && lane == 0) a.partial[(size_t)b * U + unit % U] = gsum;
      }
      cp_async_wait_all();                   // the next unit's q
      __syncwarp();
    }
    seg = seg_end;
  }
}

// The team kernel's shape at head dim D: as many whole teams as fit, at
// most 8 warps; the dynamic shared memory, or 0 if not one team fits.
size_t team_plan(int D, Team& t) {
  t.slices = ((D + 31) / 32 + WIDE_NJ / 4 - 1) / (WIDE_NJ / 4);
  t.dk = round_up(D, 32);
  t.ks = t.dk + 16;
  int widest = 0;
  for (int s = 0; s < t.slices; ++s) {
    int c0, dv;
    wide_cols(D, t.slices, s, c0, dv);
    widest = max(widest, dv);
  }
  t.qs = widest + 16;
  for (int n = WIDE_MAX_WARPS / t.slices; n >= 1; --n) {
    t.warps = n * t.slices;
    if (team_smem(t) <= MAX_SMEM) return team_smem(t);
  }
  return 0;
}

// The wide launch's shape at head dim D: 8 warps and the widest K chunk (a
// multiple of 32, at most 256 columns) that fits, since fewer chunks mean
// fewer block barriers; the dynamic shared memory.
size_t wide_plan(int D, Wide& w) {
  w.dq = round_up(D, 16);
  w.slices = ((D + 31) / 32 + WIDE_NJ / 4 - 1) / (WIDE_NJ / 4);
  for (w.dc = min(round_up(w.dq, 32), 256);; w.dc -= 32) {
    w.ks = round_up(w.dc, 32) + 16;
    if (w.dc == 32 || wide_smem(w.ks) <= MAX_SMEM) break;
  }
  w.dc = min(w.dc, w.dq);
  w.ndc = (w.dq + w.dc - 1) / w.dc;
  return wide_smem(w.ks);
}

// The team kernel where it fits with at least two teams, else the wide
// kernel.
cudaError_t launch_wide(const Args& a, int B, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Team t;
  size_t smem = team_plan(a.D, t);
  if (smem != 0 && t.warps >= 2 * t.slices) {
    const int units = B * a.H * units_of(a.T);
    err = cudaFuncSetAttribute(alignment_team_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    alignment_team_kernel<<<min(sms, units), 32 * t.warps, smem, s>>>(
        a, t, units);
    return cudaGetLastError();
  }
  Wide w;
  smem = wide_plan(a.D, w);
  const int units = B * a.H * w.slices * units_of(a.T);
  err = cudaFuncSetAttribute(alignment_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  alignment_wide_kernel<<<min(sms, units), 32 * WIDE_MAX_WARPS, smem, s>>>(
      a, w, units);
  return cudaGetLastError();
}

}  // namespace

// 16-frame units per (batch, head): the wrapper allocates partial
// (B, units).
extern "C" int alignment_attention_tiles(int T) { return units_of(T); }

// Dynamic shared memory of the kernel that a head dim D runs.
extern "C" int alignment_attention_smem_bytes(int D) {
  return static_cast<int>(D <= 32    ? Layout<32>::SMEM
                          : D <= 64  ? Layout<64>::SMEM
                          : D <= 128 ? Layout<128>::SMEM
                          : D <= 192 ? Layout<192>::SMEM
                                     : Layout<256>::SMEM);
}

// q, out (B, H, T, D), k, v (B, H, L, D): contiguous f32, 16-byte aligned,
// D a multiple of 4 up to 256, any L >= 1; key_valid (B, L) one byte per
// key; src_lens, mel_lens (B,) int32; idx (B, T) int32, partial
// (B, units_of(T)) f32 scratch, gnum (B,) f32.  Returns the cudaError_t of
// the launches.
extern "C" int alignment_attention_forward(
    const void* q, const void* k, const void* v, const void* key_valid,
    const void* src_lens, const void* mel_lens, void* out, void* idx,
    void* partial, void* gnum, int B, int H, int T, int L, int D,
    float inv_sqrt_d, float two_sigma2, void* stream) {
  if (B == 0) return 0;
  if (H < 1 || T < 1 || L < 1 || D < 4 || D > 256 || D % 4 != 0 ||
      H > 65535 || B > 65535 ||
      (long long)B * H * units_of(T) > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v),
               static_cast<const uint8_t*>(key_valid),
               static_cast<const int*>(src_lens),
               static_cast<const int*>(mel_lens), static_cast<float*>(out),
               static_cast<int*>(idx), static_cast<float*>(partial), H, T, L,
               D, inv_sqrt_d, 1.f / two_sigma2};
  cudaError_t err = D <= 32    ? launch<32>(a, B, s)
                    : D <= 64  ? launch<64>(a, B, s)
                    : D <= 128 ? launch<128>(a, B, s)
                    : D <= 192 ? launch<192>(a, B, s)
                               : launch<256>(a, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gnum_reduce_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(gnum), B,
      units_of(T));
  return static_cast<int>(cudaGetLastError());
}

// As alignment_attention_forward for a D past 256 (a multiple of 4), on
// the team or the wide kernel.
extern "C" int alignment_attention_wide_forward(
    const void* q, const void* k, const void* v, const void* key_valid,
    const void* src_lens, const void* mel_lens, void* out, void* idx,
    void* partial, void* gnum, int B, int H, int T, int L, int D,
    float inv_sqrt_d, float two_sigma2, void* stream) {
  if (B == 0) return 0;
  if (H < 1 || T < 1 || L < 1 || D < 4 || D % 4 != 0 || H > 65535 ||
      B > 65535 || (long long)B * H * units_of(T) * ((D + 191) / 192) >
                       2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v),
               static_cast<const uint8_t*>(key_valid),
               static_cast<const int*>(src_lens),
               static_cast<const int*>(mel_lens), static_cast<float*>(out),
               static_cast<int*>(idx), static_cast<float*>(partial), H, T, L,
               D, inv_sqrt_d, 1.f / two_sigma2};
  const cudaError_t err = launch_wide(a, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gnum_reduce_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(gnum), B,
      units_of(T));
  return static_cast<int>(cudaGetLastError());
}

// The shape alignment_attention_wide_forward takes at head dim D: shape[0]
// 1 for the team kernel, 0 for the wide one; shape[1] warps; shape[2]
// columns of K staged at once; shape[3] output slices; shape[4] the dynamic
// shared memory in bytes.
extern "C" void alignment_attention_wide_shape(int D, int* shape) {
  Team t{};
  const size_t team = team_plan(D, t);
  if (team != 0 && t.warps >= 2 * t.slices) {
    shape[0] = 1;
    shape[1] = t.warps;
    shape[2] = t.dk;
    shape[3] = t.slices;
    shape[4] = static_cast<int>(team);
    return;
  }
  Wide w{};
  shape[4] = static_cast<int>(wide_plan(D, w));
  shape[0] = 0;
  shape[1] = WIDE_MAX_WARPS;
  shape[2] = w.dc;
  shape[3] = w.slices;
}

extern "C" const char* alignment_attention_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
