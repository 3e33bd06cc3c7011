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
// - A persistent block (8 warps, one per SM: 215 KB of shared memory) walks
//   a contiguous range of 16-frame units, in rounds of one unit per warp
//   within each (batch, head).  Keys go through shared memory in chunks of
//   64, split into hi and lo once for the block (splitting in every warp
//   cost 8x the ALU work), with an online softmax across chunks; rounds take
//   the chunks in alternating order, so that each round starts on the chunk
//   the last one ended with (L <= 64 stages K and V once per (b, h)).  Each
//   warp loads its next unit's q by cp.async while it finishes the current
//   one, and its output stores drain during the next round.
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
// padding copies.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // 16 frames each
constexpr int THREADS = 32 * WARPS;
constexpr int KC = 64;                 // keys per shared-memory chunk
constexpr int NT = KC / 8;             // 8-key tiles per chunk
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;

// 16-frame units per (batch, head): the unit of work of a warp, and of the
// guided numerator's partial sums
__host__ __device__ inline int units_of(int T) { return (T + 15) / 16; }

// Row strides in floats for a depth padded to DP (32, 64 or 128): q and K
// rows ≡ 16 (mod 32) banks apart, V rows 4 apart, so that the 16-byte
// fragment reads below hit no bank twice.  Shared memory: 16 q rows per
// warp, a chunk of K and of V split into tf32 hi and lo (keys of V
// permuted), the chunk's key mask, two words per warp.
template <int DP> struct Layout {
  static constexpr int QS = DP + 16;
  static constexpr int KS = DP + 16;
  static constexpr int VS = DP + 4;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)16 * WARPS * QS + 2 * (size_t)KC * KS +
                       2 * (size_t)KC * VS + KC + 2 * WARPS);
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

// c[i] += a b[i] for 4 independent accumulators in 3xTF32: the three passes
// (lo·hi, hi·lo, hi·hi: the small terms first) go across the accumulators,
// so that no tensor-core instruction waits on the one before it
__device__ __forceinline__ void mma_3xtf32(float (*c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[4][2],
                                           const uint32_t (&blo)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[i], ahi, blo[i][0], blo[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[i], ahi, bhi[i][0], bhi[i][1]);
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
  stage_rows<DP>(klo, kb, c0, KC, L, D, Layout<DP>::KS, false, threadIdx.x,
                 THREADS);
  stage_rows<DP>(vlo, vb, c0, KC, L, D, Layout<DP>::VS, true, threadIdx.x,
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
  constexpr int C4 = DP / 4;
  for (int i = threadIdx.x; i < KC * C4; i += THREADS) {
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

// S = Q K^T over the chunk's first `ntiles` key tiles (in steps of 4),
// 3xTF32.  k-step 2c takes depths d0, d0 + 1 as
// k slots t, t + 4, k-step 2c + 1 depths d0 + 2, d0 + 3 (d0 = 16 c + 4 t):
// one float4 of q, of K hi and of K lo per lane and key tile.
template <int DP>
__device__ __forceinline__ void qk_product(float (&s)[NT][4],
                                           const float* q0, const float* q1,
                                           const float* khi, const float* klo,
                                           int g, int tq, int ntiles) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
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
    for (int n0 = 0; n0 < NT; n0 += 4) {
      if (n0 >= ntiles) break;
      uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (8 * (n0 + i) + g) * Layout<DP>::KS + d0;
        const float4 h4 = *reinterpret_cast<const float4*>(khi + off);
        const float4 l4 = *reinterpret_cast<const float4*>(klo + off);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bh[j >> 1][i][j & 1] = word(h4, j);
          bl[j >> 1][i][j & 1] = word(l4, j);
        }
      }
      mma_3xtf32(s + n0, ah[0], al[0], bh[0], bl[0]);
      mma_3xtf32(s + n0, ah[1], al[1], bh[1], bl[1]);
    }
  }
}

// Scale and mask the chunk's scores and fold them into the running max and
// argmax (first index among equal maxima, whatever the order of chunks);
// returns the factor exp(m_old - m) for the sums and the output.
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
    float (&o)[DP / 8][4], const float (&s)[NT][4], Rows& r,
    const float* kval, const float* vhi, const float* vlo, int c0, int g,
    int tq, int ntiles, bool guided, float ilen, float inv_ilen,
    float inv_2s2) {
  constexpr int NJ = DP / 8, VS = Layout<DP>::VS;
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
      mma_3xtf32(o + 4 * f, ph, pl, bh, bl);
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
__global__ void __launch_bounds__(THREADS, 1)
alignment_kernel(const Args a, int total_units) {
  using Lay = Layout<DP>;
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
  static_assert(smem <= MAX_SMEM, "shared memory");
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
  alignment_kernel<DP><<<min(sms, units), THREADS, smem, s>>>(a, units);
  return cudaGetLastError();
}

}  // namespace

// 16-frame units per (batch, head): the wrapper allocates partial
// (B, units).
extern "C" int alignment_attention_tiles(int T) { return units_of(T); }

// Dynamic shared memory of the kernels that a head dim D runs.
extern "C" int alignment_attention_smem_bytes(int D) {
  return static_cast<int>(D <= 32   ? Layout<32>::SMEM
                          : D <= 64 ? Layout<64>::SMEM
                                    : Layout<128>::SMEM);
}

// q, out (B, H, T, D), k, v (B, H, L, D): contiguous f32, 16-byte aligned,
// D a multiple of 4 up to 128, any L >= 1; key_valid (B, L) one byte per
// key; src_lens, mel_lens (B,) int32; idx (B, T) int32, partial
// (B, units_of(T)) f32 scratch, gnum (B,) f32.  Returns the cudaError_t of
// the launches.
extern "C" int alignment_attention_forward(
    const void* q, const void* k, const void* v, const void* key_valid,
    const void* src_lens, const void* mel_lens, void* out, void* idx,
    void* partial, void* gnum, int B, int H, int T, int L, int D,
    float inv_sqrt_d, float two_sigma2, void* stream) {
  if (B == 0) return 0;
  if (H < 1 || T < 1 || L < 1 || D < 4 || D > 128 || D % 4 != 0 ||
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
  cudaError_t err = D <= 32   ? launch<32>(a, B, s)
                    : D <= 64 ? launch<64>(a, B, s)
                              : launch<128>(a, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gnum_reduce_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(gnum), B,
      units_of(T));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alignment_attention_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
