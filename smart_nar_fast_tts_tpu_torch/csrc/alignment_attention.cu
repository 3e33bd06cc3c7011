// Alignment cross-attention of the MelEncoder, with its two loss reductions.
//
// Replaces the TPU kernel `_kernel` / `_forward` of
// smart_nar_fast_tts_tpu/ops/pallas/alignment.py.  For mel-frame queries q
// (B, H, T, D) over text keys and values k, v (B, H, L, D) it computes
//   out  = softmax(mask(QK^T / sqrt(D))) V                      (B, H, T, D)
//   idx  = argmax over the text axis of head 0's masked scores  (B, T) int32
//   gnum = sum over t < mel_len, n < src_len of W[t, n] p[t, n], head 0,
//          W = 1 - exp(-(n / src_len - t / mel_len)^2 / (2 sigma^2))   (B,)
// and the (B, H, T, L) probabilities never reach device memory.  Everything
// is f32: the scores by f32 FMA (no TF32, no bf16), because near-ties in the
// argmax decide the duration targets.  An invalid key scores -1e30 and gets
// probability 0; the argmax takes the first index among equal maxima.
//
// Bound on the H100: QK^T and PV are 4 B H T L D operations over f32
// operands with no tensor-core path that keeps f32 faithful, so the card's
// bound is the f32 rate (67 TFLOP/s); the bytes (q, out, k and v once) take
// about a third of that time at the flagship training shape.
// Design for that: the TPU grid's frame-block axis becomes blocks of 32
// frames of one (batch, head) each; L (the text length, 128 in the
// flagship) is short, so a block keeps the whole 32 x L score tile in
// shared memory and the softmax is one pass over L, as on the TPU.  K and
// then V stream through shared memory in tiles of 64 keys (rows padded by 4
// floats, read as float4 with no bank conflicts); each thread keeps a 2 x 4
// score tile, then a 4-frame x 4-column output tile, in registers.  The TPU
// kernel sums gnum across its sequential grid in one output block; blocks on
// the card run in no order, so each frame tile writes its partial sum and a
// second, one-thread-per-item launch adds them in tile order: gnum is
// bit-identical from run to run (no float atomics).  The ragged edges of T
// and L are masked in the kernel: no padding copies.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;                 // frames per block
constexpr int KC = 64;                 // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 4;                 // floats of padding per K/V/q row
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int tiles_of(int T) { return (T + TT - 1) / TT; }

size_t smem_bytes(int L, int D) {
  const size_t dp = D + PAD, lp = L + 1;
  return sizeof(float) * (TT * dp + KC * dp + TT * lp + L + WARPS);
}

// Stage rows [r0, r0 + nrows) of a (rows_total, D) matrix into shared memory
// with row stride D + PAD; rows past rows_total are zero.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int nrows, int rows_total,
                                           int D) {
  const int d4n = D / 4, dp4 = (D + PAD) / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < nrows * d4n; i += THREADS) {
    const int r = i / d4n, c = i % d4n;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows_total) val = src4[(size_t)(r0 + r) * d4n + c];
    dst4[r * dp4 + c] = val;
  }
}

__global__ void __launch_bounds__(THREADS)
alignment_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ key_valid,
                 const int* __restrict__ src_lens,
                 const int* __restrict__ mel_lens, float* __restrict__ out,
                 int* __restrict__ idx, float* __restrict__ partial, int H,
                 int T, int L, int D, float sqrt_d, float two_sigma2) {
  extern __shared__ __align__(16) float smem[];
  const int dp = D + PAD, lp = L + 1, dp4 = dp / 4;
  float* qs = smem;                    // TT x dp
  float* kv = qs + TT * dp;            // KC x dp, K then V
  float* S = kv + KC * dp;             // TT x lp scores, then probabilities
  float* kvalid = S + TT * lp;         // L
  float* red = kvalid + L;             // WARPS

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = tile * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + bh * T * D;
  const float* kb = k + bh * L * D;
  const float* vb = v + bh * L * D;

  for (int n = tid; n < L; n += THREADS)
    kvalid[n] = key_valid[(size_t)b * L + n] ? 1.f : 0.f;
  stage_rows(qs, qb, t0, TT, T, D);

  // ---- scores: thread (ty, tx) owns frames 2 ty + i and keys tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* kv4 = reinterpret_cast<const float4*>(kv);
  for (int c0 = 0; c0 < L; c0 += KC) {
    __syncthreads();                   // kv free, qs and kvalid staged
    stage_rows(kv, kb, c0, KC, L, D);
    __syncthreads();
    float acc[2][4] = {};
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 qa[2], kk[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qa[i] = qs4[(2 * ty + i) * dp4 + d4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = kv4[(tx + 16 * j) * dp4 + d4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a = fmaf(qa[i].x, kk[j].x, a);
          a = fmaf(qa[i].y, kk[j].y, a);
          a = fmaf(qa[i].z, kk[j].z, a);
          a = fmaf(qa[i].w, kk[j].w, a);
          acc[i][j] = a;
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = c0 + tx + 16 * j;
      if (n >= L) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        S[(2 * ty + i) * lp + n] =
            kvalid[n] > 0.f ? acc[i][j] / sqrt_d : NEG_INF;
    }
  }
  __syncthreads();

  // ---- softmax, argmax and the guided numerator: one warp per row
  const bool head0 = h == 0;
  const float ilen = (float)src_lens[b], olen = (float)mel_lens[b];
  float gsum = 0.f;
  for (int f = warp; f < TT; f += WARPS) {
    const int t = t0 + f;
    if (t >= T) break;
    float* row = S + f * lp;
    float best = -INFINITY;
    int best_i = L;
    for (int n = lane; n < L; n += 32) {
      const float s = row[n];
      if (s > best) { best = s; best_i = n; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (ob > best || (ob == best && oi < best_i)) { best = ob; best_i = oi; }
    }
    float sum = 0.f;
    for (int n = lane; n < L; n += 32) {
      const float p = expf(row[n] - best) * kvalid[n];
      row[n] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float denom = fmaxf(sum, 1e-37f);
    const float tpos = (float)t / olen;
    const bool frame_ok = (float)t < olen;
    for (int n = lane; n < L; n += 32) {
      const float p = row[n] / denom;
      row[n] = p;
      if (head0 && frame_ok && (float)n < ilen) {
        const float dn = (float)n / ilen - tpos;
        gsum += (1.f - expf(-(dn * dn) / two_sigma2)) * p;
      }
    }
    if (head0 && lane == 0) idx[(size_t)b * T + t] = best_i;
  }
  if (head0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    if (lane == 0) red[warp] = gsum;
  }
  __syncthreads();
  if (head0 && tid == 0) {
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) total += red[w];
    partial[(size_t)b * gridDim.x + tile] = total;
  }

  // ---- out = P V: thread (tf, td) owns frames 4 tf + i, columns 4 td + c
  const int tf = tid / 32, td = tid % 32;
  const bool col_ok = 4 * td < D;
  float4 o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < L; c0 += KC) {
    __syncthreads();                   // kv free, probabilities written
    stage_rows(kv, vb, c0, KC, L, D);
    __syncthreads();
    if (!col_ok) continue;
    const int nmax = min(KC, L - c0);
    for (int n = 0; n < nmax; ++n) {
      const float4 vv = kv4[n * dp4 + td];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = S[(4 * tf + i) * lp + c0 + n];
        o[i].x = fmaf(p, vv.x, o[i].x);
        o[i].y = fmaf(p, vv.y, o[i].y);
        o[i].z = fmaf(p, vv.z, o[i].z);
        o[i].w = fmaf(p, vv.w, o[i].w);
      }
    }
  }
  if (col_ok) {
    float4* ob = reinterpret_cast<float4*>(out + bh * T * D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * tf + i;
      if (t < T) ob[(size_t)t * (D / 4) + td] = o[i];
    }
  }
}

// gnum[b] = the frame tiles' partial sums of item b, added in tile order.
__global__ void gnum_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ gnum, int B,
                                   int tiles) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float total = 0.f;
  for (int i = 0; i < tiles; ++i) total += partial[(size_t)b * tiles + i];
  gnum[b] = total;
}

}  // namespace

// Frame tiles per (batch, head): the wrapper allocates partial (B, tiles).
extern "C" int alignment_attention_tiles(int T) { return tiles_of(T); }

// q, out (B, H, T, D), k, v (B, H, L, D): contiguous f32, D a multiple of 4
// up to 128; key_valid (B, L) one byte per key; src_lens, mel_lens (B,)
// int32; idx (B, T) int32, partial (B, tiles_of(T)) f32 scratch, gnum (B,)
// f32.  Returns the cudaError_t of the launches.
extern "C" int alignment_attention_forward(
    const void* q, const void* k, const void* v, const void* key_valid,
    const void* src_lens, const void* mel_lens, void* out, void* idx,
    void* partial, void* gnum, int B, int H, int T, int L, int D,
    float sqrt_d, float two_sigma2, void* stream) {
  if (B == 0) return 0;
  if (H < 1 || T < 1 || L < 1 || D < 4 || D > 128 || D % 4 != 0 ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L, D);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      alignment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(T);
  alignment_kernel<<<dim3(tiles, H, B), THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<const int*>(src_lens), static_cast<const int*>(mel_lens),
      static_cast<float*>(out), static_cast<int*>(idx),
      static_cast<float*>(partial), H, T, L, D, sqrt_d, two_sigma2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gnum_reduce_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(gnum), B,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alignment_attention_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
