// Attention at any head dim: the general paths of the flash and alignment
// kernels, for the head dims their tensor-core kernels do not take (D > 128;
// below 128 the wrappers zero-pad D instead, which is exact).
//
// Replaces, at those widths, the TPU kernels `_flash_kernel` /
// `_flash_forward` of smart_nar_fast_tts_tpu/ops/pallas/attention.py and
// `_kernel` / `_forward` of smart_nar_fast_tts_tpu/ops/pallas/alignment.py,
// whose blocks take any D.  One kernel body serves both:
//   flash      q·scale rounded to bf16 (the product in f32), k and v rounded
//              to bf16, f32 scores, an online softmax in f32, p rounded to
//              bf16 for the PV product, f32 sums; out = PV / max(l, 1e-37);
//              the rounding points of csrc/flash_attention.cu.
//   alignment  all f32 (the TPU kernel's Precision.HIGHEST): scores =
//              (q·k)·scale, an online softmax, out = PV / max(l, 1e-37); for
//              head 0 also the first-index argmax of the masked scores and
//              each frame's guided numerator sum_n W·p over t < mel_len,
//              n < src_len, W = 1 - exp(-(n/src_len - t/mel_len)^2 /
//              (2 sigma^2)); a second launch sums the frames' numerators of
//              each item in a fixed order.
// An invalid key takes no part (probability 0); a key tile with no valid
// key is skipped by the whole block, which changes no bit of the online
// softmax; a row with no valid key writes 0 and, for the argmax, index 0.
//
// Bound on the H100: operations, 4·B·H·Lq·Lk·D multiply-adds counted twice
// (at (8, 2, 4096, 192) 206 GFLOP, 0.21 ms at the bf16 tensor-core rate).
// This kernel is the simple first version: CUDA-core f32 FMAs on operands
// already rounded (a product of two bf16 values is exact in f32, so only
// the order of the sums differs from a tensor-core product).  Design:
// - One block of 256 threads per (batch·head, 64 query rows, 64 output
//   columns).  Keys go through shared memory in tiles of 64; for each tile
//   the block sums its 64 × 64 scores over D in chunks of 64 columns (q and
//   k chunks staged in shared memory, each thread a 4 × 4 register tile of
//   scores), so D has no upper limit and registers stay fixed.
// - The online softmax runs on those registers, reduced across the 16
//   threads of a row group by shuffles; p goes to shared memory (in the
//   k chunk's place), v's 64 × 64 slice of the tile to the q chunk's, and
//   each thread adds a 4 × 4 tile of the output.
// - Each output slice recomputes the scores: D/64 times the QK^T work, the
//   price of a fixed register tile at any D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                   // query rows per block
constexpr int BK = 64;                   // keys per tile
constexpr int DC = 64;                   // columns per chunk and per block
constexpr int PAD = DC + 1;              // shared row stride: no bank clash
constexpr int THREADS = 256;             // 16 row groups × 16 column groups
constexpr float NEG_INF = -1e30f;
static_assert(BQ == 64 && BK == 64 && DC == 64, "4 × 4 tiles of 16 × 16");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// reductions over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ int group_min(int x) {
  for (int off = 8; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// the alignment path's extras; idx == nullptr for flash
struct Extras {
  const int* src_lens;
  const int* mel_lens;
  int* idx;                              // (B, Lq) int32, head 0
  float* row_gnum;                       // (B, Lq) f32 scratch, head 0
  float two_sigma2;
};

template <typename T, bool FLASH>
__global__ void __launch_bounds__(THREADS)
attention_general_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ key_valid,
                         T* __restrict__ out, int H, int Lq, int Lk, int D,
                         float scale, Extras ex) {
  __shared__ float a_s[BQ * PAD];        // q chunk, then v slice
  __shared__ float b_s[BK * PAD];        // k chunk, then p
  __shared__ uint8_t valid_s[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * DC;        // the block's output columns
  const int tid = threadIdx.x;
  const int tx = tid & 15;               // keys / columns tx + 16 j
  const int ty = tid >> 4;               // rows 4 ty + i
  const T* qb = q + (size_t)bh * Lq * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  const uint8_t* kv = key_valid + (size_t)b * Lk;
  const bool extras = !FLASH && ex.idx != nullptr && bh % H == 0 &&
                      blockIdx.z == 0;
  const int ilen = extras ? ex.src_lens[b] : 0;
  const int olen = extras ? ex.mel_lens[b] : 0;

  float m[4], l[4], g[4], acc[4][4];
  int best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    g[i] = 0.f;
    best[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < Lk; kt += BK) {
    const bool mine = tid < BK && kt + tid < Lk && kv[kt + tid] != 0;
    if (tid < BK) valid_s[tid] = mine;
    if (!__syncthreads_or(mine)) continue;   // no valid key: skip the tile

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      for (int e = tid; e < BQ * DC; e += THREADS) {
        const int r = e / DC, c = e % DC;
        float x = 0.f, y = 0.f;
        if (d0 + c < D) {
          if (q0 + r < Lq) {
            x = to_f32(qb[(size_t)(q0 + r) * D + d0 + c]);
            if (FLASH) x = bf16_round(x * scale);
          }
          if (kt + r < Lk) {
            y = to_f32(kb[(size_t)(kt + r) * D + d0 + c]);
            if (FLASH) y = bf16_round(y);
          }
        }
        a_s[r * PAD + c] = x;
        b_s[r * PAD + c] = y;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[(4 * ty + i) * PAD + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = b_s[(tx + 16 * j) * PAD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
      }
      __syncthreads();                   // the chunks are consumed
    }

    // online softmax of the tile; p into b_s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc = FLASH ? s[i][j] : s[i][j] * scale;
        s[i][j] = valid_s[tx + 16 * j] ? sc : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max(mx);
      if (extras) {                      // the tile's first key at its max
        int cand = 0x7fffffff;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (valid_s[tx + 16 * j] && s[i][j] == mx)
            cand = min(cand, kt + tx + 16 * j);
        cand = group_min(cand);
        if (mx > m[i]) best[i] = cand;   // an equal earlier max stays
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const int t = q0 + 4 * ty + i;
      float ps = 0.f, gs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = kt + tx + 16 * j;
        const float p = valid_s[tx + 16 * j] ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        if (extras && t < olen && n < ilen) {
          const float r = static_cast<float>(n) / static_cast<float>(ilen) -
                          static_cast<float>(t) / static_cast<float>(olen);
          gs += (1.f - expf(-(r * r) / ex.two_sigma2)) * p;
        }
        b_s[(4 * ty + i) * PAD + tx + 16 * j] = FLASH ? bf16_round(p) : p;
      }
      ps = group_sum(ps);
      if (extras) gs = group_sum(gs);
      l[i] = l[i] * alpha + ps;
      g[i] = g[i] * alpha + gs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }

    // v's slice of the tile into a_s, then out += p v
    for (int e = tid; e < BK * DC; e += THREADS) {
      const int r = e / DC, c = e % DC;
      float y = 0.f;
      if (kt + r < Lk && c0 + c < D) {
        y = to_f32(vb[(size_t)(kt + r) * D + c0 + c]);
        if (FLASH) y = bf16_round(y);
      }
      a_s[r * PAD + c] = y;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = b_s[(4 * ty + i) * PAD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = a_s[kk * PAD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();                     // p and v are consumed
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= Lq) continue;
    const float den = fmaxf(l[i], 1e-37f);
    T* row = out + ((size_t)bh * Lq + t) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < D) row[c] = from_f32<T>(acc[i][j] / den);
    }
    if (extras && tx == 0) {
      ex.idx[(size_t)b * Lq + t] = best[i];
      ex.row_gnum[(size_t)b * Lq + t] = g[i] / den;
    }
  }
}

// gnum[b] = the sum of row_gnum[b, :T], lane-strided then a fixed tree
__global__ void gnum_sum_kernel(const float* __restrict__ row_gnum,
                                float* __restrict__ gnum, int T) {
  const float* row = row_gnum + (size_t)blockIdx.x * T;
  float acc = 0.f;
  for (int t = threadIdx.x; t < T; t += 32) acc += row[t];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x == 0) gnum[blockIdx.x] = acc;
}

template <typename T, bool FLASH>
int launch(const void* q, const void* k, const void* v, const void* key_valid,
           void* out, int B, int H, int Lq, int Lk, int D, float scale,
           Extras ex, cudaStream_t stream) {
  if (B == 0 || H == 0 || Lq == 0) return 0;
  if (D < 1 || (long long)B * H > 65535 || (D + DC - 1) / DC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Lq + BQ - 1) / BQ, B * H, (D + DC - 1) / DC);
  attention_general_kernel<T, FLASH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<T*>(out), H, Lq, Lk, D, scale, ex);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Lq, D), k and v (B, H, Lk, D), out (B, H, Lq, D): contiguous, all
// f32 (dtype 0) or all bf16 (dtype 1); key_valid (B, Lk) one byte per key;
// any D >= 1.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_general_forward(
    const void* q, const void* k, const void* v, const void* key_valid,
    void* out, int B, int H, int Lq, int Lk, int D, int dtype, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras none{nullptr, nullptr, nullptr, nullptr, 0.f};
  if (dtype == 0)
    return launch<float, true>(q, k, v, key_valid, out, B, H, Lq, Lk, D,
                               scale, none, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k, v, key_valid, out, B, H, Lq,
                                       Lk, D, scale, none, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, out (B, H, T, D), k, v (B, H, L, D): contiguous f32; key_valid (B, L)
// one byte per key; src_lens, mel_lens (B,) int32; idx (B, T) int32,
// row_gnum (B, T) f32 scratch, gnum (B,) f32; any D >= 1.  Returns the
// cudaError_t of the launches.
extern "C" int alignment_attention_general_forward(
    const void* q, const void* k, const void* v, const void* key_valid,
    const void* src_lens, const void* mel_lens, void* out, void* idx,
    void* row_gnum, void* gnum, int B, int H, int T, int L, int D,
    float inv_sqrt_d, float two_sigma2, void* stream) {
  if (B == 0) return 0;
  if (H < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras ex{static_cast<const int*>(src_lens),
                  static_cast<const int*>(mel_lens), static_cast<int*>(idx),
                  static_cast<float*>(row_gnum), two_sigma2};
  const int status = launch<float, false>(q, k, v, key_valid, out, B, H, T,
                                          L, D, inv_sqrt_d, ex, s);
  if (status != 0) return status;
  gnum_sum_kernel<<<B, 32, 0, s>>>(static_cast<const float*>(row_gnum),
                                   static_cast<float*>(gnum), T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* attention_general_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
