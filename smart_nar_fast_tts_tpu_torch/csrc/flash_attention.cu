// Flash attention forward for the FFT blocks' self-attention.
//
// Replaces the TPU kernel `_flash_kernel` / `_flash_forward` of
// smart_nar_fast_tts_tpu/ops/pallas/attention.py: masked softmax(QK^T/sqrt(D))V
// with an online softmax over key tiles, so the (Lq, Lk) scores never reach
// device memory.  Numerics follow the TPU kernel: q*scale, k, v and the
// probability tile are rounded to bf16 and products are summed in f32; the
// softmax statistics m and l stay f32.  An invalid key gets score -1e30 and
// probability 0; a row with no valid key writes 0 (l is clamped at 1e-37).
//
// Bound on the H100: at the decoder's serving shape (D = 128, Lq = Lk = 1000)
// the two products are ~250 FLOP per byte of f32 q, k, v and out, just under
// the card's bf16 ridge (~295), so at tensor-core rates it would be bound by
// memory; this first version does the products with f32 FMA on CUDA cores
// (67 TFLOP/s peak), which makes it bound by FMA issue.
// Design for that: the TPU grid's sequential key-block axis becomes a loop
// inside the block; one block owns 64 query rows of one (batch, head); four
// threads share a row, each keeping a quarter of the row's q, output and
// every score of the current 32-key tile in registers, and the K and V tiles
// are staged once per block in shared memory (as f32 holding the bf16-rounded
// values), read as float4 with no bank conflicts.  The ragged edges of Lq and
// Lk are masked in the kernel: no padding copies.  Later work: bf16 mma /
// wgmma for the two products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS = BQ * TPR;      // 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Thread (r, g), r = tid / 4 the row within the tile and g = tid % 4, owns
// the columns d = 16 i + 4 g + c (i < D / 16, c < 4): the four threads of a
// row read one 64-byte run of a K or V row per step.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ key_valid,
                       T* __restrict__ out, int H, int Lq, int Lk,
                       float scale) {
  constexpr int NC = D / TPR;          // columns per thread
  constexpr int NV = NC / 4;           // float4 groups per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float valid_s[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int g = tid % TPR;
  const int row = blockIdx.x * BQ + r;
  const bool row_ok = row < Lq;
  const size_t q_off = ((size_t)bh * Lq + (row_ok ? row : 0)) * D;
  const size_t kv_base = (size_t)bh * Lk * D;

  float qr[NC];
  float o[NC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * i + 4 * g + c;
      qr[4 * i + c] = row_ok ? bf16_round(load_f(q + q_off + d) * scale) : 0.f;
      o[4 * i + c] = 0.f;
    }
  }
  float m = NEG_INF;
  float l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();                   // the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Lk) {
        const size_t off = kv_base + (size_t)key * D + d;
        kv = bf16_round(load_f(k + off));
        vv = bf16_round(load_f(v + off));
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      valid_s[tid] =
          (key < Lk && key_valid[(size_t)b * Lk + key] != 0) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = kr[4 * i + g];
        part = fmaf(qr[4 * i + 0], kk.x, part);
        part = fmaf(qr[4 * i + 1], kk.y, part);
        part = fmaf(qr[4 * i + 2], kk.z, part);
        part = fmaf(qr[4 * i + 3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = valid_s[j] > 0.f ? part : NEG_INF;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new) * valid_s[j];
      psum += p;
      s[j] = bf16_round(p);            // the PV product takes bf16 p
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = vr[4 * i + g];
        o[4 * i + 0] = fmaf(p, vv.x, o[4 * i + 0]);
        o[4 * i + 1] = fmaf(p, vv.y, o[4 * i + 1]);
        o[4 * i + 2] = fmaf(p, vv.z, o[4 * i + 2]);
        o[4 * i + 3] = fmaf(p, vv.w, o[4 * i + 3]);
      }
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 16 * i + 4 * g + c;
        store_f(out + q_off + d, o[4 * i + c] / denom);
      }
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_valid, void* out, int B, int H, int Lq,
                   int Lk, float scale, cudaStream_t stream) {
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<D, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<T*>(out), H, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Lq, D), k and v (B, H, Lk, D), out (B, H, Lq, D): contiguous, all
// f32 (dtype 0) or all bf16 (dtype 1); key_valid (B, Lk) one byte per key.
// D is 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, const void* key_valid,
                                       void* out, int B, int H, int Lq,
                                       int Lk, int D, int dtype, float scale,
                                       void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && dtype == 0)
    return launch<128, float>(q, k, v, key_valid, out, B, H, Lq, Lk, scale, s);
  if (D == 128 && dtype == 1)
    return launch<128, __nv_bfloat16>(q, k, v, key_valid, out, B, H, Lq, Lk,
                                      scale, s);
  if (D == 64 && dtype == 0)
    return launch<64, float>(q, k, v, key_valid, out, B, H, Lq, Lk, scale, s);
  if (D == 64 && dtype == 1)
    return launch<64, __nv_bfloat16>(q, k, v, key_valid, out, B, H, Lq, Lk,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
