// Banded Gaussian upsampling: the length regulator of the variance adaptor.
//
// Replaces the TPU kernel `_banded_kernel` / `_banded_forward` of
// smart_nar_fast_tts_tpu/ops/pallas/upsample.py.  For frame t of item b:
//   out[t] = sum_l w_l x_l / (sum_l w_l + 1e-20),
//   w_l = exp(-(t - c_l)^2 / sigma^2) * valid_l,
// with the centers c = cumsum(d) - d/2 computed by the caller.  A phoneme
// whose center lies more than `band` (6 sigma) outside the block's frame tile
// is skipped: its weight is below exp(-36) there.  Frames >= total (= sum d)
// are written as 0.  Everything is f32 FMA: no TF32, no reduced precision, as
// the TPU kernel's Precision.HIGHEST.
//
// Bound on the H100: memory.  At the serving shape (B 8, L 128, D 256,
// T 1000) it reads 1 MB of x and writes 8 MB of out, while an output element
// needs one FMA per phoneme inside the band (~10-20).  Design for that: one
// block per (item, 16-frame tile, 128-channel slice); each thread owns one
// channel and accumulates its 16 frames in registers, so x is read once per
// tile in coalesced rows and out is written once in coalesced rows; the
// weights of a 64-phoneme chunk are computed once per block into shared
// memory.  The TPU
// grid's sequential phoneme-block loop becomes a loop inside the block, and
// the band test is per phoneme instead of per phoneme block.
#include <cuda_runtime.h>

namespace {

constexpr int BT = 16;           // frames per block
constexpr int THREADS = 128;     // channels per block
constexpr int LC = 64;           // phonemes per shared-memory chunk

__global__ void __launch_bounds__(THREADS)
gaussian_upsample_kernel(const float* __restrict__ x,
                         const float* __restrict__ centers,
                         const float* __restrict__ valid,
                         const float* __restrict__ total,
                         float* __restrict__ out, int L, int T, int D,
                         float inv_sigma2, float band) {
  __shared__ float w_s[LC][BT];
  __shared__ int in_band[LC];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BT;
  const int d = blockIdx.z * THREADS + threadIdx.x;
  const float t_lo = static_cast<float>(t0);
  const float t_hi = static_cast<float>(t0 + BT - 1);

  float num[BT];
  float den[BT];
#pragma unroll
  for (int i = 0; i < BT; ++i) {
    num[i] = 0.f;
    den[i] = 0.f;
  }

  for (int l0 = 0; l0 < L; l0 += LC) {
    __syncthreads();                   // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < LC * BT; idx += THREADS) {
      const int j = idx / BT;
      const int i = idx - j * BT;
      const int l = l0 + j;
      float w = 0.f;
      if (l < L) {
        const float c = centers[(size_t)b * L + l];
        const float vl = valid[(size_t)b * L + l];
        if (vl != 0.f && c + band >= t_lo && c - band <= t_hi) {
          const float diff = static_cast<float>(t0 + i) - c;
          w = expf(-inv_sigma2 * (diff * diff)) * vl;
        }
      }
      w_s[j][i] = w;
    }
    if (threadIdx.x < LC) {
      const int l = l0 + threadIdx.x;
      int keep = 0;
      if (l < L) {
        const float c = centers[(size_t)b * L + l];
        keep = valid[(size_t)b * L + l] != 0.f && c + band >= t_lo &&
               c - band <= t_hi;
      }
      in_band[threadIdx.x] = keep;
    }
    __syncthreads();

    const int n = min(LC, L - l0);
    for (int j = 0; j < n; ++j) {
      if (!in_band[j]) continue;       // the same branch for the whole block
      const float xv = d < D ? x[((size_t)b * L + l0 + j) * D + d] : 0.f;
#pragma unroll
      for (int i = 0; i < BT; ++i) {
        const float w = w_s[j][i];
        num[i] = fmaf(w, xv, num[i]);
        den[i] += w;
      }
    }
  }

  if (d < D) {
    const float tot = total[b];
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const int t = t0 + i;
      if (t < T) {
        out[((size_t)b * T + t) * D + d] =
            static_cast<float>(t) < tot ? num[i] / (den[i] + 1e-20f) : 0.f;
      }
    }
  }
}

}  // namespace

// x (B, L, D), centers and valid (B, L), total (B,), out (B, T, D): all
// contiguous f32.  Returns the cudaError_t of the launch.
extern "C" int gaussian_upsample_forward(const void* x, const void* centers,
                                         const void* valid, const void* total,
                                         void* out, int B, int L, int T,
                                         int D, float inv_sigma2, float band,
                                         void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  const dim3 grid((T + BT - 1) / BT, B, (D + THREADS - 1) / THREADS);
  gaussian_upsample_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(centers),
      static_cast<const float*>(valid), static_cast<const float*>(total),
      static_cast<float*>(out), L, T, D, inv_sigma2, band);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gaussian_upsample_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
