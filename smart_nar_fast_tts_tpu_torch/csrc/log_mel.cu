// Fused STFT → log-mel: waveform (B, S) → log-mel (B, n_mels, F) and frame
// energy (B, F), all f32.
//
// Replaces the TPU kernel `_logmel_kernel` / `fused_log_mel` of
// smart_nar_fast_tts_tpu/ops/pallas/stft.py.  Frame f of item b is the
// reflect-padded signal y[f*hop - n_fft/2 + j], j < n_fft (the padding is
// index arithmetic here, not a padded copy).  With the Hann window folded
// into the DFT bases (cos_b = w·cos, sin_b = -w·sin, (n_fft, n_bins), built
// in float64 by the caller and cast to f32):
//   re_k = sum_j x_j cos_b[j, k],  im_k = sum_j x_j sin_b[j, k],
//   power_k = re_k² + im_k²,  mel_m = sum_k sqrt(power_k) mel_t[k, m],
//   out_m = log(max(mel_m, clip)),  energy = sqrt(sum_k power_k).
// Neither the complex spectrum nor the magnitude leaves shared memory.  All
// products are f32 FMA (no TF32): log-compression turns a relative error of
// the mel value into an absolute error of the output.
//
// Bound on the H100: f32 operations.  At the GAN step's shape (B 16, 8192
// samples, n_fft 1024, 33 frames) the two DFT products are 4·B·F·n_fft·n_bins
// ≈ 1.1 GFLOP, against 0.7 MB of waveform and outputs.  Design for that: one
// block per tile of FT frames (the (item, frame) pairs flattened, so no tile
// is ragged but the last); the tile's frames sit in shared memory, each
// thread owns one frequency bin and keeps its FT real and imaginary sums in
// registers, so each basis element read from L2 serves FT frames in 2·FT
// FMAs, and each frame sample is a broadcast float4 from shared memory.
// Each sum is taken in chunks of CHUNK samples added into the total, which
// keeps the rounding of quiet bins near that of an FFT.  The magnitudes of
// the tile then feed the mel product from shared memory; the energy is a
// per-frame sum of the bins' power in a fixed order (deterministic).  The
// TPU kernel's three MXU products become this FMA loop; its grid over
// (item, frame block) becomes the flat tile index.
#include <cuda_runtime.h>

namespace {

constexpr int FT = 8;              // frames per block
constexpr int CHUNK = 64;          // samples per partial sum
constexpr int MAX_THREADS = 576;   // one bin a thread up to n_fft 1120
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use

__global__ void __launch_bounds__(MAX_THREADS)
log_mel_kernel(const float* __restrict__ y, const float* __restrict__ cos_b,
               const float* __restrict__ sin_b,
               const float* __restrict__ mel_t, float* __restrict__ mel_out,
               float* __restrict__ energy_out, int S, int F, int total,
               int n_fft, int hop, int n_mels, float clip) {
  extern __shared__ float4 smem4[];
  const int n_bins = n_fft / 2 + 1;
  const int nwarps = blockDim.x / 32;
  float* frames = reinterpret_cast<float*>(smem4);   // FT × n_fft
  float* mag = frames + FT * n_fft;                  // FT × n_bins
  float* part = mag + FT * n_bins;                   // nwarps × FT
  const int g0 = blockIdx.x * FT;                    // first (b·F + f)
  const int pad = n_fft / 2;

  // the tile's frames, reflect padding by index; rows past the end are 0
  for (int idx = threadIdx.x; idx < FT * n_fft; idx += blockDim.x) {
    const int i = idx / n_fft;
    const int j = idx - i * n_fft;
    const int g = g0 + i;
    float v = 0.f;
    if (g < total) {
      const int b = g / F;
      int p = (g - b * F) * hop + j - pad;
      if (p < 0) p = -p;
      if (p >= S) p = 2 * (S - 1) - p;
      v = y[(size_t)b * S + p];
    }
    frames[idx] = v;
  }
  __syncthreads();

  float psum[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) psum[f] = 0.f;

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
    for (int j0 = 0; j0 < n_fft; j0 += CHUNK) {
      float pr[FT], pi[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) pr[f] = pi[f] = 0.f;
      const int j1 = min(j0 + CHUNK, n_fft);
      for (int j = j0; j < j1; j += 4) {
        const float* cb = cos_b + (size_t)j * n_bins + k;
        const float* sb = sin_b + (size_t)j * n_bins + k;
        const float c0 = cb[0], c1 = cb[n_bins], c2 = cb[2 * n_bins],
                    c3 = cb[3 * n_bins];
        const float s0 = sb[0], s1 = sb[n_bins], s2 = sb[2 * n_bins],
                    s3 = sb[3 * n_bins];
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const float4 x =
              *reinterpret_cast<const float4*>(frames + f * n_fft + j);
          pr[f] = fmaf(x.x, c0, pr[f]);
          pi[f] = fmaf(x.x, s0, pi[f]);
          pr[f] = fmaf(x.y, c1, pr[f]);
          pi[f] = fmaf(x.y, s1, pi[f]);
          pr[f] = fmaf(x.z, c2, pr[f]);
          pi[f] = fmaf(x.z, s2, pi[f]);
          pr[f] = fmaf(x.w, c3, pr[f]);
          pi[f] = fmaf(x.w, s3, pi[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        re[f] += pr[f];
        im[f] += pi[f];
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float pw = re[f] * re[f] + im[f] * im[f];
      mag[f * n_bins + k] = sqrtf(pw);
      psum[f] += pw;
    }
  }

  // energy: warp sums, then the warps' partials in warp order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < FT; ++f) {
    float v = psum[f];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp * FT + f] = v;
  }
  __syncthreads();
  if (threadIdx.x < FT && g0 + threadIdx.x < total) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += part[w * FT + threadIdx.x];
    energy_out[g0 + threadIdx.x] = sqrtf(s);    // (B, F) is flat b·F + f
  }

  // mel product from the tile's magnitudes, then log compression
  for (int o = threadIdx.x; o < FT * n_mels; o += blockDim.x) {
    const int i = o / n_mels;
    const int m = o - i * n_mels;
    const int g = g0 + i;
    if (g >= total) continue;
    const float* row = mag + i * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k)
      acc = fmaf(row[k], mel_t[(size_t)k * n_mels + m], acc);
    const int b = g / F;
    mel_out[((size_t)b * n_mels + m) * F + (g - b * F)] =
        logf(fmaxf(acc, clip));
  }
}

}  // namespace

// y (B, S); cos_b and sin_b (n_fft, n_fft/2 + 1); mel_t (n_fft/2 + 1,
// n_mels); mel_out (B, n_mels, F); energy_out (B, F): all contiguous f32.
// n_fft must be a multiple of 4 and S larger than n_fft/2 (reflect padding).
// Returns the cudaError_t of the launch.
extern "C" int log_mel_forward(const void* y, const void* cos_b,
                               const void* sin_b, const void* mel_t,
                               void* mel_out, void* energy_out, int B, int S,
                               int F, int n_fft, int hop, int n_mels,
                               float clip, void* stream) {
  const int total = B * F;
  if (total == 0) return 0;
  if (n_fft % 4 != 0 || S <= n_fft / 2 || hop <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bins = n_fft / 2 + 1;
  int threads = (n_bins + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem =
      sizeof(float) * ((size_t)FT * n_fft + (size_t)FT * n_bins +
                       (size_t)(threads / 32) * FT);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  log_mel_kernel<<<(total + FT - 1) / FT, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(cos_b),
      static_cast<const float*>(sin_b), static_cast<const float*>(mel_t),
      static_cast<float*>(mel_out), static_cast<float*>(energy_out), S, F,
      total, n_fft, hop, n_mels, clip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* log_mel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
