// Fused STFT → log-mel: waveform (B, S) f32 → log-mel (B, n_mels, F) and
// frame energy (B, F) f32.
//
// Replaces the TPU kernel `_logmel_kernel` / `fused_log_mel` of
// smart_nar_fast_tts_tpu/ops/pallas/stft.py, whose DFT is two products
// against dense cos/sin bases.  Here the DFT is a real FFT in f64, in
// shared memory.  Frame f of item b is the reflect-padded signal
// y[f*hop - n_fft/2 + j], j < n_fft (the padding is index arithmetic, not a
// padded copy).  With N = n_fft and M = N/2:
//   z_j = w_2j x_2j + i w_2j+1 x_2j+1          (f64 window table)
//   Z = FFT_M(z)                                Stockham stages in f64
//   X_k = (Z_k + conj Z_M-k)/2 - i/2 W_N^k (Z_k - conj Z_M-k),  k <= M
//   power_k = |X_k|^2,  energy = sqrt(sum_k power_k)          (f64)
//   mel_m = f32(sum over filter m's bin range of w_mk sqrt(power_k)) (f64)
//   out_m = logf(fmaxf(mel_m, clip))                           (f32)
// The Stockham stages are radix-4 (one radix-2 stage first when log2 M is
// odd): at a stage of length n and stride s (n·s = M), butterfly (p, q)
// reads q + s·(p + k·n/r) and writes its output k, times W_n^{kp} =
// W_N^{2kps}, to q + s·(r·p + k), so the result comes out in natural order
// without a bit reversal.  Every twiddle comes from one host table of
// W_N^k, k < N, built in float64; none from sincos on the device.  The mel
// sums run over each filter's contiguous bin range (a host table of start,
// count and offset into the packed f32 weights: 727 nonzeros for the
// flagship's 80 × 513 filterbank), in bin order.
//
// Why f64: log compression turns a relative error of a quiet bin (~110 dB
// below its frame's loudest) into an absolute error of the output.  An f32
// radix FFT, emulated on tones with a pause, is 1.1e-3 to 1.6e-3 from
// float64, over the 2e-4 tolerance (cuFFT's is 2.1e-3); the same FFT in f64
// with f32 storage between stages is 4.8e-4, and all in f64 up to the f32
// epilogue the error is that of the epilogue alone (~1e-6).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): operations.  At the GAN
// step's shape (B 16, 8192 samples, N 1024, 528 frames) the function's
// least work is ~16 MFLOP (a real FFT, ~25.6 kFLOP a frame, and the
// filterbank), 0.000243 ms at the f32 rate; its 0.7 MB of input and output
// take 0.000208 ms.  f64 on CUDA cores (34 TFLOP/s) adds ~0.4 µs at most.
// What bounds this kernel is latency: the launch, the loads, and the
// barriers between its stages, the FFT stages the longest part of a block.
// So the design spreads the frames over every SM and keeps several blocks
// on each to hide one another's latency: one frame a block (528 blocks at
// the GAN shape, 24.6 KB of shared memory each at N 1024; four frames a
// block, 132 blocks, was slower on the card), its FFT ping-ponging between
// two shared-memory buffers of M complex f64; the split step writes power
// and magnitude of every bin in parallel, so each mel sum is a short chain
// of FMAs, not of square roots.  Energy and mel sums run in a fixed order:
// the outputs are bit-equal from run to run.
//
// Every other n_fft (the TPU kernel takes any) goes to log_mel_dft_kernel: a
// direct real DFT in f64 of each windowed frame, bin k = sum_j x_j W_N^(jk
// mod N) in j order from the same f64 twiddle table, then the same power,
// energy, sparse f64 mel sums and f32 log.  A frame costs (N/2 + 1)·N
// complex multiply-adds (601 × 1200 at n_fft 1200: the GAN step's 528
// frames are ~1.5 GFLOP of f64), cheap beside a train step.  One frame a
// block again; the frame, power and magnitude sit in shared memory (16·N
// bytes: n_fft up to 14,000), the twiddles are read through the L1 cache.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// bytes of dynamic shared memory: two buffers of M complex points, then
// power and magnitude of the M + 1 bins
__host__ __device__ constexpr size_t smem_bytes(int n_fft) {
  return 2 * sizeof(double2) * (size_t)(n_fft / 2) +
         2 * sizeof(double) * (size_t)(n_fft / 2 + 1);
}

// one block per frame g = b·F + f
__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ y, const double* __restrict__ window,
               const double2* __restrict__ tw,
               const int* __restrict__ mel_ranges,
               const float* __restrict__ mel_w, float* __restrict__ mel_out,
               float* __restrict__ energy_out, int S, int F, int n_fft,
               int hop, int n_mels, float clip) {
  extern __shared__ double2 smem2[];
  const int M = n_fft / 2;
  const int log_m = __ffs(M) - 1;
  const int g = blockIdx.x;
  const int b = g / F;
  double2* src = smem2;
  double2* dst = smem2 + M;
  double* power = reinterpret_cast<double*>(smem2 + 2 * M);   // M + 1
  double* mag = power + M + 1;                                // M + 1

  // the windowed frame as M complex points (even, odd sample pairs)
  const float* row = y + (size_t)b * S;
  const int p_first = (g - b * F) * hop - M;
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    int p0 = p_first + 2 * j;
    int p1 = p0 + 1;
    if (p0 < 0) p0 = -p0;
    if (p1 < 0) p1 = -p1;
    if (p0 >= S) p0 = 2 * (S - 1) - p0;
    if (p1 >= S) p1 = 2 * (S - 1) - p1;
    src[j] = make_double2((double)row[p0] * window[2 * j],
                          (double)row[p1] * window[2 * j + 1]);
  }
  __syncthreads();

  int log_s = 0;
  if (log_m & 1) {                                   // one radix-2 stage
    const int h = M / 2;
    for (int p = threadIdx.x; p < h; p += blockDim.x) {
      const double2 a = src[p], c = src[p + h];
      dst[2 * p] = cadd(a, c);
      dst[2 * p + 1] = cmul(csub(a, c), tw[2 * p]);
    }
    double2* t = src; src = dst; dst = t;
    log_s = 1;
    __syncthreads();
  }
  for (; log_s < log_m; log_s += 2) {                // radix-4 stages
    const int s = 1 << log_s;
    for (int t = threadIdx.x; t < M / 4; t += blockDim.x) {
      const int p = t >> log_s;
      const int q = t & (s - 1);
      const double2* x = src + q + s * p;
      double2* o = dst + q + s * 4 * p;
      const double2 a = x[0], c1 = x[M / 4], c2 = x[M / 2], c3 = x[3 * M / 4];
      const double2 apc = cadd(a, c2), amc = csub(a, c2), bpd = cadd(c1, c3);
      const double2 bmd = csub(c1, c3);
      const double2 jbmd = make_double2(-bmd.y, bmd.x);
      const int e = 2 * p * s;
      o[0] = cadd(apc, bpd);
      o[s] = cmul(csub(amc, jbmd), tw[e]);
      o[2 * s] = cmul(csub(apc, bpd), tw[2 * e]);
      o[3 * s] = cmul(cadd(amc, jbmd), tw[3 * e]);
    }
    double2* t = src; src = dst; dst = t;
    __syncthreads();
  }

  // split step to M + 1 bins: power and magnitude
  for (int k = threadIdx.x; k <= M; k += blockDim.x) {
    const double2 zk = src[k & (M - 1)];
    const double2 zm = src[(M - k) & (M - 1)];
    // e = (zk + conj zm)/2, o = (zk - conj zm)/2; X = e - i·W^k·o
    const double2 ev = make_double2(0.5 * (zk.x + zm.x), 0.5 * (zk.y - zm.y));
    const double2 od = make_double2(0.5 * (zk.x - zm.x), 0.5 * (zk.y + zm.y));
    const double2 wo = cmul(tw[k], od);
    const double re = ev.x + wo.y;
    const double im = ev.y - wo.x;
    const double pw = re * re + im * im;
    power[k] = pw;
    mag[k] = sqrt(pw);
  }
  __syncthreads();

  // energy: warp 0 sums the bins lane-strided, then a fixed tree
  if (threadIdx.x < 32) {
    double acc = 0.0;
    for (int k = threadIdx.x; k <= M; k += 32) acc += power[k];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) energy_out[g] = (float)sqrt(acc);  // (B, F) flat
  }

  // mel sums over each filter's range, then log compression in f32
  for (int m = threadIdx.x; m < n_mels; m += blockDim.x) {
    const int start = mel_ranges[3 * m];
    const int count = mel_ranges[3 * m + 1];
    const float* w = mel_w + mel_ranges[3 * m + 2];
    double acc = 0.0;
    for (int k = 0; k < count; ++k)
      acc = fma((double)w[k], mag[start + k], acc);
    mel_out[((size_t)b * n_mels + m) * F + (g - b * F)] =
        logf(fmaxf((float)acc, clip));
  }
}

// bytes of dynamic shared memory of the DFT kernel: the windowed frame,
// then power and magnitude of the N/2 + 1 bins
__host__ __device__ constexpr size_t dft_smem_bytes(int n_fft) {
  return sizeof(double) * ((size_t)n_fft + 2 * (size_t)(n_fft / 2 + 1));
}

// one block per frame g = b·F + f, any n_fft >= 2
__global__ void __launch_bounds__(THREADS)
log_mel_dft_kernel(const float* __restrict__ y,
                   const double* __restrict__ window,
                   const double2* __restrict__ tw,
                   const int* __restrict__ mel_ranges,
                   const float* __restrict__ mel_w, float* __restrict__ mel_out,
                   float* __restrict__ energy_out, int S, int F, int n_fft,
                   int hop, int n_mels, float clip) {
  extern __shared__ double dsmem[];
  const int N = n_fft;
  const int nb = N / 2 + 1;
  const int g = blockIdx.x;
  const int b = g / F;
  double* x = dsmem;                                   // N
  double* power = x + N;                               // nb
  double* mag = power + nb;                            // nb

  const float* row = y + (size_t)b * S;
  const int p_first = (g - b * F) * hop - N / 2;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    int p = p_first + j;
    if (p < 0) p = -p;
    if (p >= S) p = 2 * (S - 1) - p;
    x[j] = (double)row[p] * window[j];
  }
  __syncthreads();

  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    double re = 0.0, im = 0.0;
    int e = 0;                                         // j·k mod N
    for (int j = 0; j < N; ++j) {
      const double2 w = __ldg(tw + e);
      re = fma(x[j], w.x, re);
      im = fma(x[j], w.y, im);
      e += k;
      if (e >= N) e -= N;
    }
    const double pw = re * re + im * im;
    power[k] = pw;
    mag[k] = sqrt(pw);
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    double acc = 0.0;
    for (int k = threadIdx.x; k < nb; k += 32) acc += power[k];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) energy_out[g] = (float)sqrt(acc);
  }
  for (int m = threadIdx.x; m < n_mels; m += blockDim.x) {
    const int start = mel_ranges[3 * m];
    const int count = mel_ranges[3 * m + 1];
    const float* w = mel_w + mel_ranges[3 * m + 2];
    double acc = 0.0;
    for (int k = 0; k < count; ++k)
      acc = fma((double)w[k], mag[start + k], acc);
    mel_out[((size_t)b * n_mels + m) * F + (g - b * F)] =
        logf(fmaxf((float)acc, clip));
  }
}

constexpr int MAX_SMEM = 232448;       // shared memory a block may use

}  // namespace

// y (B, S) f32; window (n_fft,) f64; twiddles (n_fft, 2) f64, W_N^k;
// mel_ranges (n_mels, 3) int32 (start, count, offset); mel_w packed f32;
// mel_out (B, n_mels, F) f32; energy_out (B, F) f32; all contiguous.  n_fft
// must be a power of two from 32 to 4096 and S larger than n_fft/2 (reflect
// padding).  Returns the cudaError_t of the launch.
extern "C" int log_mel_forward(const void* y, const void* window,
                               const void* twiddles, const void* mel_ranges,
                               const void* mel_w, void* mel_out,
                               void* energy_out, int B, int S, int F,
                               int n_fft, int hop, int n_mels, float clip,
                               void* stream) {
  const int total = B * F;
  if (total == 0) return 0;
  if (n_fft < 32 || n_fft > 4096 || (n_fft & (n_fft - 1)) != 0 ||
      S <= n_fft / 2 || hop <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n_fft);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  log_mel_kernel<<<total, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const double*>(window),
      static_cast<const double2*>(twiddles),
      static_cast<const int*>(mel_ranges), static_cast<const float*>(mel_w),
      static_cast<float*>(mel_out), static_cast<float*>(energy_out), S, F,
      n_fft, hop, n_mels, clip);
  return static_cast<int>(cudaGetLastError());
}

// bytes of dynamic shared memory a block takes at n_fft
extern "C" int log_mel_smem_bytes(int n_fft) {
  return static_cast<int>(smem_bytes(n_fft));
}

// As log_mel_forward, by the direct DFT, for any n_fft from 2 while its
// shared memory fits (log_mel_dft_max_n_fft) and S larger than n_fft/2.
extern "C" int log_mel_dft_forward(const void* y, const void* window,
                                   const void* twiddles,
                                   const void* mel_ranges, const void* mel_w,
                                   void* mel_out, void* energy_out, int B,
                                   int S, int F, int n_fft, int hop,
                                   int n_mels, float clip, void* stream) {
  const int total = B * F;
  if (total == 0) return 0;
  const size_t smem = dft_smem_bytes(n_fft);
  if (n_fft < 2 || smem > MAX_SMEM || S <= n_fft / 2 || hop <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  log_mel_dft_kernel<<<total, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const double*>(window),
      static_cast<const double2*>(twiddles),
      static_cast<const int*>(mel_ranges), static_cast<const float*>(mel_w),
      static_cast<float*>(mel_out), static_cast<float*>(energy_out), S, F,
      n_fft, hop, n_mels, clip);
  return static_cast<int>(cudaGetLastError());
}

// the largest n_fft the DFT kernel's shared memory holds
extern "C" int log_mel_dft_max_n_fft() {
  int n = (int)(MAX_SMEM / (2 * sizeof(double))) ;
  while (dft_smem_bytes(n) > MAX_SMEM) --n;
  return n;
}

extern "C" const char* log_mel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
