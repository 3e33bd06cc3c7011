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
// Every other n_fft (the TPU kernel takes any) goes to log_mel_mixed_kernel,
// the same design over a mixed-radix plan that the host factors
// (kernels/stft.py fft_plan: radix-4 stages, one radix 2, then 3, 5, 7 and
// any larger primes in ascending order; a power of two outside 32-4096 takes
// the plan above).  An even N packs its samples as above (M = N/2, twiddles
// W_M^x = W_N^{2x}) and ends in the same split step; an odd N takes an
// N-point complex FFT of the real frame (M = N, W_M = W_N) and reads bins
// 0..(N-1)/2 straight from it.  A stage of radix r is the Stockham formula
// above with r free: radices 2, 3, 4, 5 and 7 are butterflies in registers
// (the odd ones over the symmetric sums a_j ± a_r-j, with W_r^j =
// W_N^{jN/r} read once a stage from the same table); any other prime is a
// length-r DFT spread over (butterfly, output) pairs, each r multiply-adds
// with W_r^{jk mod r} gathered from the table, so a prime M still fills the
// block.  Its last stage, for odd N, computes only the bins it keeps.  What
// bounds it is latency, as above: the stages and their barriers; so the
// kernel is held to 64 registers, four blocks an SM, and the GAN shape's
// 528 frames at n_fft 1200 run in one wave (0.0133 ms on the H100, against
// 0.0210 at 66 registers and three blocks an SM).  A prime M is one generic
// stage, as much work as the DFT below, bound by the gathered twiddle
// reads (one 16-byte load a multiply-add).  The two
// ping-pong buffers take 16·N bytes for even N (+16: power and magnitude
// live in the buffer the last stage left free) and 32·N for odd N, so the
// route takes every even n_fft up to 14,526 and every odd one up to 7,263.
//
// The odd n_fft past that (7,265 to 14,527) go to log_mel_dft_kernel: a
// direct real DFT in f64 of each windowed frame, bin k = sum_j x_j W_N^(jk
// mod N) in j order from the same f64 twiddle table, then the same power,
// energy, sparse f64 mel sums and f32 log.  A frame costs (N/2 + 1)·N
// multiply-adds, one chain a bin.  One frame a block again; the frame, power
// and magnitude sit in shared memory (16·N bytes: n_fft up to 14,527), the
// twiddles are read through the L1 cache.
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

// the mixed-radix route: the plan's radices, first stage first
constexpr int MAX_STAGES = 20;
struct Plan {
  int n;
  int radix[MAX_STAGES];
};

// bytes of dynamic shared memory of the mixed-radix kernel: two buffers of
// the FFT's M complex points (M = N/2 for even N, N for odd N); for even N
// 16 bytes more, as the M + 1 bins' power and magnitude overrun the free
// buffer by that much
__host__ __device__ constexpr size_t mixed_smem_bytes(int n_fft) {
  return n_fft % 2 ? 2 * sizeof(double2) * (size_t)n_fft
                   : 2 * sizeof(double2) * (size_t)(n_fft / 2) +
                         2 * sizeof(double);
}

// the length-R DFT of a[], R odd, in place: with t±_j = a_j ± a_R-j,
// y_0 = a_0 + Σ t+_j and, for k <= R/2, y_k, y_R-k = A_k ∓ i B_k where
// A_k = a_0 + Σ_j cos(2πjk/R) t+_j and B_k = Σ_j sin(2πjk/R) t-_j;
// c[m] = cos(2πm/R), sn[m] = sin(2πm/R) for m <= R/2
template <int R>
__device__ __forceinline__ void dft_odd(double2 (&a)[R],
                                        const double (&c)[R / 2 + 1],
                                        const double (&sn)[R / 2 + 1]) {
  constexpr int H = R / 2;
  double2 tp[H + 1], tm[H + 1];
  const double2 a0 = a[0];
  double2 y0 = a0;
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    tp[j] = cadd(a[j], a[R - j]);
    tm[j] = csub(a[j], a[R - j]);
    y0 = cadd(y0, tp[j]);
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    double2 A = a0, Bv = make_double2(0.0, 0.0);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int m = (j * k) % R;
      const double cs = c[m <= H ? m : R - m];
      const double sv = m <= H ? sn[m] : -sn[R - m];
      A.x = fma(cs, tp[j].x, A.x);
      A.y = fma(cs, tp[j].y, A.y);
      Bv.x = fma(sv, tm[j].x, Bv.x);
      Bv.y = fma(sv, tm[j].y, Bv.y);
    }
    a[k] = make_double2(A.x + Bv.y, A.y - Bv.x);
    a[R - k] = make_double2(A.x - Bv.y, A.y + Bv.x);
  }
  a[0] = y0;
}

// one Stockham stage of radix R in registers, at stride s: butterfly
// t = p·s + q reads src[t + k·M/R] and writes its output k, times
// W_M^{kps} = tw[kps·tstep], to dst[q + s·(R·p + k)]
template <int R>
__device__ __forceinline__ void radix_stage(const double2* __restrict__ src,
                                            double2* __restrict__ dst,
                                            const double2* __restrict__ tw,
                                            int N, int M, int s, int tstep) {
  const int nb = M / R;
  double c[R / 2 + 1], sn[R / 2 + 1];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int m = 1; m <= R / 2; ++m) {
      const double2 w = tw[m * (N / R)];
      c[m] = w.x;
      sn[m] = -w.y;
    }
  }
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    const int p = t / s;
    const int q = t - p * s;
    double2 a[R];
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = src[t + k * nb];
    if constexpr (R == 2) {
      const double2 d = csub(a[0], a[1]);
      a[0] = cadd(a[0], a[1]);
      a[1] = d;
    } else if constexpr (R == 4) {
      const double2 apc = cadd(a[0], a[2]), amc = csub(a[0], a[2]);
      const double2 bpd = cadd(a[1], a[3]), bmd = csub(a[1], a[3]);
      const double2 jbmd = make_double2(-bmd.y, bmd.x);
      a[0] = cadd(apc, bpd);
      a[1] = csub(amc, jbmd);
      a[2] = csub(apc, bpd);
      a[3] = cadd(amc, jbmd);
    } else {
      dft_odd<R>(a, c, sn);
    }
    double2* o = dst + q + s * R * p;
    o[0] = a[0];
    const int e = p * s * tstep;
#pragma unroll
    for (int k = 1; k < R; ++k) o[k * s] = cmul(a[k], tw[k * e]);
  }
}

// one Stockham stage of any radix r as a length-r DFT per (butterfly,
// output) pair: item i = k·(M/r) + t sums src[t + j·M/r]·W_r^{jk mod r}
// over j in order, then times W_M^{kps}.  On the last stage (p = 0,
// s = M/r) item i writes dst[i], so ``limit`` < M keeps the first bins only.
__device__ __forceinline__ void generic_stage(const double2* __restrict__ src,
                                              double2* __restrict__ dst,
                                              const double2* __restrict__ tw,
                                              int N, int M, int r, int s,
                                              int tstep, int limit) {
  const int nb = M / r;
  const int nr = N / r;
  for (int i = threadIdx.x; i < limit; i += blockDim.x) {
    const int k = i / nb;
    const int t = i - k * nb;
    const int p = t / s;
    const int q = t - p * s;
    double2 acc = make_double2(0.0, 0.0);
    int e = 0;                                        // j·k mod r
    for (int j = 0; j < r; ++j) {
      const double2 w = __ldg(tw + e * nr);
      const double2 x = src[t + j * nb];
      acc.x = fma(x.x, w.x, fma(-x.y, w.y, acc.x));
      acc.y = fma(x.x, w.y, fma(x.y, w.x, acc.y));
      e += k;
      if (e >= r) e -= r;
    }
    dst[q + s * (r * p + k)] = cmul(acc, tw[k * p * s * tstep]);
  }
}

// one block per frame g = b·F + f, any n_fft >= 2 whose buffers fit; at
// most 64 registers, so four blocks share an SM (66 without the bound: three)
__global__ void __launch_bounds__(THREADS, 4)
log_mel_mixed_kernel(const float* __restrict__ y,
                     const double* __restrict__ window,
                     const double2* __restrict__ tw,
                     const int* __restrict__ mel_ranges,
                     const float* __restrict__ mel_w,
                     float* __restrict__ mel_out,
                     float* __restrict__ energy_out, Plan plan, int S, int F,
                     int n_fft, int hop, int n_mels, float clip) {
  extern __shared__ double2 smem2[];
  const int N = n_fft;
  const bool odd = N & 1;
  const int M = odd ? N : N / 2;
  const int tstep = odd ? 1 : 2;                 // W_M^x = W_N^{x·tstep}
  const int nb = N / 2 + 1;                      // bins
  const int g = blockIdx.x;
  const int b = g / F;
  // the result lands in the first buffer after the plan's stages: start in
  // the second when their count is odd; the second then holds power and
  // magnitude (and the 16 bytes past it, for even N)
  double2* src = smem2 + (plan.n & 1 ? M : 0);
  double2* dst = smem2 + (plan.n & 1 ? 0 : M);
  double* power = reinterpret_cast<double*>(smem2 + M);     // nb
  double* mag = power + nb;                                  // nb

  const float* row = y + (size_t)b * S;
  const int p_first = (g - b * F) * hop - N / 2;
  if (odd) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      int p = p_first + j;
      if (p < 0) p = -p;
      if (p >= S) p = 2 * (S - 1) - p;
      src[j] = make_double2((double)row[p] * window[j], 0.0);
    }
  } else {
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
  }
  __syncthreads();

  int s = 1;
  for (int i = 0; i < plan.n; ++i) {
    const int r = plan.radix[i];
    switch (r) {
      case 2: radix_stage<2>(src, dst, tw, N, M, s, tstep); break;
      case 3: radix_stage<3>(src, dst, tw, N, M, s, tstep); break;
      case 4: radix_stage<4>(src, dst, tw, N, M, s, tstep); break;
      case 5: radix_stage<5>(src, dst, tw, N, M, s, tstep); break;
      case 7: radix_stage<7>(src, dst, tw, N, M, s, tstep); break;
      default:
        generic_stage(src, dst, tw, N, M, r, s, tstep,
                      odd && i == plan.n - 1 ? nb : M);
    }
    double2* t = src; src = dst; dst = t;
    s *= r;
    __syncthreads();
  }

  // power and magnitude of the N/2 + 1 bins, into the free buffer
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    double re, im;
    if (odd) {
      re = src[k].x;
      im = src[k].y;
    } else {
      const double2 zk = src[k < M ? k : 0];
      const double2 zm = src[k > 0 ? M - k : 0];
      const double2 ev = make_double2(0.5 * (zk.x + zm.x),
                                      0.5 * (zk.y - zm.y));
      const double2 od = make_double2(0.5 * (zk.x - zm.x),
                                      0.5 * (zk.y + zm.y));
      const double2 wo = cmul(tw[k], od);
      re = ev.x + wo.y;
      im = ev.y - wo.x;
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

// As log_mel_forward, by the mixed-radix FFT, for any n_fft from 2 while
// its shared memory fits (mixed_smem_bytes) and S larger than n_fft/2.
// radices (host memory, n_stages of them, at most MAX_STAGES) is the plan:
// their product must be n_fft/2 for an even n_fft and n_fft for an odd one.
extern "C" int log_mel_mixed_forward(const void* y, const void* window,
                                     const void* twiddles,
                                     const void* mel_ranges,
                                     const void* mel_w, void* mel_out,
                                     void* energy_out, const int* radices,
                                     int n_stages, int B, int S, int F,
                                     int n_fft, int hop, int n_mels,
                                     float clip, void* stream) {
  const int total = B * F;
  if (total == 0) return 0;
  const size_t smem = mixed_smem_bytes(n_fft);
  if (n_fft < 2 || smem > MAX_SMEM || S <= n_fft / 2 || hop <= 0 ||
      n_stages < 0 || n_stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{};
  plan.n = n_stages;
  long long product = 1;
  for (int i = 0; i < n_stages; ++i) {
    if (radices[i] < 2) return static_cast<int>(cudaErrorInvalidValue);
    plan.radix[i] = radices[i];
    product *= radices[i];
    if (product > n_fft) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (product != (n_fft % 2 ? n_fft : n_fft / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_mixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  log_mel_mixed_kernel<<<total, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const double*>(window),
      static_cast<const double2*>(twiddles),
      static_cast<const int*>(mel_ranges), static_cast<const float*>(mel_w),
      static_cast<float*>(mel_out), static_cast<float*>(energy_out), plan, S,
      F, n_fft, hop, n_mels, clip);
  return static_cast<int>(cudaGetLastError());
}

// bytes of dynamic shared memory a block of the mixed-radix kernel takes
extern "C" int log_mel_mixed_smem_bytes(int n_fft) {
  return static_cast<int>(mixed_smem_bytes(n_fft));
}

// As log_mel_forward, by the direct DFT, for any n_fft from 2 while its
// shared memory fits (dft_smem_bytes) and S larger than n_fft/2.
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

// bytes of dynamic shared memory a block of the DFT kernel takes
extern "C" int log_mel_dft_smem_bytes(int n_fft) {
  return static_cast<int>(dft_smem_bytes(n_fft));
}

// shared memory a block may take (the routes' limit)
extern "C" int log_mel_max_smem_bytes() { return MAX_SMEM; }

extern "C" const char* log_mel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
