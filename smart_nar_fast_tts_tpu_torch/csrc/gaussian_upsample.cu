// Banded Gaussian upsampling: the length regulator of the variance adaptor.
//
// Replaces the TPU kernel `_banded_kernel` / `_banded_forward` of
// smart_nar_fast_tts_tpu/ops/pallas/upsample.py.  For frame t of item b:
//   out[t] = sum_l w_l x_l / (sum_l w_l + 1e-20),
//   w_l = exp(-inv_sigma2 * (t - c_l)^2) * valid_l,
//   c = cumsum(d·valid) - d·valid/2,  total = sum(d·valid),
// and out[t] = 0 for t >= total; mel_len = min(total, T) as int32.  A
// phoneme whose center lies more than `band` (sqrt(104) sigma ~ 10.2 sigma)
// outside the tile's frames is left out: its weight there is below
// exp(-104) ~ 6.8e-46, under half the least f32 subnormal, so expf gives
// exactly 0 for it as in the dense function.  (A band of 6 sigma left out
// weights of up to exp(-36), which the 1e-20 of the denominator does not
// hide: a frame 60-70 frames from every center, of a phoneme longer than
// ~12 sigma, came out 0 where the dense function gives ~x.)  Everything is
// f32 FMA: no TF32, as the TPU kernel's Precision.HIGHEST.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): bytes.  It reads x
// (B, L, D) once and writes out (B, T, D) once, while an output element
// needs one FMA per phoneme in its band (~30): 0.0150 ms at the training
// shape (48, 128, 256) → 896, 0.00276 ms at serving (8, 128, 256) → 1000,
// 0.0103 ms at cap 4096 (1 MB in, 33.5 MB out, ~70 % of it zeros past the
// utterances' ends).  Design for that:
// - One block per (item, tile of TT = 32 frames, slice of 256 channels):
//   256 threads, each owning one float4 of channels and 8 frames, so it
//   keeps an 8 × 4 register tile of sums.
// - Each block scans its item's durations itself, 256 phonemes a round (a
//   shuffle scan in each warp, then across the warps' totals): centers,
//   total, and, by ballot and prefix count, the in-band valid phonemes
//   compacted in phoneme order (centers need not be monotone).  The block
//   of tile 0 writes mel_len.  No launch besides.
// - A tile at or past total writes zeros and returns; inside a tile, frames
//   past total take no weights.
// - The compacted phonemes go in chunks of LCH = 32 (any count works): the
//   chunk's x rows are staged by cp.async in 16-byte pieces (4-byte pieces
//   when D is not a multiple of 4), double-buffered; its weights are
//   computed once per (phoneme, frame) into shared memory, and the
//   denominator is summed once per frame, in a fixed order.
// - The epilogue multiplies by one reciprocal of the denominator per frame
//   (32 IEEE divisions a thread were a large part of a block's time) and
//   stores float4s: a frame row of 256 channels is 1 KB of contiguous
//   stores.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;                 // frames per tile
constexpr int QX = 64;                 // float4s of channels per block
constexpr int FY = 4;                  // frame groups
constexpr int FR = TT / FY;            // frames per thread
constexpr int LCH = 32;                // phonemes per chunk
constexpr int THREADS = QX * FY;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;       // shared memory a block may use
static_assert(TT == 32, "the weight pass maps a warp's lanes to frames");
static_assert(FR % 4 == 0, "weights are read as float4s");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// bytes of dynamic shared memory for L phonemes
__host__ __device__ constexpr size_t smem_bytes(int L) {
  return sizeof(float) * ((size_t)2 * LCH * QX * 4 + LCH * TT + WARPS * TT +
                          TT + 2 * WARPS + 5 * (size_t)L);
}

__global__ void __launch_bounds__(THREADS)
gaussian_upsample_kernel(const float* __restrict__ x,
                         const float* __restrict__ durations,
                         const float* __restrict__ valid,
                         float* __restrict__ out, int* __restrict__ mel_len,
                         int L, int T, int D, float inv_sigma2, float band,
                         int vec) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);       // 2 × LCH × QX·4
  float* w_s = xs + 2 * LCH * QX * 4;                // LCH × TT
  float* part_s = w_s + LCH * TT;                    // WARPS × TT
  float* inv_s = part_s + WARPS * TT;                // TT: 1 / denominator
  float* wsum_s = inv_s + TT;                        // WARPS: scan totals
  int* wcnt_s = reinterpret_cast<int*>(wsum_s + WARPS);  // WARPS: band counts
  float* dv_s = wsum_s + 2 * WARPS;                  // L: d·valid
  float* v_s = dv_s + L;                             // L: valid
  float* band_c = v_s + L;                           // L: compacted centers
  float* band_v = band_c + L;                        // L: their valid
  int* band_idx = reinterpret_cast<int*>(band_v + L);   // L: their l

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int q0 = blockIdx.z * QX;                    // first float4 column
  const int nq = min(QX, (D + 3) / 4 - q0);          // float4s in the slice
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cq = tid % QX;
  const int fy = tid / QX;
  const float t_lo = static_cast<float>(t0);
  const float t_hi = static_cast<float>(t0 + TT - 1);

  for (int l = tid; l < L; l += THREADS) {
    const float v = valid[(size_t)b * L + l];
    v_s[l] = v;
    dv_s[l] = durations[(size_t)b * L + l] * v;
  }
  __syncthreads();

  // centers, total and the compacted band, THREADS phonemes a round: a scan
  // within each warp, then across the warps' totals
  float total = 0.f;
  int n_band = 0;
  for (int l0 = 0; l0 < L; l0 += THREADS) {
    const int l = l0 + tid;
    const float dv = l < L ? dv_s[l] : 0.f;
    float e = dv;
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, e, off);
      if (lane >= off) e += n;
    }
    if (lane == 31) wsum_s[warp] = e;
    __syncthreads();
    float before = total;
    for (int w = 0; w < warp; ++w) before += wsum_s[w];
    e += before;
    const float c = e - 0.5f * dv;
    const float v = l < L ? v_s[l] : 0.f;
    const bool keep = l < L && v != 0.f && c + band >= t_lo &&
                      c - band <= t_hi;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcnt_s[warp] = __popc(ballot);
    __syncthreads();
    int at = n_band + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += wcnt_s[w];
    if (keep) {
      band_idx[at] = l;
      band_c[at] = c;
      band_v[at] = v;
    }
    for (int w = 0; w < WARPS; ++w) {
      total += wsum_s[w];
      n_band += wcnt_s[w];
    }
    __syncthreads();                 // the band and the round's sums are read
  }
  if (tid == 0 && blockIdx.x == 0 && blockIdx.z == 0)
    mel_len[b] = static_cast<int>(fminf(total, static_cast<float>(T)));
  const int ch = 4 * (q0 + cq);                      // first channel owned
  float* out_b = out + (size_t)b * T * D;

  if (t_lo >= total) {                               // the tile is silence
    for (int i = fy; i < TT && t0 + i < T; i += FY) {
      if (cq >= nq) break;
      float* row = out_b + (size_t)(t0 + i) * D;
      if (vec) {
        *reinterpret_cast<float4*>(row + ch) = make_float4(0.f, 0.f, 0.f,
                                                           0.f);
      } else {
        for (int e = 0; e < 4 && ch + e < D; ++e) row[ch + e] = 0.f;
      }
    }
    return;
  }

  // stage the x rows of chunk k into buffer k & 1
  auto stage = [&](int k) {
    const int j0 = k * LCH;
    const int jn = min(LCH, n_band - j0);
    float* buf = xs + (k & 1) * LCH * QX * 4 + 4 * cq;
    for (int j = fy; j < jn && cq < nq; j += FY) {
      const float* src = x + ((size_t)b * L + band_idx[j0 + j]) * D + ch;
      float* dst = buf + j * QX * 4;
      if (vec) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (ch + e < D) cp_async4(dst + e, src + e);
          else dst[e] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  float acc[FR][4];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float den = 0.f;                   // warp 0: lane = the tile's frame

  const int nchunks = (n_band + LCH - 1) / LCH;
  if (nchunks > 0) stage(0);
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage(k + 1);
    const int j0 = k * LCH;
    const int jn = min(LCH, n_band - j0);
    // weights: lane = frame, warp w takes phonemes w, w + 8, ...
    {
      const float t = static_cast<float>(t0 + lane);
      float psum = 0.f;
      for (int j = warp; j < LCH; j += WARPS) {
        float w = 0.f;
        if (j < jn && t < total) {
          const float diff = t - band_c[j0 + j];
          w = expf(-inv_sigma2 * (diff * diff)) * band_v[j0 + j];
        }
        w_s[j * TT + lane] = w;
        psum += w;
      }
      part_s[warp * TT + lane] = psum;
    }
    if (k + 1 < nchunks) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      for (int w = 0; w < WARPS; ++w) den += part_s[w * TT + lane];
    }
    if (cq < nq) {
      const float* buf = xs + (k & 1) * LCH * QX * 4 + 4 * cq;
      const float* wrow = w_s + fy * FR;
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(buf + j * QX * 4);
        float w[FR];
#pragma unroll
        for (int i = 0; i < FR; i += 4) {
          const float4 wq =
              *reinterpret_cast<const float4*>(wrow + j * TT + i);
          w[i] = wq.x;
          w[i + 1] = wq.y;
          w[i + 2] = wq.z;
          w[i + 3] = wq.w;
        }
#pragma unroll
        for (int i = 0; i < FR; ++i) {
          acc[i][0] = fmaf(w[i], xv.x, acc[i][0]);
          acc[i][1] = fmaf(w[i], xv.y, acc[i][1]);
          acc[i][2] = fmaf(w[i], xv.z, acc[i][2]);
          acc[i][3] = fmaf(w[i], xv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();                 // chunk k's buffer and weights consumed
  }

  if (warp == 0) inv_s[lane] = 1.f / (den + 1e-20f);
  __syncthreads();
  if (cq >= nq) return;
#pragma unroll
  for (int i = 0; i < FR; ++i) {
    const int t = t0 + fy * FR + i;
    if (t >= T) break;
    const bool live = static_cast<float>(t) < total;
    const float inv = inv_s[fy * FR + i];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      o = make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                      acc[i][3] * inv);
    }
    float* row = out_b + (size_t)t * D;
    if (vec) {
      *reinterpret_cast<float4*>(row + ch) = o;
    } else {
      const float v[4] = {o.x, o.y, o.z, o.w};
      for (int e = 0; e < 4 && ch + e < D; ++e) row[ch + e] = v[e];
    }
  }
}

}  // namespace

// x (B, L, D), durations and valid (B, L), out (B, T, D): contiguous f32;
// mel_len (B,) int32.  vec = 1 when D is a multiple of 4 and x is 16-byte
// aligned (float4 staging and stores), else 0.  Returns the cudaError_t of
// the launch.
extern "C" int gaussian_upsample_forward(const void* x, const void* durations,
                                         const void* valid, void* out,
                                         void* mel_len, int B, int L, int T,
                                         int D, float inv_sigma2, float band,
                                         int vec, void* stream) {
  if (B == 0) return 0;
  if (T == 0)                                        // mel_len = min(Σd, 0)
    return static_cast<int>(cudaMemsetAsync(
        mel_len, 0, sizeof(int) * B, static_cast<cudaStream_t>(stream)));
  const size_t smem = smem_bytes(L);
  if (smem > MAX_SMEM || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gaussian_upsample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + TT - 1) / TT, B, ((D + 3) / 4 + QX - 1) / QX);
  gaussian_upsample_kernel<<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(durations),
      static_cast<const float*>(valid), static_cast<float*>(out),
      static_cast<int*>(mel_len), L, T, D, inv_sigma2, band, vec);
  return static_cast<int>(cudaGetLastError());
}

// the largest L the kernel takes (its shared memory grows with L)
extern "C" int gaussian_upsample_max_l() {
  return static_cast<int>((MAX_SMEM - smem_bytes(0)) / (5 * sizeof(float)));
}

// bytes of dynamic shared memory a block takes at L phonemes
extern "C" int gaussian_upsample_smem_bytes(int L) {
  return static_cast<int>(smem_bytes(L));
}

extern "C" const char* gaussian_upsample_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
