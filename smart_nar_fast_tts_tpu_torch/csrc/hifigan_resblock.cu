// One convolution of a HiFi-GAN resblock, with the elementwise work around
// it: y = conv1d(leaky_relu(x, slope), W, b, dilation d, padding (k-1)d/2)
// for x (B, Cin, T), W (Cout, Cin, k), then one epilogue:
//   mode 0   y                      ResBlock1's first conv, h
//   mode 1   r + y                  the residual: x + conv(...)
//   mode 2   (acc + (r + y)) / div  the multi-receptive-field sum folded into
//                                   a resblock's last conv; div is 1 but in
//                                   the stage's last resblock, n_kernels
// The sums and the division are the module chain's f32 operations, in its
// order (HiFiGANGenerator.forward).
//
// Replaces no TPU kernel: the JAX package's HiFi-GAN convolutions are XLA's.
// It takes the place of cuDNN's float32 implicit-GEMM convolution (no TF32:
// the configurations compute in float32) and of the separate LeakyReLU,
// residual, sum and division passes, which read and write every activation
// again.
//
// Precision: 3xTF32 on the tensor cores, as csrc/alignment_attention.cu.
// The LeakyReLU is applied in f32; each operand x is split as hi = tf32(x)
// and lo = tf32(x - hi), both rounded to nearest with ties away; a product
// sums lo*hi + hi*lo + hi*hi with f32 accumulators (lo*lo, ~2^-22 of it, is
// dropped): about f32 accuracy at the TF32 rate.  The activations are split
// once per block as their tile enters shared memory; the weights once per
// call, by resblock_weight_split_kernel, into a scratch buffer the caller
// passes (nothing split is kept between calls).  The tensor core aligns the
// addends of an accumulation to the largest and drops the bits shifted
// out: summed into one accumulator over a conv's hundreds of k-steps that
// gave ~6x cuDNN's float32 error (4.4e-6 of the largest output against
// 7.7e-7 at C 256, k 3 on an H100).  So each step's products (up to 6 taps
// of 8 input channels) accumulate from zero, and that part is added to the
// running sum by an f32 add.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): operations.  A conv is
// 2·B·T·Cin·Cout·k operations, three times over in 3xTF32 at 495 TFLOP/s;
// its bytes are x and y once (plus r and acc), 4·B·T·C each.  HiFi-GAN V1's
// 72 resblock convs at B 16 × 1000 mel frames are 9.5 TFLOP: 57.6 ms at
// 3xTF32, against ~22 ms for their bytes.  Design for that:
// - Implicit GEMM on wgmma (sm_90a): M is a tile of output time steps of one
//   item, N a tile of BN output channels, K runs over (8-channel group,
//   tap).  Both operands come from shared memory without swizzle: a core
//   matrix is 8 rows of 16 bytes, so a descriptor may start at any row, and
//   the dilated taps are row offsets j·d into one input tile (a swizzled
//   layout would need 8-row-aligned starts).  mma.sync m16n8k8 with the A
//   fragments loaded by hand reached ~48 conv-TFLOP/s at C 128-256 (its
//   registers and latency); this reaches ~70 (chip_smoke.py).
// - The input tile of a group is four planes (hi of K slots 0-3, hi of 4-7,
//   lo of 0-3, lo of 4-7) of BM + (k-1)d rows x 4 floats; K slot c of a half
//   h is input channel 2c + h.  The weights arrive split, in the same K
//   order and in core matrices, per (group, tap): hi, then lo.
// - A step is up to 6 taps of one group: its weights stream through a ring
//   of 3 stages of cp.async, two steps ahead; a group's raw input rows
//   arrive two steps ahead too, into one of two raw buffers, and are split
//   (LeakyReLU, hi/lo) into the planes when the group starts.  Each step's
//   weights are read by every m-tile of the block: the weights' traffic
//   per operation falls with BM, which is why a warpgroup takes up to four
//   64-row m-tiles.
// - The tile (BN, warpgroups, m-tiles a warpgroup) is chosen at each launch
//   from the shape of the call (tile_for): wide tiles where the grid fills
//   the card, small ones where a call is short (B 1-2 online).
// - The epilogue adds the bias, the residual and the running sum in f32 in
//   the module chain's order; a store instruction writes 8 consecutive time
//   steps of 4 channels (full 32-byte sectors).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory
constexpr int NS = 3;             // weight ring stages
constexpr int AHEAD = NS - 1;     // steps issued ahead (<= 2 for the raw ring)
constexpr int MAX_TAPS = 6;       // taps a step

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (st.shared, cp.async) made visible to
// the tensor core's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the bits of cvt.rna.tf32.f32 (csrc/alignment_attention.cu)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ float2 split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return make_float2(__uint_as_float(hi),
                     __uint_as_float(tf32_rna(x - __uint_as_float(hi))));
}

// A wgmma shared-memory descriptor without swizzle: start address, the
// byte offsets between core matrices along K (lbo) and along M or N (sbo).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lbo >> 4) << 16)
       | (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from reading registers that an asynchronous wgmma
// writes before the wait that ends it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ACC8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC16 ACC8(0), ACC8(8)
#define ACC32 ACC16, ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define LIST8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define LIST16 LIST8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define LIST32                                                            \
  LIST16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define LIST64                                                            \
  LIST32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"
// d (64 x N, f32) = or += A (64 x 8) B (8 x N), tf32 operands K-major in
// shared memory; the operand numbers of a, b and the scale-d flag follow
// the accumulators
#define WGMMA_SS(N, ACC, LIST, A_REG, B_REG, P_REG)                        \
  asm volatile(                                                           \
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, " P_REG ", 0;\n\t"             \
      "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" LIST    \
      "}, " A_REG ", " B_REG ", p, 1, 1;\n\t}"                             \
      : ACC                                                               \
      : "l"(a), "l"(b), "r"(accumulate))
__device__ __forceinline__ void wgmma(float (&d)[8], uint64_t a, uint64_t b,
                                      int accumulate) {
  WGMMA_SS(16, ACC8(0), LIST8, "%8", "%9", "%10");
}
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b,
                                      int accumulate) {
  WGMMA_SS(32, ACC16, LIST16, "%16", "%17", "%18");
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b,
                                      int accumulate) {
  WGMMA_SS(64, ACC32, LIST32, "%32", "%33", "%34");
}
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      int accumulate) {
  WGMMA_SS(128, ACC64, LIST64, "%64", "%65", "%66");
}
#undef WGMMA_SS
#undef ACC8
#undef ACC16
#undef ACC32
#undef ACC64
#undef LIST8
#undef LIST16
#undef LIST32
#undef LIST64

struct Args {
  const float* x;      // (B, Cin, T)
  const float* wf;     // split weights (resblock_weight_split_kernel)
  const float* bias;   // (Cout,)
  const float* res;    // (B, Cout, T) or null
  const float* acc;    // (B, Cout, T) or null
  float* out;          // (B, Cout, T)
  int Cin, Cout, T, K, dil, pad;
  int m_tiles;         // time tiles per item
  float slope, div;
  int mode, vec;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// raw input rows: the tile's columns from a 4-aligned start, a row stride
// ≡ 4 (mod 32) floats so that the split pass's reads of two rows 2p, 2p + 1
// hit distinct banks
__host__ __device__ inline int raw_stride(int xc) {
  const int r = round_up(xc + 3, 4);
  return r + ((36 - r % 32) % 32);
}
// steps a group (of 8 input channels) takes, and taps a step
__host__ __device__ inline int steps_per_group(int K) {
  return (K + MAX_TAPS - 1) / MAX_TAPS;
}

// BN output channels, WGS warpgroups of MS m-tiles of 64 time steps each
template <int BN, int WGS, int MS> struct Tile {
  static constexpr int BM = 64 * WGS * MS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NA = BN / 2;     // accumulators a thread, an m-tile
  // a ring stage: MAX_TAPS taps x (hi, lo) x BN rows x 8 floats; the raw
  // rows; the split tile: 4 planes of xc rows x 4 floats
  static size_t smem(int K, int dil) {
    const int xc = BM + (K - 1) * dil;
    return sizeof(float) * ((size_t)NS * MAX_TAPS * 2 * BN * 8 +
                            2 * 8 * (size_t)raw_stride(xc) + (size_t)xc * 16);
  }
};

// Wf[((g·K + j)·2 + h)·nt_all·64 + nt·64 + half·32 + r·4 + c]: h 0 the tf32
// hi part, 1 the lo part of W[8nt + r][8g + 2c + half][j]: one core matrix
// (8 output channels x 4 K slots) per (nt, half); zero past Cin or Cout.
__global__ void resblock_weight_split_kernel(const float* __restrict__ w,
                                             float* __restrict__ wf, int Cin,
                                             int Cout, int K, int nt_all,
                                             long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i & 3), r = static_cast<int>((i >> 2) & 7),
            half = static_cast<int>((i >> 5) & 1);
  const long long u = i >> 6;
  const int nt = static_cast<int>(u % nt_all);
  const long long gj = u / nt_all;
  const int j = static_cast<int>(gj % K);
  const int g = static_cast<int>(gj / K);
  const int co = nt * 8 + r, ci = g * 8 + 2 * c + half;
  const float v =
      co < Cout && ci < Cin ? w[((size_t)co * Cin + ci) * K + j] : 0.f;
  const float2 s = split_tf32(v);
  const size_t at = (size_t)gj * 2 * nt_all * 64 + (size_t)nt * 64 +
                    half * 32 + r * 4 + c;
  wf[at] = s.x;
  wf[at + (size_t)nt_all * 64] = s.y;
}

template <int BN, int WGS, int MS>
__global__ void __launch_bounds__(128 * WGS, 1)
resblock_conv_kernel(const Args a) {
  using Tl = Tile<BN, WGS, MS>;
  constexpr int BM = Tl::BM, THREADS = Tl::THREADS, NA = Tl::NA;
  extern __shared__ float4 smem4[];
  const int xc = BM + (a.K - 1) * a.dil;     // input time steps of a tile
  const int rs = raw_stride(xc);
  float* wring = reinterpret_cast<float*>(smem4);      // NS x 6·2·BN·8
  float* raw = wring + NS * MAX_TAPS * 2 * BN * 8;     // 2 x 8 x rs
  float* xs = raw + 2 * 8 * rs;                        // 4 x xc x 4

  const int b = blockIdx.x / a.m_tiles;
  const int t0 = (blockIdx.x - b * a.m_tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp in it
  const int g = lane >> 2, tq = lane & 3;

  const int spg = steps_per_group(a.K);
  const int tps = (a.K + spg - 1) / spg;     // taps a step
  const int steps = (a.Cin + 7) / 8 * spg;
  const int nt_all = (a.Cout + 7) / 8;
  const int ts = t0 - a.pad;                 // first input time step
  const int ta = ts >= 0 ? ts & ~3 : -((-ts + 3) & ~3);   // floor to 4
  const int off = ts - ta;
  const float* xb = a.x + (size_t)b * a.Cin * a.T;

  // cp.async the weights of step s, and the raw rows of its group when it
  // is the group's first step
  auto issue = [&](int s) {
    const int grp = s / spg, j0 = (s - grp * spg) * tps;
    const int nt_here = min(BN / 8, nt_all - n0 / 8);
    for (int u = 0; u < tps && j0 + u < a.K; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = wring + (((s % NS) * MAX_TAPS + u) * 2 + h) * BN * 8;
        const float* src =
            a.wf + ((size_t)((grp * a.K + j0 + u) * 2 + h) * nt_all + n0 / 8) *
                       64;
        for (int p = tid; p < BN * 2; p += THREADS) {   // 16-byte pieces
          const bool ok = p / 16 < nt_here;
          cp_async16(dst + p * 4, ok ? src + p * 4 : a.wf, ok);
        }
      }
    }
    if (j0 != 0) return;
    float* rdst = raw + (grp & 1) * 8 * rs;
    if (a.vec) {
      const int per_row = (off + xc + 3) / 4;
      for (int p = tid; p < 8 * per_row; p += THREADS) {
        const int r = p / per_row, q = p - r * per_row;
        const int ci = grp * 8 + r, t = ta + 4 * q;
        const bool ok = ci < a.Cin && t >= 0 && t < a.T;
        cp_async16(rdst + r * rs + 4 * q,
                   ok ? xb + (size_t)ci * a.T + t : a.x, ok);
      }
    } else {
      const int per_row = off + xc;
      for (int p = tid; p < 8 * per_row; p += THREADS) {
        const int r = p / per_row, q = p - r * per_row;
        const int ci = grp * 8 + r, t = ta + q;
        const bool ok = ci < a.Cin && t >= 0 && t < a.T;
        cp_async4(rdst + r * rs + q, ok ? xb + (size_t)ci * a.T + t : a.x,
                  ok);
      }
    }
  };

  float acc[MS][NA];
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[m][e] = 0.f;
  const uint32_t xs_addr = smem_addr(xs);
  const uint32_t plane = xc * 16;            // bytes a plane

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<AHEAD - 1>();
    fence_async_shared();
    __syncthreads();
    const int grp = s / spg, j0 = (s - grp * spg) * tps;
    if (j0 == 0) {
      // LeakyReLU in f32, then hi and lo of channels 2p (K slot p of half
      // 0) and 2p + 1 (slot p of half 1) of each time step into the planes
      const float* r0 = raw + (grp & 1) * 8 * rs + off;
      for (int e = tid; e < xc * 4; e += THREADS) {
        const int p = e & 3, t = e >> 2;
        float v0 = r0[2 * p * rs + t], v1 = r0[(2 * p + 1) * rs + t];
        v0 = v0 > 0.f ? v0 : v0 * a.slope;
        v1 = v1 > 0.f ? v1 : v1 * a.slope;
        const float2 s0 = split_tf32(v0), s1 = split_tf32(v1);
        xs[e] = s0.x;
        xs[xc * 4 + e] = s1.x;
        xs[2 * xc * 4 + e] = s0.y;
        xs[3 * xc * 4 + e] = s1.y;
      }
      fence_async_shared();
      __syncthreads();
    }
    if (s + AHEAD < steps) issue(s + AHEAD);
    cp_async_commit();

    const int nj = min(tps, a.K - j0);
    const uint32_t st = smem_addr(wring + (s % NS) * MAX_TAPS * 2 * BN * 8);
    float part[MS][NA];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < MAX_TAPS; ++u) {
      if (u < nj) {
        const uint64_t wh = desc(st + u * 2 * BN * 32, 128, 256);
        const uint64_t wl = desc(st + (u * 2 + 1) * BN * 32, 128, 256);
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          const uint32_t row = ((wg * MS + m) * 64 + (j0 + u) * a.dil) * 16;
          const uint64_t xh = desc(xs_addr + row, plane, 128);
          const uint64_t xl = desc(xs_addr + 2 * plane + row, plane, 128);
          wgmma(part[m], xl, wh, u > 0);
          wgmma(part[m], xh, wl, 1);
          wgmma(part[m], xh, wh, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      pin(part[m]);
#pragma unroll
      for (int e = 0; e < NA; ++e) acc[m][e] += part[m][e];
    }
  }

  // epilogue: acc[m][4j + e] at rows g (e < 2) and g + 8 of the warp's 16
  // in m-tile m, column 8j + 2tq + (e & 1)
#pragma unroll
  for (int m = 0; m < MS; ++m) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = n0 + 8 * j + 2 * tq + h;
        if (co >= a.Cout) continue;
        const float bias = a.bias[co];
        const size_t row = ((size_t)b * a.Cout + co) * a.T;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + (wg * MS + m) * 64 + wq * 16 + g + 8 * hh;
          if (t >= a.T) continue;
          float y = acc[m][4 * j + 2 * hh + h] + bias;
          if (a.mode >= 1) y = a.res[row + t] + y;
          if (a.mode == 2) {
            y = a.acc[row + t] + y;
            if (a.div != 1.f) y = __fdiv_rn(y, a.div);
          }
          a.out[row + t] = y;
        }
      }
    }
  }
}

// The tiles, as (BN, WGS, MS), and each one's relative throughput on a full
// grid (chip_smoke.py's sweep on an H100): BM x BN outputs a block.  Each
// is the choice of tile_for for some of HiFi-GAN V1's convs at the serving
// shapes: 0-2 at B 16 x 1000 mel frames, all five at B 1-16 x 128-1000
// frames (chip_smoke.py --resblock reports the choices)
#define RESBLOCK_TILES(X)      \
  X(0, 128, 3, 1, 1.00f)       \
  X(1, 64, 3, 2, 1.00f)        \
  X(2, 32, 3, 4, 1.00f)        \
  X(3, 32, 4, 2, 0.95f)        \
  X(4, 32, 2, 2, 0.75f)
constexpr int N_TILES = 5;

struct TileInfo { int bm, bn; float rate; };
#define TILE_INFO(i, bn, wgs, ms, rate) {64 * wgs * ms, bn, rate},
constexpr TileInfo TILES[N_TILES] = {RESBLOCK_TILES(TILE_INFO)};
#undef TILE_INFO

size_t tile_smem(int tile, int K, int dil) {
  switch (tile) {
#define TILE_SMEM(i, bn, wgs, ms, rate) \
  case i: return Tile<bn, wgs, ms>::smem(K, dil);
    RESBLOCK_TILES(TILE_SMEM)
#undef TILE_SMEM
  }
  return 0;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// The tile of least modelled time: whole waves of one block an SM, each
// block's padded outputs over its tile's rate, plus its input rows (the
// halo and the split pass), which short tiles pay most for.  A tile wider
// than the channels (rounded to 16) is taken only where no other fits.
int tile_for(int B, int Cin, int Cout, int T, int K, int dil) {
  const int sms = sm_count();
  int best = -1;
  double best_cost = 0.0;
  for (int i = 0; i < N_TILES; ++i) {
    const TileInfo& t = TILES[i];
    if (tile_smem(i, K, dil) > (size_t)MAX_SMEM) continue;
    const long long blocks = (long long)B * ((T + t.bm - 1) / t.bm) *
                             ((Cout + t.bn - 1) / t.bn);
    const long long waves = (blocks + sms - 1) / sms;
    const double per_block = ((double)t.bm * t.bn / t.rate +
                              4.0 * (t.bm + (K - 1) * dil)) *
                             round_up(Cin, 8) * K;
    const double cost =
        waves * per_block * (t.bn > round_up(Cout, 16) ? 1e3 : 1.0);
    if (best < 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN, int WGS, int MS>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  using Tl = Tile<BN, WGS, MS>;
  auto kernel = resblock_conv_kernel<BN, WGS, MS>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid(B * a.m_tiles, (a.Cout + BN - 1) / BN);
  kernel<<<grid, Tl::THREADS, Tl::smem(a.K, a.dil), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// floats of the split-weight scratch for a (Cout, Cin, K) weight
long long hifigan_resblock_wsplit_floats(int Cin, int Cout, int K) {
  return (long long)((Cin + 7) / 8) * K * ((Cout + 7) / 8) * 128;
}

int hifigan_resblock_tiles() { return N_TILES; }

// the tile a call of this shape takes; -1 when none fits shared memory
int hifigan_resblock_tile_for(int B, int Cin, int Cout, int T, int K,
                              int dil) {
  return tile_for(B, Cin, Cout, T, K, dil);
}

int hifigan_resblock_smem_bytes(int tile, int K, int dil) {
  return tile < 0 || tile >= N_TILES
             ? 0
             : static_cast<int>(tile_smem(tile, K, dil));
}

// x (B, Cin, T), w (Cout, Cin, K), bias (Cout,), res and acc (B, Cout, T)
// or null, out (B, Cout, T): contiguous f32; wsplit scratch of
// hifigan_resblock_wsplit_floats floats, 16-byte aligned.  mode 0: y; 1:
// res + y; 2: (acc + (res + y)) / div.  (K - 1)·dil even ("same" padding).
// tile -1 chooses by the shape (tile_for), else the tile of that index (for
// timing).  Returns the cudaError_t of the launches.
int hifigan_resblock_conv_forward(const void* x, const void* w,
                                  const void* bias, const void* res,
                                  const void* acc, void* out, void* wsplit,
                                  int B, int Cin, int Cout, int T, int K,
                                  int dil, float slope, float div, int mode,
                                  int tile, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (B < 0 || T < 0 || Cin < 1 || Cout < 1 || K < 1 || dil < 1 ||
      ((K - 1) * dil) % 2 != 0 || mode < 0 || mode > 2 ||
      (mode >= 1 && res == nullptr) || (mode == 2 && acc == nullptr) ||
      Cout > 65535 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile < 0) tile = tile_for(B, Cin, Cout, T, K, dil);
  if (tile < 0 || tile >= N_TILES ||
      tile_smem(tile, K, dil) > (size_t)MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt_all = (Cout + 7) / 8;
  const long long n = hifigan_resblock_wsplit_floats(Cin, Cout, K) / 2;
  resblock_weight_split_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(wsplit), Cin, Cout,
      K, nt_all, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bm = TILES[tile].bm;
  const long long blocks_x = (long long)B * ((T + bm - 1) / bm);
  if (blocks_x > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(wsplit),
               static_cast<const float*>(bias), static_cast<const float*>(res),
               static_cast<const float*>(acc), static_cast<float*>(out),
               Cin, Cout, T, K, dil, (K - 1) * dil / 2, (T + bm - 1) / bm,
               slope, div, mode,
               (T % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1
                                                                       : 0};
  switch (tile) {
#define TILE_LAUNCH(i, bn, wgs, ms, rate) \
  case i: err = launch<bn, wgs, ms>(a, B, s); break;
    RESBLOCK_TILES(TILE_LAUNCH)
#undef TILE_LAUNCH
  }
  return static_cast<int>(err);
}

const char* hifigan_resblock_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
