#!/usr/bin/env python3
"""The rate of the instruction the alignment kernel is built on.

``csrc/alignment_attention.cu`` runs its 3xTF32 products as
``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``.  This script times
that instruction alone on the card: every warp issues ``CHAINS`` independent
accumulator chains in a loop, at 4, 8 and 16 warps per SM on every SM, and
reports TFLOP/s and the share of the card's 495 TFLOP/s TF32 peak.  One
chain at 4 warps per SM shows the instruction's latency.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 profile_alignment.py

It prints the card's name and power limit, then one JSON line per
configuration.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
TF32_FLOPS = 495e12       # H100 SXM, dense (NVIDIA data sheet)
ITERS = 4096

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  float c[CHAINS][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = 3 * threadIdx.x, b1 = 5 * threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int i = 0; i < CHAINS; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop_launch(int chains, int warps, int blocks, int iters,
                               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (chains == 1) mma_loop<1><<<blocks, 32 * warps, 0, s>>>(o, iters);
  else if (chains == 4) mma_loop<4><<<blocks, 32 * warps, 0, s>>>(o, iters);
  else mma_loop<8><<<blocks, 32 * warps, 0, s>>>(o, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_alignment: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    out_dir = os.path.join(REPO, "build", "profile_alignment")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, n) for n in ("mma.cu", "mma.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.mma_loop_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.mma_loop_launch.restype = ctypes.c_int
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    for chains in (1, 4, 8):
        for warps in (4, 8, 16):
            def run():
                status = lib.mma_loop_launch(
                    chains, warps, sms, ITERS, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"launch failed: {status}")
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            flops = 2 * 16 * 8 * 8 * sms * warps * ITERS * chains
            tflops = flops / ms / 1e9
            print(json.dumps({"chains": chains, "warps_per_sm": warps,
                              "ms": ms, "tflops": tflops,
                              "share_of_tf32_peak": tflops * 1e12
                              / TF32_FLOPS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
