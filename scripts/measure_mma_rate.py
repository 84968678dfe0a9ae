"""Peak rates of the H100's warp-level matrix instructions and of float32
FMAs, as the port's kernels can issue them.

Run from the repository root on a card: ``python3 scripts/measure_mma_rate.py``.
It compiles a small CUDA source (written under ``build/mma_rate/``) with
nvcc for ``sm_90a``, in which every warp issues ``mma.sync`` on constant
fragments into 8 or 16 independent accumulators (TF32 m16n8k8 and BF16
m16n8k16, float32 accumulation), or every thread 16 independent FMA
chains, and times each with CUDA events at several grids. Prints one line
per measurement with the card's name and power limit. These rates bound
what a kernel built on ``mma.sync`` (K3's 3xTF32) or on float32 FMAs can
reach; ``wgmma`` is not measured.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from direct_data_driven_mpc_tpu_torch.ops import _kernels  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>

template <int NACC, bool BF16>
__global__ void mma_loop(float* out, int iters) {
  const unsigned a0 = 0x3f800000u ^ (threadIdx.x << 13), a1 = a0 ^ 0x2000,
                 a2 = a0 ^ 0x4000, a3 = a0 ^ 0x6000;
  const unsigned b0 = 0x3f000000u ^ (threadIdx.x << 14), b1 = b0 ^ 0x2000;
  float c[NACC][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      if (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int k = 0; k < NACC; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_loop(float* out, int iters) {
  const float x = threadIdx.x * 1e-3f;
  float c[16];
  for (int k = 0; k < 16; ++k) c[k] = k;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < 16; ++k) c[k] = fmaf(c[k], x, 0.999f);
  float s = 0.f;
  for (int k = 0; k < 16; ++k) s += c[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(int which, float* out, int blocks, int threads,
                      int iters) {
  switch (which) {
    case 0: mma_loop<8, false><<<blocks, threads>>>(out, iters); break;
    case 1: mma_loop<16, false><<<blocks, threads>>>(out, iters); break;
    case 2: mma_loop<8, true><<<blocks, threads>>>(out, iters); break;
    default: ffma_loop<<<blocks, threads>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}
"""

#: (selector, label, FLOP per warp per iteration, or per thread for FMAs)
CASES = [
    (0, "mma.sync TF32 m16n8k8, 8 chains per warp", 8 * 2 * 16 * 8 * 8),
    (1, "mma.sync TF32 m16n8k8, 16 chains per warp", 16 * 2 * 16 * 8 * 8),
    (2, "mma.sync BF16 m16n8k16, 8 chains per warp", 8 * 2 * 16 * 8 * 16),
    (3, "float32 FMA, 16 chains per thread", 16 * 2),
]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("measure_mma_rate: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_rate.cu").write_text(SOURCE)
    so = out_dir / "libmma_rate.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so),
                    str(out_dir / "mma_rate.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(4 * sms * 1024, device="cuda")
    iters = 4096
    for which, label, flop in CASES:
        for blocks, threads in ((sms, 256), (2 * sms, 256), (sms, 512),
                                (4 * sms, 256)):
            if lib.launch(which, out.data_ptr(), blocks, threads, 16):
                raise RuntimeError(f"launch failed: {label}")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.launch(which, out.data_ptr(), blocks, threads, iters)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            units = blocks * threads // (1 if which == 3 else 32)
            print(f"{label}, {blocks} blocks x {threads} threads: {ms:.3f} "
                  f"ms, {units * iters * flop / ms / 1e9:.1f} TFLOP/s "
                  f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
