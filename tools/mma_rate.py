#!/usr/bin/env python3
"""Measure the rate of the instructions the top-k kernels are bound by, on
one card: ``mma.sync.m16n8k8`` TF32 and ``mma.sync.m16n8k32`` s8 (the
narrow and gathered scorers), each warp issuing independent MMAs on values held in
registers (no memory traffic), at 8 and 16 warps an SM; and 32-bit
``popc`` as the Hamming kernel issues it (``d += popc(a ^ b)``, eight
independent sums a thread, registers only), at 32 and 64 warps an SM.

    python3 tools/mma_rate.py

Prints one line per (instruction, warps an SM) with the rate in TFLOP/s
(TOP/s for s8, Gpopc/s for popc) beside the card's name and power limit,
then one JSON line. The kernels' CUDA source is written and built (with
``nvcc``, as ``kernels/build.py`` builds the port's) under
``build/mma_rate`` at run time. Run it from the repository root on a
machine with a card. ``popc_rate()`` is the popc measurement alone, for
``chip_smoke.py``'s Hamming bound.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_rate"
CHAINS = 8          # independent accumulators a warp
ITERS = 4096        # MMAs a chain

SOURCE = r"""
#include <cuda_runtime.h>
template <bool kTf32>
__global__ void rate(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  b[0] = 0x3f800000u ^ threadIdx.x;
  b[1] = b[0] + 7;
  float acc[CHAINS][4] = {};
  int iacc[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (kTf32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
              "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(iacc[c][0]), "+r"(iacc[c][1]), "+r"(iacc[c][2]),
              "+r"(iacc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e] + iacc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void popc_loop(int* out, int iters) {
  unsigned b[CHAINS];
  int d[CHAINS];
  for (int c = 0; c < CHAINS; ++c) {
    b[c] = 0x9e3779b9u * (threadIdx.x + 1) + c;
    d[c] = 0;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) d[c] += __popc(b[c] ^ it);
  }
  int s = 0;
  for (int c = 0; c < CHAINS; ++c) s += d[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int launch_popc(int blocks, int threads, int* out, int iters) {
  popc_loop<<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int launch(int tf32, int blocks, int threads, float* out,
                      int iters) {
  if (tf32)
    rate<true><<<blocks, threads>>>(out, iters);
  else
    rate<false><<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _library():
    """Build (once) and load the rate kernels."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "mma_rate.cu", OUT / "libmma_rate.so"
    text = f"#define CHAINS {CHAINS}\n" + SOURCE
    if not (lib.exists() and src.exists() and src.read_text() == text):
        src.write_text(text)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS[:-2], "-o",
                        str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _event_ms(launch) -> float:
    """Device ms of the second of two calls of ``launch``."""
    import torch
    for _ in range(2):                              # warm-up, then timed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if launch():
            sys.exit("mma_rate: launch failed")
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end)


def popc_rate(warps: int = 64):
    """32-bit popcounts a second the card issues at ``warps`` warps an SM
    (``d += popc(a ^ b)``), and the ms of the timed launch."""
    import torch
    fn = _library().launch_popc
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * warps // 8
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    ms = _event_ms(lambda: fn(blocks, 256, out.data_ptr(), ITERS))
    return blocks * 256 * CHAINS * ITERS / (ms * 1e-3), ms


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("mma_rate: no CUDA card")
    fn = _library().launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, tf32, flops in (("m16n8k8 tf32", 1, 2 * 16 * 8 * 8),
                              ("m16n8k32 s8", 0, 2 * 16 * 8 * 32)):
        for warps in (8, 16):
            out = torch.empty(sms * warps * 32, device="cuda")
            ms = _event_ms(lambda: fn(tf32, sms, warps * 32, out.data_ptr(),
                                      ITERS))
            mmas = sms * warps * CHAINS * ITERS
            rate = mmas * flops / (ms * 1e-3) / 1e12
            rows.append({"mma": name, "warps_per_sm": warps, "ms": ms,
                         "tera_ops_per_s": rate})
            print(f"{name}, {warps} warps an SM: {rate:.1f} T(FL)OP/s "
                  f"({ms:.4f} ms for {mmas} MMAs) on {smi}", flush=True)
    for warps in (32, 64):
        rate, ms = popc_rate(warps)
        rows.append({"mma": "popc b32", "warps_per_sm": warps, "ms": ms,
                     "giga_popc_per_s": rate / 1e9})
        print(f"popc b32, {warps} warps an SM: {rate / 1e9:.1f} Gpopc/s "
              f"({ms:.4f} ms; {rate / sms / 1e9:.2f} G a second an SM) on "
              f"{smi}", flush=True)
    print(json.dumps({"mma_rate": rows, "device": smi}))


if __name__ == "__main__":
    main()
