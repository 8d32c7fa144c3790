#!/usr/bin/env python3
"""Time versions of the top-k kernel source against each other on one card.

    python3 tools/topk_ab.py A.cu B.cu [...]

Each argument is a version of ``src/repro_torch/csrc/topk_scores.cu`` (for
example the parent commit's, written out with ``git show``). Every version
is built with the port's nvcc flags into ``build/ab/``, then timed with CUDA
events at the evaluation path's shapes (Q = 128, N = 524288, D = 2048),
the versions in rotating order, six runs of eight launches each; the script
prints each version's median and range in ms and whether all versions gave
equal results. A version without the ``topk_int8_partial`` entry point is
taken to be one whose lists stop at k = 32, and is timed only at f32
k <= 32. Run it from the repository root on a machine with a card.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "ab"
PARTIAL = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
MERGE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
CASES = (("f32", 3), ("f32", 32), ("f32", 40), ("int8", 10), ("int8", 40),
         ("int8", 80))


def build_all(sources):
    """Build every source in parallel: {label: loaded library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        label = Path(src).stem
        so = OUT / f"lib{label}.so"
        procs[label] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {label}:\n{log}")
        for line in log.splitlines():
            if "Used" in line:
                print(label, line.strip())
        lib = ctypes.CDLL(str(so))
        for fn, types in (("topk_partial", PARTIAL),
                          ("topk_int8_partial", PARTIAL),
                          ("topk_merge", MERGE)):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def main(sources) -> None:
    if not torch.cuda.is_available():
        sys.exit("topk_ab: no CUDA card")
    libs = build_all(sources)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator().manual_seed(11)
    inputs = {
        "f32": (torch.randn(128, 2048, generator=g).cuda(),
                torch.randn(524288, 2048, generator=g).cuda()),
        "int8": (torch.randint(-127, 128, (128, 2048), generator=g,
                               dtype=torch.int8).cuda(),
                 torch.randint(-127, 128, (524288, 2048), generator=g,
                               dtype=torch.int8).cuda()),
    }
    stream = torch.cuda.current_stream().cuda_stream
    for kind, k in CASES:
        q, c = inputs[kind]
        nq, d = q.shape
        n = c.shape[0]
        fn = "topk_partial" if kind == "f32" else "topk_int8_partial"
        use = [lb for lb, lib in libs.items()
               if hasattr(lib, "topk_int8_partial")
               or (kind == "f32" and k <= 32)]
        n_tiles, q_tiles = -(-n // 128), -(-nq // 32)
        n_splits = max(1, min(n_tiles, -(-528 // q_tiles)))
        per_split = -(-n_tiles // n_splits)
        n_splits = -(-n_tiles // per_split)
        width = n_splits * k
        part_s = torch.empty(nq, width, device="cuda")
        part_i = torch.empty(nq, width, dtype=torch.int32, device="cuda")
        out_s = torch.empty(nq, k, device="cuda")
        out_i = torch.empty(nq, k, dtype=torch.int32, device="cuda")

        def run(lib):
            rc = getattr(lib, fn)(q.data_ptr(), c.data_ptr(),
                                  part_s.data_ptr(), part_i.data_ptr(), nq,
                                  n, d, k, per_split, n_splits, 1, stream)
            rc |= lib.topk_merge(part_s.data_ptr(), part_i.data_ptr(),
                                 out_s.data_ptr(), out_i.data_ptr(), nq,
                                 width, k, stream)
            if rc:
                sys.exit(f"topk_ab: launch failed ({rc})")

        def ms(lib, iters=8):
            run(lib)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                run(lib)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        times = {lb: [] for lb in use}
        for r in range(3):
            order = use if r % 2 == 0 else use[::-1]
            for lb in order + order[::-1]:
                times[lb].append(ms(libs[lb]))
        outs = []
        for lb in use:
            run(libs[lb])
            torch.cuda.synchronize()
            outs.append((out_s.clone(), out_i.clone()))
        equal = all(torch.equal(outs[0][0], s) and torch.equal(outs[0][1], i)
                    for s, i in outs)
        summary = ", ".join(
            f"{lb} {statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
            for lb, v in times.items())
        print(f"{kind} k={k}: {summary} ms; equal={equal}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
