#!/usr/bin/env python3
"""Measure the host-side rates a full-width checkpoint runs at, on one
card's machine: the free disk under ``build/``, a pageable 4 GiB copy from
the card to the host and back, and ``np.savez`` / ``np.load`` of two such
arrays (8 GiB) in ``build/io_rate`` (removed after).

    python3 tools/io_rate.py

Run it from the repository root on a machine with a card. It writes 8 GiB
to the disk: the card's machine caps what a call writes at 45 GiB.
"""
from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "io_rate"


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    gib = 4 * 2 ** 30
    print("disk free", shutil.disk_usage(OUT).free)
    x = torch.ones(gib // 4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = x.cpu()
    dt = time.perf_counter() - t0
    print("d2h pageable 4GiB", dt, gib / dt / 1e9, "GB/s")
    t0 = time.perf_counter()
    torch.from_numpy(h.numpy()).cuda()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print("h2d pageable 4GiB", dt, gib / dt / 1e9, "GB/s")
    a = h.numpy()
    path = OUT / "a.npz"
    t0 = time.perf_counter()
    np.savez(path, leaf_0=a, leaf_1=a)
    dt = time.perf_counter() - t0
    print("savez 8GiB", dt, 2 * gib / dt / 1e9, "GB/s")
    t0 = time.perf_counter()
    with np.load(path) as d:
        b, c = d["leaf_0"], d["leaf_1"]
    dt = time.perf_counter() - t0
    print("load 8GiB", dt, 2 * gib / dt / 1e9, "GB/s",
          np.array_equal(b, a) and np.array_equal(c, a))
    print("free after", shutil.disk_usage(OUT).free)
    print(torch.cuda.mem_get_info())
    shutil.rmtree(OUT)


if __name__ == "__main__":
    main()
