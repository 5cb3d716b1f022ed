#!/usr/bin/env python3
"""Where the torch port's segmentation chain spends its time on a CUDA card.

    PYTHONPATH=. python3 scripts/profile_torch_segmentation.py

Runs the segmentation chain (Otsu -> open -> close -> marker watershed) on
``chip_smoke.dense_scene(2048)``, three frames, under ``torch.profiler`` and prints: the
card's name and power limit; the wall time per frame (host clock around
work that ends in a synchronize); the device time per frame summed over
all kernels, and its share of the wall time; then the kernels by device
time, grouped by name.  The chain runs twice first, untimed, to build and
warm up.  A last line splits the device time between the port's kernels
(CC's three launches summed, and each apart) and everything else; the
parts add up to the device time.
"""
from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIDE = 2048
FRAMES = 3
#: substrings of the port's kernel names, by kernel
GROUPS = {
    "flood_kernel": "flood",
    "chamfer_kernel": "distance",
    "cc_local": "cc",
    "cc_border": "cc",
    "cc_compress": "cc",
    "histogram256_kernel": "histogram256",
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_segmentation: no CUDA device")

    from chip_smoke import dense_scene
    from yamimageprocessor_tpu_torch.models.stages import segmentation_chain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}")
    x = torch.from_numpy(dense_scene(SIDE)).cuda()[None]
    fn, dyn = segmentation_chain(x.shape, x.device)
    for _ in range(2):
        fn(x, dyn)
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(FRAMES):
            fn(x, dyn)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) / FRAMES

    per_kernel = defaultdict(lambda: [0.0, 0])
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[event.name][0] += event.device_time_total
            per_kernel[event.name][1] += 1
    device_us = sum(t for t, _ in per_kernel.values()) / FRAMES
    launches = sum(c for _, c in per_kernel.values()) / FRAMES
    print(
        f"segmentation {SIDE}^2: wall {wall * 1e3:.4f} ms per frame (profiler on), device "
        f"{device_us / 1e3:.4f} ms per frame in {launches:.0f} kernels "
        f"({100 * device_us / 1e3 / (wall * 1e3):.1f}% of the wall)"
    )
    if not per_kernel:
        print("the profiler saw no device activity")
    for name, (total, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {total / FRAMES / 1e3:9.4f} ms {count / FRAMES:7.1f} x  {name[:110]}")
    split = defaultdict(float)
    cc_parts = defaultdict(float)
    for name, (total, _) in per_kernel.items():
        key = next((k for k in GROUPS if k in name), None)
        split[GROUPS[key] if key else "other"] += total / FRAMES / 1e3
        if key and GROUPS[key] == "cc":
            cc_parts[key] += total / FRAMES / 1e3
    parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(cc_parts.items()))
    print("by kernel, ms per frame: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
          + f" (cc: {parts}); sum {sum(split.values()):.4f}")


if __name__ == "__main__":
    main()
