#!/usr/bin/env python3
"""Time the torch port's chamfer distance kernel on a CUDA card: the chunk
size on scenes with small and with large objects, and large batches.

    PYTHONPATH=. python3 scripts/time_torch_distance.py

Prints the card's name and power limit, then:

- for each number of rows a chunk (32, 64, 128, 256), the kernel's device
  time (median of 20 event pairs behind a queued sleep) and its fix-up
  rounds on the distance inputs of the segmentation benchmark's 12 scenes
  (``dense_scene(2048, seed=k)``, k = 0..11: disks of radius 40-51, 128
  apart) and of 3 scenes of large objects (disks of radius 160-239, 512
  apart), each through the segmentation chain's own steps; their mean, min
  and max, and the largest distance in the inputs (about how far a wrong
  speculative row can reach below a chunk's first row);
- the default chunk size's device time on batches of 132 and 528 frames of
  2048^2 (the 12 scene openings, repeated), with every frame held bit for
  bit against the same frame walked alone, and a SHA-256 of the 12 frames'
  distances.

Against the package of an older checkout, whose ``distance_transform``
takes no ``rows_per_chunk`` (``cd <checkout> && PYTHONPATH=. python3
<this script>``), it prints only the batch lines: two runs whose digests
agree computed the same distances.
"""
from __future__ import annotations

import hashlib
import inspect
import statistics
import subprocess

import numpy as np
import torch

SIDE = 2048
ROWS = (32, 64, 128, 256)
SCENES = 12
LARGE_SCENES = 3
BATCHES = (132, 528)


def large_scene(side: int, seed: int) -> np.ndarray:
    """``dense_scene`` with disks of radius 160-239, 512 apart."""

    rng = np.random.default_rng(seed)
    img = np.zeros((side, side), np.uint8)
    pitch = 512
    yy, xx = np.ogrid[:side, :side]
    for cy in range(pitch // 2, side, pitch):
        for cx in range(pitch // 2, side, pitch):
            r = 160 + int(rng.integers(0, 80))
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 170 + int(rng.integers(0, 60))
    noise = rng.integers(-12, 13, img.shape, dtype=np.int16)
    return (img.astype(np.int16) + noise).clip(0, 255).astype(np.uint8)


def openings(scenes, dev):
    """The segmentation chain's distance inputs for ``(H, W)`` scenes."""

    from chip_smoke import _closed_mask, _watershed_inputs

    return [_watershed_inputs(_closed_mask(torch.from_numpy(s).to(dev)[None]))[0] for s in scenes]


def sweep(name: str, masks_list) -> None:
    from chip_smoke import time_ms
    from yamimageprocessor_tpu_torch.ops.distance import distance_transform

    peak = max(float(distance_transform(masks).max()) for masks in masks_list)
    print(f"{len(masks_list)} {name} {SIDE}^2: largest distance {peak:.4f}")
    for rows in ROWS:
        times, rounds = [], []
        for masks in masks_list:
            times.append(time_ms(lambda: distance_transform(masks, rows_per_chunk=rows)))
            rounds.append(distance_transform.last_rounds.tolist())
        print(f"{len(masks_list)} {name} {SIDE}^2, {rows} rows a chunk: mean {statistics.mean(times):.4f} ms, "
              f"min {min(times):.4f}, max {max(times):.4f}; fix-up rounds (forward, backward) from "
              f"{min(rounds)} to {max(rounds)}", flush=True)


def batches(frames) -> None:
    from chip_smoke import exact, time_ms
    from yamimageprocessor_tpu_torch.ops.distance import distance_transform

    alone = [distance_transform(f) for f in frames]
    digest = hashlib.sha256(b"".join(a.cpu().numpy().tobytes() for a in alone)).hexdigest()
    print(f"sha256 of the {len(frames)} scene openings' distances, each frame alone: {digest}", flush=True)
    for n in BATCHES:
        batch = torch.cat([frames[i % len(frames)] for i in range(n)])
        out = distance_transform(batch)
        for i in range(n):
            exact(f"batch of {n}, frame {i}", out[i : i + 1], alone[i % len(frames)])
        del out
        ms = time_ms(lambda: distance_transform(batch), runs=10)
        print(f"batch of {n} scene openings {SIDE}^2 (each bit-exact against the frame alone): "
              f"{ms:.4f} ms = {ms / n:.4f} ms a frame", flush=True)
        del batch
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_distance: no CUDA device")

    from chip_smoke import dense_scene
    from yamimageprocessor_tpu_torch.ops.distance import distance_transform

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    scene_openings = openings([dense_scene(SIDE, seed=k) for k in range(SCENES)], dev)
    if "rows_per_chunk" in inspect.signature(distance_transform).parameters:
        sweep("scene openings", scene_openings)
        sweep("large-object scene openings", openings([large_scene(SIDE, k) for k in range(LARGE_SCENES)], dev))
    batches(scene_openings)


if __name__ == "__main__":
    main()
