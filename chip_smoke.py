#!/usr/bin/env python3
"""Build and check the torch port on one CUDA card, then drive its
flagship preprocess chain once.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

1. device: a CUDA card must be present; prints its nvidia-smi name and
   power limit;
2. build: compiles ``yamimageprocessor_tpu_torch/csrc/*.cu`` with nvcc;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   bit for bit, at the chain's shapes and at awkward ones; then each
   kernel's and its plain version's device time at 8 x 2048^2 (CUDA
   events, median of 20 runs);
4. slice: the flagship chain (Gaussian 5x5 -> histogram equalization ->
   brightness/contrast) on an 8 x 2048^2 uint8 batch from
   ``np.random.default_rng(0)``, against the port's own CPU run (bit for
   bit) and the numpy golden on frame 0; the pipeline manager on one frame
   against the golden; every kernel's launch count must have risen during
   that run; then the chain's rate in MPix * steps / s over 20 batches
   back to back, and its device time per batch.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (8, 2048, 2048)
STEPS = 3  # Gaussian, histogram equalization, brightness/contrast
RUNS = 20
SLEEP_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz


def time_ms(fn, runs: int = RUNS, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` in ms, one CUDA event pair a run.

    Each run first queues a ~1 ms sleep on the stream, so the host has
    queued the start event, ``fn``'s launches and the end event before the
    device reaches them: the pair measures device time, not the host's
    launch latency."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, calls: int = RUNS, warmup: int = 3) -> float:
    """Time per call of ``calls`` consecutive ``fn()`` between one CUDA
    event pair, started from an idle device: what a loop over batches
    gets, the host's launch time included where it is the longer one."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def exact(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Max absolute difference, which must be 0, with equal shape and dtype."""

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{name}: got {tuple(got.shape)} {got.dtype}, want {tuple(want.shape)} {want.dtype}"
        )
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: max abs err {err}")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    print(f"card: {smi}")
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})"
    )
    return smi


def phase_build() -> None:
    from yamimageprocessor_tpu_torch import _build

    start = time.perf_counter()
    path, compile_s = _build.build()
    _build.library()
    print(f"build: nvcc {compile_s:.1f} s, ready in {time.perf_counter() - start:.1f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            print(f"  {line.strip()}")


def phase_kernels(dev) -> dict:
    from yamimageprocessor_tpu_torch import cuda_kernels as ck
    from yamimageprocessor_tpu_torch.ops.registry import get_impl, dyn_to_torch
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import (
        sep_filter_u8,
        sep_filter_u8_planes,
        sep_filter_u8_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def taps(ksize):
        _, dyn = get_impl("preprocessing.noise_reduction").split_params(
            {"method": "Gaussian", "ksize": ksize}
        )
        return dyn_to_torch(dyn, dev)["taps"]

    def unaligned(shape):
        # contiguous frames whose base is 1 byte past a 16-byte boundary
        n = int(np.prod(shape))
        return rand((n + 1,))[1:].view(shape)

    big = rand(SHAPE)
    odd = rand((3, 37, 1001))
    err = {"sepconv": 0, "histogram256": 0, "lut_apply": 0}

    for ksize in (3, 5, 13):
        t = taps(ksize)
        err["sepconv"] |= exact(f"sepconv k{ksize} {SHAPE}", sep_filter_u8(big, t, t), sep_filter_u8_plain(big, t, t))
    for ksize in (3, 5, 13, 33):
        t = taps(ksize)
        err["sepconv"] |= exact(f"sepconv k{ksize} odd", sep_filter_u8(odd, t, t), sep_filter_u8_plain(odd, t, t))
    small = rand((2, 5, 7))  # narrower than the halo: periodic reflection
    t = taps(13)
    err["sepconv"] |= exact("sepconv k13 (2,5,7)", sep_filter_u8(small, t, t), sep_filter_u8_plain(small, t, t))
    planes = rand((2, 64, 96, 3))
    t = taps(5)
    want = sep_filter_u8_plain(planes.permute(0, 3, 1, 2), t, t).permute(0, 2, 3, 1)
    err["sepconv"] |= exact("sepconv planes (2,64,96,3)", sep_filter_u8_planes(planes, t, t), want)
    print("kernels: sepconv bit-exact at k 3/5/13 on (8,2048,2048), k 3/5/13/33 on (3,37,1001), (2,5,7), planes")

    constant = torch.full((2, 1000 * 1000), 77, dtype=torch.uint8, device=dev)
    for name, frames in (
        ("(8,2048,2048)", big.view(SHAPE[0], -1)),
        ("constant", constant),
        ("(3,37,1001)", odd.view(3, -1)),
        ("unaligned", unaligned((3, 37037))),
    ):
        err["histogram256"] |= exact(
            f"histogram {name}", ck.histogram256_batch(frames), ck.histogram256_batch_plain(frames)
        )
    print("kernels: histogram256 bit-exact on (8,2048,2048), constant, (3,37,1001), unaligned")

    for name, frames in (
        ("(8,2048,2048)", big.view(SHAPE[0], -1)),
        ("(3,37,1001)", odd.view(3, -1)),
        ("unaligned", unaligned((3, 37037))),
    ):
        n = frames.shape[0]
        for kind, luts in (("per-frame", rand((n, 256))), ("shared", rand((256,)))):
            err["lut_apply"] |= exact(
                f"lut_apply {kind} {name}",
                ck.lut_apply_batch(frames, luts),
                ck.lut_apply_batch_plain(frames, luts),
            )
    print("kernels: lut_apply bit-exact, per-frame and shared tables, on (8,2048,2048), (3,37,1001), unaligned")

    t5 = taps(5)
    flat = big.view(SHAPE[0], -1)
    luts = rand((SHAPE[0], 256))
    pairs = {
        "sepconv": (lambda: sep_filter_u8(big, t5, t5), lambda: sep_filter_u8_plain(big, t5, t5)),
        "histogram256": (lambda: ck.histogram256_batch(flat), lambda: ck.histogram256_batch_plain(flat)),
        "lut_apply": (lambda: ck.lut_apply_batch(flat, luts), lambda: ck.lut_apply_batch_plain(flat, luts)),
    }
    times = {}
    for name, (kernel, plain) in pairs.items():
        # plain, kernel, kernel, plain: each number is the mean of two medians
        p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"time {name} at {SHAPE}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms")
    return {"err": err, "times": times}


def phase_slice(dev) -> dict:
    from yamimageprocessor_tpu_torch import cuda_kernels as ck
    from yamimageprocessor_tpu_torch.models.stages import (
        flagship_chain,
        flagship_forward,
        preprocess_steps,
    )
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    images = np.random.default_rng(0).integers(0, 256, SHAPE, dtype=np.uint8)
    x = torch.from_numpy(images).to(dev)
    manager = PipelineManager(preprocess_steps(), device=dev)
    counters = (sep_filter_u8, ck.histogram256_batch, ck.lut_apply_batch)

    for fn in counters:
        fn.launches = 0
    out = flagship_forward(x)
    frame_out = manager.apply(images[0])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"slice: launches during the main path {launches}")
    missing = [name for name, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    cpu_out = flagship_forward(torch.from_numpy(images))
    exact("flagship cuda vs cpu", out.cpu(), cpu_out)
    golden = manager.apply_host(images[0])
    exact("flagship frame 0 vs numpy golden", out[0].cpu(), torch.from_numpy(golden))
    exact("manager.apply vs numpy golden", torch.from_numpy(frame_out), torch.from_numpy(golden))
    print(f"slice: flagship {SHAPE} on cuda == cpu run, frame 0 == numpy golden; manager.apply == golden")

    fn, dyn = flagship_chain(SHAPE, dev)
    device_ms = time_ms(lambda: fn(x, dyn))
    loop_ms = back_to_back_ms(lambda: fn(x, dyn))
    rate = SHAPE[0] * SHAPE[1] * SHAPE[2] * STEPS / 1e6 / (loop_ms / 1e3)
    print(
        f"slice: flagship chain {loop_ms:.4f} ms per batch back to back "
        f"({RUNS} batches), {rate:.1f} MPix*steps/s; device time {device_ms:.4f} ms per batch"
    )
    return {"launches": launches}


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kern = phase_kernels(dev)
    sl = phase_slice(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    rows = [
        ("sepconv", "sep_filter_u8", "yamimageprocessor_tpu_torch/csrc/sepconv.cu",
         "yamimageprocessor_tpu/ops/sepconv_pallas.py:118"),
        ("histogram256", "histogram256_batch", "yamimageprocessor_tpu_torch/csrc/lut_hist.cu",
         "yamimageprocessor_tpu/pallas_kernels.py:585"),
        ("lut_apply", "lut_apply_batch", "yamimageprocessor_tpu_torch/csrc/lut_hist.cu",
         "yamimageprocessor_tpu/pallas_kernels.py:161"),
    ]
    report = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": sl["launches"][wrapper],
                "max_abs_err": kern["err"][name],
                "ms": kern["times"][name][0],
                "plain_ms": kern["times"][name][1],
            }
            for name, wrapper, source, replaces in rows
        ],
    }
    print(f"card: {smi}")
    print(json.dumps(report))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
