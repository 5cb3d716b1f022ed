"""Split the HOG cells kernel's device time by phase on the card.

Builds ``yamimageprocessor_tpu_torch/csrc/hog.cu`` four times into
``build/hog_phases/`` (one nvcc each, in parallel): as it is, and with
phases replaced by trivial ones (the staging skipped, the pixels' magnitude
and bin replaced by a copy of the staged value, the sums by one add), then
times each on the texture phase's 32 gray 1024^2 scenes (``chip_smoke.py``'s
inputs) at 9 bins 8x8 and 32 bins 2x2, and prints each build's time, the
phase each difference isolates, and the SASS instruction count of the pixel
loop and of the whole main instance (``cuobjdump``)::

    PYTHONPATH=. python3 scripts/time_torch_hog_phases.py

Only the unchanged build's outputs are the plain version's; the others are
timing probes.  Needs a card and nvcc (as ``_build.py`` finds it).
"""
from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from yamimageprocessor_tpu_torch import _build  # noqa: E402
from yamimageprocessor_tpu_torch.ops import hogf as HG  # noqa: E402
from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray  # noqa: E402

OUT = ROOT / "build" / "hog_phases"
STAGE = "  stage(img, tile, in_pitch, h, w, y0, x0, rows, cols);\n"
PIXEL = ("    pixel(tile + (k.row + 1) * in_pitch + k.col + 1, in_pitch, h, w, y0 + k.row, x0 + k.col, p.nb, "
         "p.recip_bw, m,\n          bin);\n")
SUM = "    const float sum = cell_sum<ORDER, SIDE>(mag + at, bins + at, tile_cols, b, p);\n"
#: build name -> replaced phases
BUILDS = {"kernel": (), "no sums": ("sum",), "staging only": ("pixel", "sum"), "nothing": ("stage", "pixel", "sum")}


def variant(source: str, skip) -> str:
    for anchor in (STAGE, PIXEL, SUM):
        if anchor not in source:
            raise SystemExit(f"csrc/hog.cu changed: update this script's anchors ({anchor.strip()[:40]}...)")
    if "stage" in skip:
        source = source.replace(STAGE, "")
    if "pixel" in skip:
        source = source.replace(PIXEL, "    m = tile[(k.row + 1) * in_pitch + k.col + 1];\n"
                                       "    bin = static_cast<int>(m) & 7;\n")
    if "sum" in skip:
        source = source.replace(SUM, "    const float sum = mag[at] + bins[at + b];\n")
    return source


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_hog_phases: no CUDA device")
    smi = cs.phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "hog.cu").read_text()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    for name, skip in BUILDS.items():
        stem = name.replace(" ", "_")
        (OUT / f"{stem}.cu").write_text(variant(source, skip))
        cmd = [_build._nvcc(), *flags, "-shared", "-o", str(OUT / f"{stem}.so"), str(OUT / f"{stem}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
    dev = torch.device("cuda", 0)
    frames = np.stack([cs.extraction_frame(seed=s) for s in range(cs.TEXTURE_FRAMES)])
    gray = bgr_to_gray(torch.from_numpy(frames).to(dev)).contiguous()
    n, h, w = gray.shape
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    times = {}
    for name in BUILDS:
        fn = ctypes.CDLL(str(OUT / f"{name.replace(' ', '_')}.so")).yam_hog_cells
        fn.argtypes = (ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, f32, f32, i32, ptr)
        fn.restype = i32
        for nb, side in ((9, 8), (32, 2)):
            out = torch.empty((n, h // side, w // side, nb), dtype=torch.float32, device=dev)
            order = {"windows": 0, "lanes": 1, "vector": 2}[HG.cell_order(side, nb)]

            def call(fn=fn, out=out, nb=nb, side=side, order=order):
                code = fn(gray.data_ptr(), out.data_ptr(), n, h, w, nb, side, order, 0, 0, 0, 0,
                          int(HG.window_pairs(nb, w // side)), HG.bin_reciprocal(nb), HG.cell_reciprocal(side), 0,
                          torch.cuda.current_stream(dev).cuda_stream)
                if code:
                    raise RuntimeError(f"yam_hog_cells ({name}): CUDA error {code}")

            call()
            torch.cuda.synchronize()
            if name == "kernel" and not torch.equal(out, HG.hog_cells_plain(gray, nb, side)):
                raise AssertionError(f"the kernel differs from hog_cells_plain at {nb} bins {side}x{side}")
            times[f"{name} {nb}x{side}"] = cs.time_ms(call)
    for shape in ("9x8", "32x2"):
        t = {name: times[f"{name} {shape}"] for name in BUILDS}
        print(f"hog_cells {shape} on {tuple(gray.shape)}: kernel {t['kernel']:.4f} ms; staging {t['staging only'] - t['nothing']:.4f}, "
              f"pixels {t['no sums'] - t['staging only']:.4f}, sums {t['kernel'] - t['no sums']:.4f}, "
              f"the rest (the trivial loops' shared-memory traffic, the output, the launch) {t['nothing']:.4f}")
    sass = subprocess.run(["cuobjdump", "-sass", str(OUT / "kernel.so")], capture_output=True, text=True).stdout
    counts = {}
    for block in re.split(r"\n\s+Function : ", sass):
        if "hog_cells_kernelILi1ELi8EhE" not in block.split("\n", 1)[0]:
            continue
        ops = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        syncs = [int(at, 16) for at, op in ops if op.startswith("BAR")]
        # the pixel loop lies between the first two barriers (stage | pixels | sums)
        pixel = [op for at, op in ops if syncs[0] < int(at, 16) < syncs[1]]
        counts = {"main instance": len(ops), "static, between the barriers (the pixel loop)": len(pixel),
                  "pixel loop by opcode": collections.Counter(op.split(".")[0] for op in pixel).most_common(12)}
    print(f"SASS instructions (lanes, 8x8, uint8): {json.dumps(counts)}")
    print(f"card: {smi}")
    print(json.dumps({"times": times, "sass": counts}))


if __name__ == "__main__":
    main()
