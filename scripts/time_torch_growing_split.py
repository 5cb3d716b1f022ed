"""Split region growing's device time by launch on the card.

Builds a checkout's ``csrc/growing.cu`` once per prefix of its launches
(every launch after the k-th replaced by a no-op; one nvcc each, in
parallel) into ``build/growing_split/``, loads each library in turn in
place of the port's, and times that checkout's
``ops/growing.py:region_grow`` with CUDA event pairs (``chip_smoke.py``'s
``time_ms``) on two cases: the 8 gray 2048^2 frames of the denoise batch
at seed (50, 50), tol 10 (uniform noise: many small components), and 8
copies of the 2048^2 dense scene at seed (0, 0), tol 12 (its background:
one component over most of each frame).  Launch k's time is prefix k less
prefix k - 1.  The profiler's split of the full build (``chip_smoke.py``'s
``launch_split``) is printed beside it::

    PYTHONPATH=. python3 scripts/time_torch_growing_split.py [ROOT ...]

Each ROOT (default: this checkout) is a tree unpacked with ``git archive``
into a gitignored directory; each runs in a process of its own.  Only the
full build's outputs are the kernel's; the prefixes are timing probes.
Needs a card and nvcc (as ``_build.py`` finds it).
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "build" / "growing_split"
ENTRY = 'extern "C" int yam_region_grow_u8'
LAUNCH = re.compile(r"\b\w+<<<.*?>>>\(.*?\);", re.S)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variants(source: str) -> list:
    """The source with its entry point's launches after the k-th replaced
    by ``(void)0;``, for k = 1 .. the number of launches."""

    head, entry, body = source.partition(ENTRY)
    if not entry:
        raise SystemExit(f"csrc/growing.cu has no {ENTRY}")
    count = len(LAUNCH.findall(body))
    out = []
    for keep in range(1, count + 1):
        seen = iter(range(count))
        out.append(head + entry + LAUNCH.sub(lambda m: m.group(0) if next(seen) < keep else "(void)0;", body))
    return out


def build(root: Path, tag: str) -> list:
    """One shared library a prefix, built in parallel; their paths."""

    sys.path.insert(0, str(root))
    from yamimageprocessor_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for k, text in enumerate(variants((root / "yamimageprocessor_tpu_torch/csrc/growing.cu").read_text()), 1):
        src, lib = OUT / f"{tag}_{k}.cu", OUT / f"{tag}_{k}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {lib.name}:\n{log}")
        for line in log.splitlines():
            if "ptxas info" in line and "Used" in line:
                print(f"  {lib.name}: {line.strip()}")
    return [lib for lib, _ in jobs]


def one(root: Path) -> None:
    import torch

    cs = _chip_smoke()
    smi = cs.phase_device()
    libs = build(root, root.name or "tree")
    from yamimageprocessor_tpu_torch import _build
    from yamimageprocessor_tpu_torch.ops import growing as G
    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray

    dev = torch.device("cuda", 0)
    gray = bgr_to_gray(torch.from_numpy(cs.denoise_frames()).to(dev)).contiguous()
    scene = torch.from_numpy(cs.dense_scene(cs.SEG_SIDE)).to(dev)[None].repeat(gray.shape[0], 1, 1).contiguous()

    def scalars(*values):
        return [torch.tensor(v, dtype=torch.int32, device=dev) for v in values]

    cases = {"noise (50, 50) tol 10": (gray, scalars(50, 50, 10)),
             "background (0, 0) tol 12": (scene, scalars(0, 0, 12))}
    result = {"package": G.__file__, "card": smi, "launches": len(libs), "ms": {}, "split": {}, "profiler": {}}
    for lib_path in libs:
        lib = ctypes.CDLL(str(lib_path))
        lib.yam_region_grow_u8.argtypes = _build.SIGNATURES["yam_region_grow_u8"]
        lib.yam_region_grow_u8.restype = ctypes.c_int
        _build._lib = lib
        for key, (frames, (sx, sy, tol)) in cases.items():
            result["ms"].setdefault(key, []).append(cs.time_ms(lambda: G.region_grow(frames, sx, sy, tol)))
            if lib_path == libs[-1]:
                result["profiler"][key] = cs.launch_split(lambda: G.region_grow(frames, sx, sy, tol))
    for key, prefix in result["ms"].items():
        result["split"][key] = [prefix[0]] + [b - a for a, b in zip(prefix, prefix[1:])]
        print(f"{key}: total {prefix[-1]:.4f} ms, by launch " + ", ".join(f"{v:.4f}" for v in result["split"][key]))
    print(json.dumps(result))


def main(argv) -> None:
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve())
        return
    for root in argv or [str(HERE)]:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True, text=True, timeout=900)
        print(f"== {root}")
        print(out.stdout.strip())
        if out.returncode:
            print(out.stderr[-4000:])
            raise SystemExit(out.returncode)


if __name__ == "__main__":
    main(sys.argv[1:])
