"""Split the Canny candidate and adaptive threshold kernels' device time by
phase on the card.

Builds a checkout's ``csrc/edges.cu`` and ``csrc/adaptive.cu`` once per
variant into ``build/edges_phases/`` (one nvcc each, in parallel): as they
are, with phases replaced by trivial ones (the suppression by a store of
the magnitude, the y-passes by a read of the x-pass, the x-passes by a
copy of the input, the staging skipped), and, for the register-window
kernels, with other strips, row blocks, register caps or rows in flight.
Then it times each variant with CUDA event pairs (``chip_smoke.py``'s
``time_ms``) through that
checkout's wrappers on the denoise batch's 8 gray 2048^2 frames: Canny's
candidates at apertures 3, 5 and 7 (low 50, high 150), the adaptive
threshold at block sizes 3, 11, 13 and 33 (C 2; on a checkout with window
instances for them, the tile kernel at 35).  A phase's time is the
difference of two variants' times.  Each kernel's design has its own
anchors; a checkout lacking a design's anchors skips it::

    PYTHONPATH=. python3 scripts/time_torch_edges_phases.py [--only DESIGN,...] [ROOT ...]

Each ROOT (default: this checkout) is a tree unpacked with ``git archive``
into a gitignored directory; each runs in a process of its own.  The
variants that replace no phase (the unchanged one, other strips, row
blocks or register caps) are checked against the plain version; the others
are timing probes.  Needs a card and nvcc (as
``_build.py`` finds it).
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
OUT = HERE / "build" / "edges_phases"
APERTURES = (3, 5, 7)
BLOCK_SIZES = (3, 11, 13, 33)

# The tile kernels of csrc/edges.cu (canny_kernel) and csrc/adaptive.cu
# (adaptive_kernel): (old text, new text) of each phase.
_TILE_CANNY = {
    "stage": ("  stage_window<REPLICATE>(frame, h, w, y0, x0, ih, iw, r, s_in);\n", ""),
    "x": ("  x_pass_rows(ih, iw, ow, k, taps, s_in, s_xa, s_xb);\n", ""),
    "y": ("    y_passes(s_xa, s_xb, RING, row, col, k, taps, gx, gy);\n",
          "    gx = static_cast<int>(s_xa[i]);\n    gy = static_cast<int>(s_xb[i]);\n"),
    "nms": ("    const bool nms = m > low && (horiz || vert || diag);\n"
            "    plane[static_cast<long long>(y0 + row) * w + x0 + col] = nms ? (m > high ? 2 : 1) : 0;\n",
            "    plane[static_cast<long long>(y0 + row) * w + x0 + col] = static_cast<uint8_t>(m);\n"),
}
_TILE_ADAPTIVE = {
    "stage": ("      s_in[i] = static_cast<float>(__ldg(frame + static_cast<long long>(y) * w + x));\n", ""),
    "x": ("      s_x[(first + row) * TILE_COLS + col] = fma_chain(s_taps, s_in + row * iw + col, 1, k);\n",
          "      s_x[(first + row) * TILE_COLS + col] = s_in[row * iw + col];\n"),
    "y": ("    const float mean = rintf(fma_chain(s_taps, s_x + row * TILE_COLS + col, TILE_COLS, k));\n",
          "    const float mean = rintf(s_x[(row + r) * TILE_COLS + col]);\n"),
}
# The register-window kernels (canny_window, adaptive_window): their phases,
# and other strips (S columns a lane) and row blocks (B rows) to compare.
_WINDOW_CANNY = {
    "3 blocks": ("constexpr int MIN_WINDOW_BLOCKS = 4;", "constexpr int MIN_WINDOW_BLOCKS = 3;"),
    "5 blocks": ("constexpr int MIN_WINDOW_BLOCKS = 4;", "constexpr int MIN_WINDOW_BLOCKS = 5;"),
    "ahead 2": ("constexpr int AHEAD = 4;", "constexpr int AHEAD = 2;"),
    "no cap": ("__launch_bounds__(GRAD_THREADS, MIN_WINDOW_BLOCKS)\n    canny_window(",
               "__launch_bounds__(GRAD_THREADS)\n    canny_window("),
    "blocks of 4": ("constexpr int CANNY_ROWS = 2;", "constexpr int CANNY_ROWS = 4;"),
    "5 in strips of 8": ("try_canny<Smooth5, Deriv5, 4>(", "try_canny<Smooth5, Deriv5, 8>("),
    "7 in strips of 8": ("try_canny<Smooth7, Deriv7, 4>(", "try_canny<Smooth7, Deriv7, 8>("),
    "nms": ("      o[k] = suppress(c[k + 1], (d >> (4 * k)) & 15u, u[k], u[k + 1], u[k + 2], c[k], c[k + 2], b[k], "
            "b[k + 1],\n                      b[k + 2], low, high);\n",
            "      o[k] = static_cast<unsigned>(c[k + 1] + u[k] + b[k + 2] + c[k + 2]) + ((d >> (4 * k)) & 15u);\n"),
    "y": ("        sa += static_cast<unsigned>(T0::at(t)) * row_a(t)[c];\n"
          "        sb += static_cast<unsigned>(T1::at(t)) * row_b(t)[c];\n",
          "        if (t == 0) sa = row_a(0)[c], sb = row_b(0)[c];\n"),
    "x": ("      a += static_cast<unsigned>(T1::at(t)) * static_cast<unsigned>(v[c + t]);\n"
          "      b += static_cast<unsigned>(T0::at(t)) * static_cast<unsigned>(v[c + t]);\n",
          "      if (t == 0) a = static_cast<unsigned>(v[c]), b = static_cast<unsigned>(v[c + K - 1]);\n"),
}
_WINDOW_ADAPTIVE = {
    "4 blocks": ("constexpr int MIN_WINDOW_BLOCKS = 5;", "constexpr int MIN_WINDOW_BLOCKS = 4;"),
    "6 blocks": ("constexpr int MIN_WINDOW_BLOCKS = 5;", "constexpr int MIN_WINDOW_BLOCKS = 6;"),
    "ahead 2": ("constexpr int AHEAD = 4;      // rows a warp has in flight beyond the block it computes",
                "constexpr int AHEAD = 2;      // rows a warp has in flight beyond the block it computes"),
    "11 in blocks of 2": ("launch_window<11, 4, 4>", "launch_window<11, 4, 2>"),
    "13 in blocks of 2": ("launch_window<13, 4, 4>", "launch_window<13, 4, 2>"),
    "3 in blocks of 2": ("launch_window<3, 8, 4>", "launch_window<3, 8, 2>"),
    "no cap": ("__launch_bounds__(WIN_THREADS, MIN_WINDOW_BLOCKS)\n    adaptive_window(",
               "__launch_bounds__(WIN_THREADS)\n    adaptive_window("),
    "3 in blocks of 8": ("launch_window<3, 8, 4>", "launch_window<3, 8, 8>"),
    "11 in blocks of 8": ("launch_window<11, 4, 4>", "launch_window<11, 4, 8>"),
    "13 in blocks of 8": ("launch_window<13, 4, 4>", "launch_window<13, 4, 8>"),
    "33 in blocks of 4": ("launch_window<33, 2, 2>", "launch_window<33, 2, 4>"),
    "11 in strips of 8": ("launch_window<11, 4, 4>", "launch_window<11, 8, 2>"),
    "y": ("        float acc = __fmaf_rn(tk[0], xr[b][c], __fmul_rn(tk[1], xr[b + 1][c]));\n"
          "#pragma unroll\n"
          "        for (int t = 2; t < K; ++t) acc = __fmaf_rn(tk[t], xr[b + t][c], acc);\n",
          "        float acc = xr[b][c];\n"),
    "x": ("    float acc = __fmaf_rn(tk[0], v[c], __fmul_rn(tk[1], v[c + 1]));\n"
          "#pragma unroll\n"
          "    for (int t = 2; t < K; ++t) acc = __fmaf_rn(tk[t], v[c + t], acc);\n"
          "    xo[c] = acc;\n",
          "    xo[c] = v[c] + v[c + K - 1];\n"),
}
#: design name -> (source file, the C function, phases, variants: name -> phases replaced)
DESIGNS = {
    "canny tile": ("edges.cu", "yam_canny_candidates_u8", _TILE_CANNY, {
        "kernel": (), "no suppression": ("nms",), "x-passes only": ("nms", "y"),
        "staging only": ("nms", "y", "x"), "nothing": ("nms", "y", "x", "stage")}),
    "canny window": ("edges.cu", "yam_canny_candidates_u8", _WINDOW_CANNY, {
        "kernel": (), "no register cap": ("no cap",), "3 blocks an SM": ("3 blocks",), "5 blocks an SM": ("5 blocks",),
        "2 rows ahead": ("ahead 2",), "blocks of 4": ("blocks of 4",),
        "strips of 8": ("5 in strips of 8", "7 in strips of 8"), "no suppression": ("nms",),
        "x-passes only": ("nms", "y"), "loads and magnitudes only": ("nms", "y", "x")}),
    "adaptive tile": ("adaptive.cu", "yam_adaptive_threshold_u8", _TILE_ADAPTIVE, {
        "kernel": (), "x-pass only": ("y",), "staging only": ("y", "x"), "nothing": ("y", "x", "stage")}),
    "adaptive window": ("adaptive.cu", "yam_adaptive_threshold_u8", _WINDOW_ADAPTIVE, {
        "kernel": (), "no register cap": ("no cap",), "4 blocks an SM": ("4 blocks",), "6 blocks an SM": ("6 blocks",),
        "2 rows ahead": ("ahead 2",), "blocks of 2": ("3 in blocks of 2", "11 in blocks of 2", "13 in blocks of 2"),
        "blocks of 8 (33: of 4)": ("3 in blocks of 8", "11 in blocks of 8", "13 in blocks of 8", "33 in blocks of 4"),
        "strips of 8 at 11": ("11 in strips of 8",), "x-pass only": ("y",), "loads, x-pass as one add": ("y", "x")}),
}
#: the phases a variant may replace by trivial ones; the other variants
#: change a schedule or a size and must still give the plain version's bits
PHASES = {"stage", "x", "y", "nms"}
#: the block sizes past the window kernels' (timed on the tile kernel where a checkout has both)
TILE_BLOCK_SIZES = (35,)


def window_sizes(text: str) -> set:
    """The block sizes ``csrc/adaptive.cu`` has a window instance for."""

    return {int(k) for k in re.findall(r"case (\d+): return static_cast<int>\(launch_window<", text)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variant(source: str, phases: dict, skip) -> str:
    for name in skip:
        old, new = phases[name]
        source = source.replace(old, new)
    return source


def build(root: Path, only) -> dict:
    """``{design: {variant: library path}}`` for the designs (of ``only``,
    if given) whose anchors the checkout's sources hold; one nvcc a
    variant, all in parallel."""

    sys.path.insert(0, str(root))
    from yamimageprocessor_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs, libs = [], {}
    for design, (src, _, phases, variants) in DESIGNS.items():
        if only and design not in only:
            continue
        text = (root / "yamimageprocessor_tpu_torch" / "csrc" / src).read_text()
        missing = [name for name, (old, _) in phases.items() if old not in text]
        if missing:
            print(f"{design}: skipped, {src} lacks the anchors of {missing}")
            continue
        for name, skip in variants.items():
            stem = re.sub(r"\W+", "_", f"{root.name or 'tree'}_{design}_{name}")
            cu, lib = OUT / f"{stem}.cu", OUT / f"{stem}.so"
            cu.write_text(variant(text, phases, skip))
            cmd = [_build._nvcc(), *flags, "-I", str(root / "yamimageprocessor_tpu_torch" / "csrc"), "-shared", "-o",
                   str(lib), str(cu)]
            jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            libs.setdefault(design, {})[name] = lib
    for lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            for _, other in jobs:
                other.kill()
            raise SystemExit(f"nvcc failed for {lib.name}:\n{log}")
    return libs


def one(root: Path, only) -> None:
    import numpy as np
    import torch

    cs = _chip_smoke()
    smi = cs.phase_device()
    libs = build(root, only)
    from yamimageprocessor_tpu_torch import _build
    from yamimageprocessor_tpu_torch.ops import edges as E
    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
    from yamimageprocessor_tpu_torch.ops.tables import gaussian_taps
    from yamimageprocessor_tpu_torch.ops.threshold import adaptive_threshold, adaptive_threshold_plain

    dev = torch.device("cuda", 0)
    gray = bgr_to_gray(torch.from_numpy(cs.denoise_frames()).to(dev)).contiguous()
    low, high, c_ceil = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (50, 150, 2))
    windows = window_sizes((root / "yamimageprocessor_tpu_torch" / "csrc" / "adaptive.cu").read_text())
    sizes = {"adaptive tile": [k for k in BLOCK_SIZES if k not in windows] or list(TILE_BLOCK_SIZES),
             "adaptive window": [k for k in BLOCK_SIZES if k in windows]}
    taps = {k: torch.from_numpy(gaussian_taps(k, 0.0).astype(np.float32)).to(dev)
            for k in BLOCK_SIZES + TILE_BLOCK_SIZES}
    canny = {f"aperture {a}": (lambda a=a: E.canny_candidates(gray, low, high, a),
                               lambda a=a: E.canny_candidates_plain(gray, low, high, a)) for a in APERTURES}
    cases = {"canny tile": canny, "canny window": canny}
    for design, ks in sizes.items():
        cases[design] = {f"block {k}": (lambda k=k: adaptive_threshold(gray, taps[k], c_ceil),
                                        lambda k=k: adaptive_threshold_plain(gray, taps[k], c_ceil)) for k in ks}
    result = {"package": E.__file__, "card": smi, "ms": {}}
    for design, variants in libs.items():
        src, entry, _, _ = DESIGNS[design]
        for name, path in variants.items():
            lib = ctypes.CDLL(str(path))
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
            _build._lib = lib
            for case, (fn, plain) in cases[design].items():
                exact = not set(DESIGNS[design][3][name]) & PHASES  # a schedule or a size changed, not a phase
                if exact and not torch.equal(fn(), plain()):
                    raise AssertionError(f"{design} {case}: the {name} build differs from the plain version")
                result["ms"].setdefault(design, {}).setdefault(case, {})[name] = cs.time_ms(fn)
    for design, table in result["ms"].items():
        for case, row in table.items():
            names = list(row)
            parts = [f"{a} - {b} {row[a] - row[b]:.4f}" for a, b in zip(names, names[1:])]
            print(f"{design} {case} on {tuple(gray.shape)}: " + ", ".join(f"{n} {v:.4f}" for n, v in row.items())
                  + " ms; differences: " + ", ".join(parts))
    print(json.dumps(result))


def main(argv) -> None:
    only = []
    if argv[:1] == ["--only"]:
        only, argv = argv[1].split(","), argv[2:]
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve(), only)
        return
    for root in argv or [str(HERE)]:
        cmd = [sys.executable, __file__] + (["--only", ",".join(only)] if only else []) + ["--one", root]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        print(f"== {root}")
        print(out.stdout.strip())
        if out.returncode:
            print(out.stderr[-4000:])
            raise SystemExit(out.returncode)


if __name__ == "__main__":
    main(sys.argv[1:])
