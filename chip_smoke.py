#!/usr/bin/env python3
"""Build and check the torch port on one CUDA card, then drive its ten
main paths once each: the flagship preprocess chain, the segmentation
chain, the batched CLAHE chain, the denoise chain, the bilateral filter,
the edge and region ops of segmentation, the region-properties
extraction, the texture features, the shape features (Fourier
descriptors, approximate shape) and the streaming of gigapixel slides.

    python3 chip_smoke.py
    python3 chip_smoke.py --streaming   # build, then the stream phase alone
    python3 chip_smoke.py --edges   # build, then the edges phase alone
    python3 chip_smoke.py --times-of DIR [DIR ...]   # CC, the blend, histogram256, the median and bilateral
    python3 chip_smoke.py --extraction-times-of DIR [DIR ...]   # the hull and annotation kernels
    python3 chip_smoke.py --texture-times-of DIR [DIR ...]   # the filter, LBP, HOG and GLCM kernels, three tables
    python3 chip_smoke.py --shape-times-of DIR [DIR ...]   # the trace, the lines, the errors, two tables' host clock
    python3 chip_smoke.py --edges-times-of DIR [DIR ...]   # the gradient, Canny's candidates, region growing

Phases, each of which raises on failure (the script then exits nonzero):

1. device: a CUDA card must be present; prints its nvidia-smi name and
   power limit;
2. build: compiles ``yamimageprocessor_tpu_torch/csrc/*.cu`` with nvcc,
   one process per source;
3. kernels: each of the ten older CUDA kernels against its plain PyTorch version
   on the card, bit for bit, at the main paths' shapes and at awkward
   ones (sepconv at ksizes 1 to 33 on the flagship batch, on widths that
   are not a multiple of 16 and on frames whose base is 1 byte past
   alignment, on interleaved 3-, 4- and 17-channel frames, the CLAHE batch
   included, with asymmetric taps that differ in y and x, and on a 1024^2 frame at ksizes 13 and 19 against SHA-256
   digests of the JAX package's output; the distance kernel also at 1 to 2048 rows a chunk, on its two
   worst cases and on a batch of three frames; the flood also on a batch
   of 8 different 2048^2 scenes, each frame against its plain flood alone,
   on a single-marker frame whose front crosses the frame one pixel a
   sweep, and on uint16 frames whose edge costs pass 255; CC on the
   segmentation chain's sure foreground and opening, 55% noise, a spiral,
   an all-foreground frame, a checkerboard, ragged frames and a batch of 8
   scenes' sure foregrounds; the blend also where a band straddles tile
   rows, at grid 64 and on odd widths; histogram256 on the main paths'
   inputs, lengths 1, 15, 17 and 2^20+3, a base 1 byte past alignment and
   a mixed batch; and histogram256, lut_apply, the tile histograms and the
   blend past 65535 frames or rows); then each
   kernel's, its plain version's and (where one PyTorch call computes the
   same function) that call's device time, the distance kernel's at each
   chunk size and on its worst cases, CC's on each of its timed masks,
   sepconv's on the CLAHE path's
   interleaved batch, histogram256's (and bincount's on each single
   frame) on each main-path input (the flagship batch after the Gaussian,
   uniform bytes, the segmentation scene, its closed mask, a constant
   frame), the device time of an empty launch, and the flood's sweeps, levels
   visited and share of tiles swept, its time on the batch and on the
   single-marker frame at 2048^2;
4. flagship: the flagship chain (Gaussian 5x5 -> histogram equalization
   -> brightness/contrast) on an 8 x 2048^2 uint8 batch from
   ``np.random.default_rng(0)`` through ``flagship_forward`` and the
   pipeline manager, against the port's own CPU run and a SHA-256 digest
   of the JAX package's output; the chain's rate back to back and its
   device time;
5. segmentation: the segmentation chain (Otsu -> open -> close -> marker
   watershed) on ``_dense_scene(2048, seed=3)`` through
   ``segmentation_forward`` and the pipeline manager, against the digest
   of the JAX package's output, and at 512^2 against the port's CPU run;
   the flood's sweep count, frames/s over 12 frames back to back, the
   time per frame and its kernels and device time by kernel from
   ``torch.profiler``;
6. clahe: the batched CLAHE chain (Gaussian 5x5 -> CLAHE, clip 2.0, grid 4
   -> the mean of R and G; ``bench.py:_extra_batched_clahe``) on a 64 x
   1024^2 BGR batch through the chain runner and the pipeline manager,
   against SHA-256 digests of the JAX package's outputs at that shape and
   at 4 x 1000^2 (where the blend's fractions are not dyadic), and at 3 x
   120 x 100 against the port's CPU run; MPix/s back to back, the device
   time, and the device time by kernel from ``torch.profiler`` (as for the
   flagship chain).  The frames
   come from ``np.random.default_rng(0)``, where the bench draws them with
   ``jax.random``: the one deviation from the bench's config;
7. denoise: Grayscale -> Median 5 -> Sharpen 1.0 -> Normalize 0..255 ->
   the crop preview at (512, 512, 1024, 1024) on an 8 x 2048^2 x 3 BGR
   batch from ``np.random.default_rng(0)`` through the chain runner and
   the pipeline manager, against the digest of the JAX package's output and
   the port's CPU run on frames 0-1; the same chain ending in the crop
   itself against its digest; the device time, back to back, and the
   profiler's split;
8. bilateral: one Bilateral step at ksize 5 on the same batch, checked
   and timed the same way;
8b. edges: Sobel, Prewitt, Laplacian, Canny edge, the adaptive threshold,
   border removal and region growing, each one step at its defaults, and
   a Gaussian 5 -> Canny chain, through the chain runner on the same BGR
   batch and on the segmentation scene and through the manager on frame
   0, with the counts set to 0: every output against the JAX package's
   digest, 512^2 crops against the port's CPU run; the gradient kernel at
   Sobel ksizes 1-31, Prewitt and Laplacian ksizes 1-19 (on the batch and
   on 2047 x 2049, 1 x 2048 and 2048 x 1 frames), Canny's candidates at
   apertures 3, 5 and 7 (and the hysteresis on them), the adaptive
   threshold at block sizes 3-255 and C -100, 2, 100 and region growing
   (noise, the scene and its background, an all-equal frame, tol -1,
   unaligned rows) against their plain versions, bit for bit; region
   growing and the hysteresis on ``_spiral(2048)`` against
   ``scipy.ndimage.label``; the four kernels' device time beside their
   plain versions', their bounds and (the gradient) ``conv2d``'s, the
   gradient at Sobel 5 and 7, Prewitt 3 and the Laplacian 1 and 3 and
   region growing on 8 copies of the scene (its background) the same way,
   each chain's device time and the profiler's split of four;
9. extraction: ``extraction.region_properties``'s
   ``data_fn`` on ``bench.py:_extra_extraction``'s BGR 1024^2 dense scene
   (64 regions), ``region_tables`` on its batches of 8 and 32 frames
   (seeds 0..n-1), on the 4096^2 scene (1024 regions) and on a 2048^2
   frame of 4x4 blobs (65536 regions), and the op's annotation through
   the pipeline manager; the tables' exact columns (area, bbox, solidity)
   against SHA-256 digests of the JAX package's tables, the annotated
   frame against its digest, every column against the port's CPU run on
   3 frames; the three extraction kernels (the label pass: row extremes,
   bboxes, moment and perimeter sums; hull areas; annotation) against
   their plain versions, bit for bit, on each of those label sets, on a
   4096^2 frame holding one disk 4001 rows tall (the hull's longest
   chain), on two 4096^2 frames whose region's right or left outline is a
   strictly convex lattice chain near ``hull_stack_capacity`` and on a
   1024^2 checkerboard, all-background and all-foreground frame, gray
   and BGR, the label pass also against the parent's composition (row
   extremes, their bbox, the sums about the bbox centre); the annotation
   also on boxes clipped at all four frame edges, one pixel wide, across
   an earlier region's disk and with a disk across a corner (gray and BGR,
   uint8, uint16, float32); each kernel's,
   its plain version's and (for the label pass: scatter_reduce_ amin and
   amax, then index_add_ of the per-pixel sums) the library calls'
   device time on the 32-frame batch and on one frame, beside its bound,
   the label pass's time and bound on each of the five label sets, the
   hull's and the annotation's on all seven (with each set's tallest
   region); the peak device memory of ``region_tables`` on the blobs
   frame; the data path's device time and back-to-back rate on 1, 8 and
   32 frames, the annotation's, and the profiler's split of the 32-frame
   batch;
10. texture: the LBP, Gabor (ksize 21) and HOG (9 bins, 8x8 cells, 3x3
   blocks) chains, one step each at their defaults, through the pipeline
   manager on the extraction phase's 32 BGR 1024^2 scenes (seeds 0..31),
   and the five texture data_fns (LBP, Haralick, Gabor, HOG, fractal
   dimension) on the first 8, in one run with the counts set to 0: the
   chains' outputs against SHA-256 digests of the JAX package's and the
   port's CPU run on frame 0, the tables' exact columns against the JAX
   package's CPU data path and every column against the port's CPU run;
   the four kernels against their plain versions, bit for bit (GLCM at
   distances 1 and 64 and angles 0 to pi on 8 scenes and a flat frame,
   LBP at (8, 1), (16, 2), (24, 8) in both arithmetics, the dense filter
   at ksizes 3 and 21 and at 101 on a 512^2 frame in both orders, HOG at
   (9, 8) and (32, 2) and on a 2048^2 frame, at (32, 2) on a crop whose
   cells do not fill the tiles evenly; GLCM also on a crop whose rows do
   not fill its units evenly, a 3-scene batch at negative offsets and a
   flat 2048^2 frame, one key past any 16-bit half), and the filter and LBP on
   edge frames (one pixel, one row, one column, widths that are no
   multiple of the filter's strip or block, frames smaller than the kernel
   or than R) of the three frame types, the filter also at ksizes 111 and
   151 (taps in shared memory, then read through the cache); each kernel's, its plain
   version's and (GLCM: ``torch.bincount``; the filter: ``conv2d`` in
   float32) the library call's device time beside its bound, the tables'
   host-clock ms a frame (and the Hu moments table's) and each chain's
   device and back-to-back time;
11. shape: the Fourier chain (num_coeff 10 and 512) through the pipeline
   manager on the same 32 scenes and the Fourier (num_coeff 10) and
   approximate-shape (error_threshold 1.0) data_fns on the first 8, in one
   run with the counts set to 0: the chain's outputs and the tables' exact
   columns against SHA-256 digests of the JAX package's, everything against
   the port's CPU run (the spectral lines within 1e-10 of the largest); the
   contour trace bit for bit against its plain walk on the 32 scenes, a
   2048^2 frame of 65536 blobs and the 4001-row disk, the Fourier lines
   within 1e-10 of the largest line and 1e-8 pixel of the reconstruction
   (the rounded polygon equal) on the 32 scenes' largest contours and the
   disk's at both num_coeff, the boundary errors bit for bit on the 8
   frames' candidates and the disk's; each kernel's, its plain version's
   and (the Fourier lines: cuFFT's fft and ifft) the library call's device
   time beside its bound; the chain's host-clock ms at 1, 8 and 32 frames,
   its kernels by the profiler, the tables' host ms a frame;
12. stream: ``.npy`` slides opened as memmap records (in a temporary
   directory) through the pipeline manager: the flagship chain on a
   16384^2 slide in 2048^2 tiles (``bench.py:_extra_gigapixel``'s
   geometry: the uniform fused route, 64 windows of 2052^2 on the card)
   with the counts set to 0, equal to the port's dense chain bit for bit;
   then a cold sweep (source cache cleared), a warm one (nothing read), a
   device-sink one and one on the batched route (the cache's budget below
   the windows' bytes), each equal to the dense chain and timed on the
   host clock in GPix/s, and each part of a sweep timed alone (reads,
   upload, kernels, read-back, the host's paste); the CLAHE chain (grid 8,
   clip 40, then normalize) on a 16380^2 slide (the generic route, 4
   padded grid rows and columns) with the counts set to 0, its two stream
   kernels bit for bit against their plain versions on a middle row of
   tiles, the last row (the mirror rows) and the corner tile, and timed
   there beside their bounds; the flagship and CLAHE chains on 2048^2
   gray and BGR slides in 512^2 and 500 x 300 tiles against SHA-256
   digests of the JAX package's streamed output; the segmentation chain
   on a 4096^2 slide through the dense branch against the dense chain;
   H2D and D2H of 256 MiB, pinned through ``parallel/transfer.py`` and
   pageable, in GB/s.

The kernel phase also holds the median kernel bit for bit against its
plain version at ksizes 3, 5, 7 and 9 on the denoise path's gray frames
and at 3, 5, 7, 9, 15 and 31 on 256^2 gray and 3-channel uint8 and uint16
frames and on ragged ones (2, 4 and 5 channels, one row, one column, a
frame smaller than the window, a batch of 5), the bilateral kernel at
ksizes 1, 3, 5 and 9 on 2048^2 gray and BGR frames and at 31 on 256^2
ones, on 2, 4, 5 and 9 channels and the same ragged shapes; it measures
the card's rate of packed 16x2 min and max (``yam_vminmax_rate``), times
both kernels at every ksize on their main-path inputs and prints each
time beside its bound (the median's packed min and max at that rate, the
bilateral's busiest pipe: FP32 instructions, int32 operations or the
colour table's shared-memory wavefronts) and its share of it, and times
the median's PyTorch ``unfold(...).median(-1)``, sepconv's generic
instance at sharpen's 19 taps on the denoise path, and the plain-torch
paths left slow: the float32 median and bilateral filter.

Every kernel's launch count is set to 0 just before each main path and
read just after; a kernel of the path that did not launch fails the run.
The digests come from ``scripts/torch_port_digests.py`` (the JAX package
on a CPU).  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  The
``--*-times-of DIR [DIR ...]`` modes (:func:`times_in_turns`) time one
phase's cases (:data:`TIMED_PHASES`) on the port of each checkout DIR (an
older one, unpacked with ``git archive``) and of this one, in turns (the
DIRs, this, this, the DIRs backwards, each in a process of its own), fail
unless the outputs' SHA-256 digests agree, and print the mean of each
checkout's two runs: ``--times-of`` CC, the blend, histogram256, the
median and the bilateral filter at every ksize, an empty launch, and the
flagship and segmentation chains' kernels a call and back-to-back ms;
``--extraction-times-of`` the hull and annotation kernels on the seven
extraction label sets and the blobs frame's peak memory;
``--texture-times-of`` the dense filter, the LBP codes, HOG cells and GLCM
counts, and the HOG, Gabor and Hu-moments tables' host ms a frame (not
compared: an older checkout's float64 columns need not be the reference's
bits); ``--shape-times-of`` the trace, the lines and the boundary errors
with their split by launch, the Fourier chain's host clock on the 32
scenes and the approximate-shape table's split by part on 8 of them;
``--edges-times-of`` the gradient at its compiled tap pairs and Sobel 9,
Canny's candidates at apertures 3, 5 and 7, and region growing on the
denoise batch's gray frames and on the scene's background.
Nothing falls back to the CPU: without a card the script exits nonzero.
"""
from __future__ import annotations

import hashlib
import json
import math
from collections import defaultdict
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FLAGSHIP_SHAPE = (8, 2048, 2048)
FLAGSHIP_STEPS = 3  # Gaussian, histogram equalization, brightness/contrast
SEG_SIDE = 2048
SEG_CPU_SIDE = 512
SEG_FRAMES = 12
FLOOD_BATCH = 8
CC_BATCH = 8
CC_MAIN = "scene sure foreground 2048^2"  # label_seeds' input on the segmentation path
HIST_MAIN = "flagship Gaussian (8,2048^2)"  # equalization's input on the flagship path
HIST_ONE = "uniform 2048^2"  # the single frame library_ms is timed on
F7_FRAMES = 70_000  # past the 65535 frames one grid dimension takes
F7_TILES = 65_600
CLAHE_SHAPE = (64, 1024, 1024, 3)
CLAHE_1000_SHAPE = (4, 1000, 1000, 3)  # tiles of 250 px: non-dyadic fractions
CLAHE_CPU_SHAPE = (3, 120, 100, 3)
GAUSS_SHAPE = (1024, 1024)  # the Gaussian's digest frame
GAUSS_KSIZES = (13, 19)  # non-dyadic taps: the digests pin XLA's fused order
SEPCONV_KSIZES = (1, 3, 5, 7, 9, 13, 19, 33)
CLAHE_CLIP = 2.0
CLAHE_GRID = 4
DENOISE_SHAPE = (8, 2048, 2048, 3)
DENOISE_CPU_FRAMES = 2
CROP_BOX = {"x_offset": 512, "y_offset": 512, "width": 1024, "height": 1024}
MEDIAN_KSIZES = (3, 5, 7, 9, 15, 31)
BILATERAL_KSIZES = (1, 3, 5, 9, 31)
SMALL_SIDE = 256  # frames for the large ksizes, whose plain versions are slow
RUNS = 20
SLEEP_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, an FMA two operations
F32_INST_PER_S = 33.4e12  # H100 SXM FP32 instructions (an add, a multiply or an FMA): 128 lanes an SM x 132 x 1.98 GHz
F64_INST_PER_S = 16.7e12  # H100 SXM FP64 instructions outside the tensor cores: 64 lanes an SM x 132 x 1.98 GHz
INT32_OPS_PER_S = 16.7e12  # H100 SXM int32: 64 lanes an SM x 132 SMs x 1.98 GHz
SHARED_WAVEFRONTS_PER_S = 261e9  # one 128-byte shared-memory wavefront a clock an SM: 132 x 1.98 GHz
#: packed 16x2 min and max ops a pixel (two pixels an op, PTX min/max
#: .u16x2) of the least count this repo knows, by ksize: half the scalar min
#: and max operations a pixel.  Ksize 3 and 5 are the kernel's own schedule
#: (csrc/median.cu: 18 and 160 a pixel pair); 7 and 9 the shared-column
#: construction (562 and 1304: every column sorted once for the k windows
#: that hold it, each row's rank-feasible candidates from a pruned network,
#: their forgetful selection).  tests/test_torch_median_schedule.py models
#: both and counts them.
MEDIAN_PACKED_OPS = {3: 18 / 2, 5: 160 / 2, 7: 562 / 2, 9: 1304 / 2}
#: int32 operations a pixel of a Perreault-Hebert sliding histogram (uint8,
#: 16 coarse x 16 fine bins, 16-bit counts two to a word) that any window
#: needs: the entering and leaving column histograms' fine and coarse bins
#: (4), the window's coarse histogram plus one column's and minus another's
#: (8 + 8 words), one compare in each search (2).  The fine bins' lazy
#: refresh and the searches' length depend on the data and are left out, so
#: this is a floor of that algorithm's work.
MEDIAN_HISTOGRAM_OPS = 4 + 16 + 2
#: min/max rounds of the rate kernel (yam_vminmax_rate) and its blocks
RATE_ROUNDS, RATE_BLOCKS = 4096, 132 * 8
EXTRACT_SIDE = 1024  # bench.py:_extra_extraction's frame, BGR
EXTRACT_BATCHES = (8, 32)  # its mass-extraction batches, seeds 0..n-1
EXTRACT_WIDE_SIDE = 4096  # the 32 x 32 grid MAX_REGIONS = 1024 was sized for
BLOBS_SIDE = 2048  # 4x4 blobs on an 8-pixel pitch: 65536 regions
EXTRACT_CPU_BATCH = 2  # frames of the 8-batch the port's CPU run also takes
EXTRACT_REPS = 5  # back-to-back calls of the data path
EXTRACT_KERNELS = ("region_scan", "hull_areas", "annotate")
TALL_SIDE, TALL_RADIUS = 4096, 2000  # one disk 4001 rows tall: the hull's longest chain
CHAIN_SIDE = 4096  # regions whose outline is a strictly convex lattice chain near hull_stack_capacity
EDGE_SHAPE = (2, 300, 257)  # frames of the annotation's edge cases
#: cases whose plain hull walks thousands of rows in Python: timed once a side
SLOW_PLAIN_CASES = (f"tall disk {TALL_SIDE}^2", f"convex chains {CHAIN_SIDE}^2")
TEXTURE_FRAMES = 32  # the extraction phase's 32-frame batch: BGR 1024^2 dense scenes, seeds 0..31
TEXTURE_TABLE_FRAMES = 8  # frames the five texture data_fns run on
TEXTURE_TIMED_TABLE_FRAMES = 2  # frames --texture-times-of times each table on
TEXTURE_CHAINS = ("LBP", "Gabor", "HOG")  # one step each, default parameters (Gabor ksize 21, HOG 9 bins, 8x8, 3x3)
TEXTURE_KERNELS = ("glcm_counts", "lbp_codes", "filter2d", "hog_cells")
GLCM_ANGLES = (0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4, np.pi)
GLCM_DISTANCES = (1, 64)
LBP_CASES = ((8, 1.0), (16, 2.0), (24, 8.0))
FILTER_KSIZES = (3, 21, 101)  # 101 on a FILTER_SMALL_SIDE^2 frame
FILTER_SMALL_SIDE = 512
HOG_CASES = ((9, 8), (32, 2))  # (orientations, cell side); (9, 8) also on a HOG_WIDE_SIDE^2 frame
# crops whose cells do not fill the kernel's tiles evenly: 32 bins 2x2 (tiles of 64 x 16 cells), the
# GLCM's units of window rows (8 rows a unit on one frame)
HOG_RAGGED_CROP = (2, 1001, 1000)
GLCM_RAGGED_CROP = (1, 1031, 997)
GLCM_BATCH_OFFSETS = ((-3, -2), (-1, 2))  # on a batch of 3 scenes
HOG_WIDE_SIDE = 2048
# (cell side, orientations) of every other way XLA sums a cell (ops/hogf.py:cell_order), each on a crop
# 8 cells wide: 4 and 8 lanes with pairs, 8 lanes with a tail, windows summed in order and in pairs, the
# peeled window column, the scalar loops
HOG_ORDER_CASES = ((17, 9), (20, 9), (23, 32), (31, 9), (40, 8), (40, 9), (63, 32), (9, 1), (2, 2))
TEXTURE_DTYPE_FRAMES = 4  # scenes of the float32 and uint16 kernel cases
# float32 operations of a HOG pixel's formulas, a division or square root
# counted as one: gradients 2, hypot 6, atan2f about 33 (the reduction's
# division and the 11-term polynomial), degrees, remainder, bin 4, the
# cell's add 1 (a floor: the divisions and the root take several
# instructions each on the card)
HOG_OPS_PER_PIXEL = 46
# edge frames of the filter and LBP kernels: one pixel, one row, one
# column, widths that are no multiple of the filter's 8-column strip or
# 128-column block, frames smaller than the kernel (ksize 21 and 101 on 3^2
# and 5 x 7) or than R (8 on 3^2)
TEXTURE_EDGE_SHAPES = ((1, 1, 1), (2, 1, 37), (2, 41, 1), (1, 5, 7), (1, 3, 3), (2, 67, 131), (1, 33, 129),
                       (1, 17, 1000), (3, 40, 13))
FILTER_EDGE_KERNELS = ((1, 1), (3, 3), (5, 5), (21, 21), (23, 23), (1, 5), (5, 1), (3, 21), (101, 101))
LBP_EDGE_CASES = ((8, 1.0), (16, 2.0), (24, 8.0), (4, 0.5), (7, 3.3), (32, 2.0))
# kernels beyond the schema's 101: one block an SM (111), the largest whose tile fits (131); 133 is refused
FILTER_WIDE_KSIZES = (111, 131)
FILTER_REFUSED_KSIZE = 133
FILTER_WIDE_SHAPE = (1, 300, 260)

# JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/torch_port_digests.py
SHAPE_COEFFS = (10, 512)  # the Fourier chain's num_coeff: the default and the schema's largest
SHAPE_TABLE_FRAMES = 8  # frames of the 32 scenes the Fourier and approximate-shape tables run on
SHAPE_THRESHOLD = 1.0  # approximate_shape's default error_threshold
SHAPE_BATCHES = (1, 8, 32)  # the Fourier chain's host-clock batches (the first frames of the 32 scenes)
SHAPE_KERNELS = ("trace_contours", "fourier_lines", "polygon_mean_errors")
FOURIER_LINE_TOL = 1e-10  # |lines - plain| <= FOURIER_LINE_TOL * max(1, max|c|) a contour
FOURIER_RECON_TOL = 1e-8  # |reconstruction - plain| in pixels
#: FP64 instructions: a complex multiply-add (4), a radix-2 butterfly (a
#: complex multiply, 4 with two FMAs, and two complex adds, 4), a sincospi
#: (a floor of 20)
FOURIER_F64_PER_MAC, FFT_F64_PER_BUTTERFLY, SINCOSPI_F64 = 4, 8, 20
#: the boundary errors' floor in instructions (polygon_bound): ruling an
#: edge out of a (candidate, point) takes its numerator (px - x0, py - y0, a
#: product, an FMA) and a compare, 5, on the FP32 pipe where the candidate
#: spans less than POLYGON_SPAN_LIMIT and the point lies within it of every
#: vertex (every value exact in float32), else on the FP64 pipe; the
#: nearest edge's exact distance (FP64) a
#: (candidate, point) takes the nearest point (t dx, x0 + ., twice: 4), the
#: differences (2) and glibc's hypot (the squares' sum 3, a root 6, the
#: branch 2, the correction 8, its sum, 2 h, a division 6 and the last
#: subtraction 9, the range checks 4: 32), 38; and where that edge's t is
#: inside (0, 1) the quotient, 6 (a reciprocal seed and its Newton steps;
#: the root likewise)
POLYGON_RULE_OUT, POLYGON_F64_PER_POINT, POLYGON_F64_DIVISION = 5, 38, 6
#: csrc/shape.cu FILTER_LIMIT: the coordinates the boundary errors' filter
#: is proven for (past it every edge is evaluated exactly)
POLYGON_FILTER_LIMIT = 1 << 24
#: csrc/shape.cu SPAN_LIMIT: the reach of the float32 pass
POLYGON_SPAN_LIMIT = 1 << 11
SPLIT_RUNS = 20  # calls a profiler session of a kernel's per-launch split spans
SHAPE_CHAIN_CALLS = 10  # back-to-back calls of the Fourier chain's host-clock time in --shape-times-of
EDGE_OPS = {  # the edges phase's ops, one step each at its defaults: (step name, op id)
    "sobel": ("Sobel", "segmentation.sobel"),
    "prewitt": ("Prewitt", "segmentation.prewitt"),
    "laplacian": ("Laplacian", "segmentation.laplacian"),
    "edge": ("Edge", "segmentation.edge"),
    "adaptive": ("Adaptive", "segmentation.adaptive"),
    "border_removal": ("Border Removal", "segmentation.border_removal"),
    "region_growing": ("Region Growing", "segmentation.region_growing"),
}
EDGE_KERNELS = ("gradient", "canny_candidates", "adaptive_threshold", "region_grow")
EDGE_SOBEL_KSIZES = (1, 3, 5, 7, 15, 31)  # from 7 the squares wrap in int32, from 15 the gradients
EDGE_LAPLACIAN_KSIZES = (1, 3, 7, 19)  # 19: the largest whose aperture fits int32
EDGE_BLOCK_SIZES = (3, 11, 13, 33, 35, 101, 255)  # the adaptive threshold's; past 13 on the scene
EDGE_CPU_SIDE = 512  # crops of the edges phase's inputs the port's CPU run takes
EDGE_ODD_SHAPES = ((1, 2047, 2049), (1, 1, 2048), (1, 2048, 1))  # unaligned rows, 1 pixel tall and wide
EDGE_TIMED_BLOCK_SIZES = (3, 11, 13, 33, 35, 101, 255)  # the adaptive threshold's timed sizes: windows to 33, then tiles
#: the gradients timed beside Sobel 3: every compiled tap pair (csrc/edges.cu) the ops reach by default or near it
EDGE_TIMED_GRADIENTS = (("sobel", 3), ("sobel", 5), ("sobel", 7), ("prewitt", 3), ("laplacian", 1), ("laplacian", 3))

DIGESTS = {
    "segmentation_input": "789006ca990ec8e56fe63d5aa294f3853622819e9d010fb70d302ba9730050c0",
    "segmentation_output": "aa7c92f3bfcf004e955ee8c8fed24bc3fcaedd8c795647601d35b654ed2c9995",
    "flagship_input": "956e4093da8177e9fba7b1360a123a36cb89407283c92393f3e507b7d86299c9",
    "flagship_output": "e011c3251bc66a362d078629522d14501958087ad9288d38d7773facc84be595",
    "clahe_input": "db41df124b15860649329f8dcafbac2e6e39867aaf4b7459faabdbfb67a76d98",
    "clahe_output": "2b1225c42baa82ebfe225d5a43146532233945a3e0159f162aee6f5b1a2a579a",
    "clahe_1000_input": "bf04b8a97881f83317ecf39d8bd716417b41dca179df4050916d0da1ccddfa4d",
    "clahe_1000_output": "ea807ad28ef69b0a41828bcdb27338f952aa4ed630f5861432df98613394d7b6",
    "gauss_1024_input": "695684bcedb2df4c1e1bb5ba3e2d74ee96438b6b49d601ffd70c30200184e0e1",
    "gauss13_1024_output": "e55cc8b2585b6f74424fc076a5855ceca3cce73ffc97b99cd2c1e35b67774626",
    "gauss19_1024_output": "fd384ba4bdeea943d3c3bf13da5ac95cc3e68d44a03475b714439dc7a696ef0b",
    "denoise_input": "1b7acd6457ca4845fe678175c239e6aef0fee00f75a3ef68a346e6b4ab4a13c4",
    "denoise_output": "ea3b9675fd30c2b9cca38357ce00d4188ed36a6069e7028279fc329fe00b6b55",
    "denoise_crop_output": "054819afefc9d264073337187e12ed20c4e2e551af394f10f0794ebd4931a85f",
    "bilateral_output": "4dc181fad127bee0f7cb4660f81c0aa7e018208425873d2b782d3f378393f13d",
    "extract_1024_input": "84e8ff962e4d7efde78e161ac08ed4e7c5708ff8047b7a5fec1f2ae2d3062c86",
    "extract_1024_table": "779ad9cdab5159f0185ed2c2432ec9c520b1af2cd07f246d753602d9c3038341",
    "extract_4096_input": "d4b085faf6a8d8d8c521adf920e7a459b7fe271ebe0a5f7d28c821737e5f0a94",
    "extract_4096_table": "03104267c4a9640e1b790bc69fd838465fecbc236029560eef073df9a7b7985b",
    "extract_blobs_input": "dbb8d622f92eb3eb5282423022a63e80c1b94a5ee3a266f28a283b29050b20d1",
    "extract_blobs_table": "66b619d84ef5863e7ef44f28879e99a29b8397e43332324f6335a298d1f06165",
    "extract_batch8_input": "0cfe169af1b9194d61705b74a30921fe5f43cb200f4da6d1d34a872e3f3faf99",
    "extract_batch8_table": "c764f89370af79ef9944ee4ac5439ed965de843f212dcc3eb0cd10a61016769b",
    "extract_batch32_input": "7d29de7e4cafffb16cd4918e73793db6d8b1cc2df8a77967e40e5c53b0302a7f",
    "extract_batch32_table": "19eddff2236005a42fdfcb5a13c576815c113b67cb529abc449eb507506e11b9",
    "extract_annotated_1024": "cab962cc22fd9eb9a243fd3ae2a36326dc86843e628e772aff1773aed4dcece0",
    "texture_input": "7d29de7e4cafffb16cd4918e73793db6d8b1cc2df8a77967e40e5c53b0302a7f",
    "texture_lbp_output": "6c9b77ee47b2af1693f27af6484105a2d506fe9915b8ce0dbae38b3b903ac02b",
    "texture_gabor_output": "c2d18dac888ae80f58d65b15423bed37c978922c48f8a93f879018e6d11167fb",
    "texture_hog_output": "dc7b12aa0fccbe6e9229679bf4dc74571642b1f6318ab70d389b7795482215bb",
    "texture_tables": "2a9401277d78a80b352400db83afdb263bae2663897e033e55ce7841701596ce",
    "shape_input": "7d29de7e4cafffb16cd4918e73793db6d8b1cc2df8a77967e40e5c53b0302a7f",
    "shape_fourier10_output": "a5ce65607a95416e14f48a87e57e637131a0a30db6b921828c9a81206a2d5e0f",
    "shape_fourier512_output": "0eadddb6b9c371e8eb03fbff6f888b0a4d5c80eec3509c6cda558b52d63db741",
    "shape_tables": "21029badbb1dfa06c5044f05c24c570371453eae16c12249ce7a8ef58a3b52cc",
    "stream_gray_input": "037cc07e955daf19273c4605cba9598cd3a5532aa5a00f1bc1742c58e43fa36f",
    "stream_flagship_gray_512": "ababf7afd2be23de0ff6e6ee3c2c6ac95b9adff8af0439aaf2da3dd67daf7ecb",
    "stream_flagship_gray_500x300": "ababf7afd2be23de0ff6e6ee3c2c6ac95b9adff8af0439aaf2da3dd67daf7ecb",
    "stream_clahe_gray_512": "402c3a1fd944ad3094fd11f7e0739a128f5a9bdb0c2830b65a97385247316032",
    "stream_clahe_gray_500x300": "402c3a1fd944ad3094fd11f7e0739a128f5a9bdb0c2830b65a97385247316032",
    "stream_bgr_input": "579a595a2055ac27fd8ac968880702ac2026722cc3bbfac76e8f58e639bfd414",
    "stream_flagship_bgr_512": "647ae31ba21c005da14b7a23e3064a4fb80656b1222a08c31275a89b726e7d86",
    "stream_flagship_bgr_500x300": "647ae31ba21c005da14b7a23e3064a4fb80656b1222a08c31275a89b726e7d86",
    "stream_clahe_bgr_512": "b8d2301e565701a4dfa4ccd9b116fbb0b93f8927010e90bab162782ede1f07bd",
    "stream_clahe_bgr_500x300": "b8d2301e565701a4dfa4ccd9b116fbb0b93f8927010e90bab162782ede1f07bd",
    "stream_float32_input": "cd2e0cdfd9a80f48d611e5510259e12a1554a07ea8e1148847c03d97e28f20ee",
    "stream_clahe_float32_512": "a30a11041d3fe36d397b82b19d23560818c5aa76dce6ad295cbec76e0cae2de7",
    "stream_clahe_float32_500x300": "a30a11041d3fe36d397b82b19d23560818c5aa76dce6ad295cbec76e0cae2de7",
    "stream_uint16_input": "c7fe580a47ed22a92b3fa900dce8c0abccd018bb7320ee8eb0bd70cdebc5b1e8",
    "stream_clahe_uint16_512": "e3b00dd19255355c6da5e091decd1d2e126fd5b11af86ee6565bac311b7696c9",
    "stream_clahe_uint16_500x300": "e3b00dd19255355c6da5e091decd1d2e126fd5b11af86ee6565bac311b7696c9",
    "edges_sobel_bgr": "d0ff8306795cc730a616d7e33a0c0ccbf5a32429c0f0c1b8610d9cfc926829a0",
    "edges_sobel_scene": "d894df8af8010e7108aad3e6e3aaf4067b15af5f094d45379a356ffc2d3e4f32",
    "edges_prewitt_bgr": "81c26957c20dd08c6d552a90f277b4980e0bac0bbe3185ddeb313dd0e75eac2c",
    "edges_prewitt_scene": "4f7d5e87ab359a45b239de24cdb5f1d083800583c538e35d50f5fa711c826250",
    "edges_laplacian_bgr": "938525acebb81153c44b8806a02d51ab3c70e6c0a4eece94737b6d8ad0423069",
    "edges_laplacian_scene": "79b15d7a8bc68348efc00c34b573c8329e270b1f60b4275eae026782db27f195",
    "edges_edge_bgr": "d3a4281c06b9b90893f5c5d4330581806c60fd6a3a7a2b92937cbb3b57a7942e",
    "edges_edge_scene": "2a1059fff42ff643466547c87e996bf47d83b0065c44e135e84862b0d6f0657e",
    "edges_adaptive_bgr": "2ef117ca921192330be91219fe10510baa29fd5b86b51ba1cee6c5e967fe0854",
    "edges_adaptive_scene": "c024467b7bd6b585911e9e041fb50e343772247f436485d6cad2d0a51dcac3ed",
    "edges_border_removal_bgr": "b26f267c29004276e9cd3a2d6e46b0edf07835dc506c6cf0b13895a52d421695",
    "edges_border_removal_scene": "3bc4552d6d9ef3b6d19e027bd64beabd614c3b751c6d9fd139ad4600402c64d5",
    "edges_region_growing_bgr": "4d2a12f06b6fdbe9b071c73e711f99f5dc2489f9dc383e16af7775b622394c47",
    "edges_region_growing_scene": "979fe221a8875e934a6321e747a9d61ec36dc68eebdf4e4d9ed6d0e06b5156f5",
    "edges_gauss_canny_bgr": "701177f053fc0b42422b4ebc43b82184ebbcb951fc5a1da7452464053e2507d6",
    "edges_gauss_canny_scene": "6cc15f43a8decb7ec4f43c0f9f551ce40c3acde778c727dd557fa95f277c740c",
}


def time_ms(fn, runs: int = RUNS, warmup: int = 3, before=None) -> float:
    """Median device time of one ``fn()`` in ms, one CUDA event pair a run.

    Each run first queues a ~1 ms sleep on the stream, so the host has
    queued the start event, ``fn``'s launches and the end event before the
    device reaches them: the pair measures device time, not the host's
    launch latency (unless ``fn`` waits for the device itself).  ``before``,
    if given, is queued ahead of each run's sleep (outside the pair)."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
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


def profiled_device_ms(fn, runs: int = 5):
    """Device time of one ``fn()`` in ms, summed over its kernels by
    ``torch.profiler``: for a function that waits on the host between its
    launches, where an event pair would count those waits.  None when the
    profiler sees no device activity."""

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.device_time_total for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return total_us / 1e3 / runs if total_us > 0 else None


def paired_ms(kernel, plain, runs: int = RUNS, plain_runs: int = RUNS):
    """(kernel ms, plain ms), each the mean of two medians taken in the
    order plain, kernel, kernel, plain."""

    p1 = time_ms(plain, plain_runs, warmup=1)
    k1, k2 = time_ms(kernel, runs), time_ms(kernel, runs)
    p2 = time_ms(plain, plain_runs, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def exact(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Max absolute difference, which must be 0, with equal shape and dtype
    (float tensors are compared by their bits)."""

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{name}: got {tuple(got.shape)} {got.dtype}, want {tuple(want.shape)} {want.dtype}"
        )
    if got.dtype in (torch.float32, torch.float64):
        bits = torch.int32 if got.dtype == torch.float32 else torch.int64
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError(f"{name}: max abs err {float((got - want).abs().max())}")
        return 0
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: max abs err {err}")
    return err


def sha256(array) -> str:
    if isinstance(array, torch.Tensor):
        array = array.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def check_digest(name: str, array) -> None:
    got = sha256(array)
    if got != DIGESTS[name]:
        raise AssertionError(f"{name}: sha256 {got}, the JAX package's is {DIGESTS[name]}")


def dense_scene(side: int, seed: int = 3) -> np.ndarray:
    """A copy of ``bench.py:_dense_scene``: a grid of noisy disks, 128
    apart (the segmentation benchmarks' input)."""

    rng = np.random.default_rng(seed)
    img = np.zeros((side, side), np.uint8)
    pitch = 128
    for cy in range(pitch // 2, side, pitch):
        for cx in range(pitch // 2, side, pitch):
            r = 40 + int(rng.integers(0, 12))
            y0, y1 = max(0, cy - r), min(side, cy + r + 1)
            x0, x1 = max(0, cx - r), min(side, cx + r + 1)
            yy, xx = np.ogrid[y0:y1, x0:x1]
            box = img[y0:y1, x0:x1]
            box[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 170 + int(rng.integers(0, 60))
    noise = rng.integers(-12, 13, img.shape, dtype=np.int16)
    return (img.astype(np.int16) + noise).clip(0, 255).astype(np.uint8)


def single_marker(side: int, dev):
    """A flat frame with one marker in a corner, and its markers: the
    flood's front crosses the frame one pixel a sweep (the tile skipping's
    worst case, about 2 * side sweeps)."""

    img = torch.full((1, side, side), 40, dtype=torch.uint8, device=dev)
    markers = torch.zeros((1, side, side), dtype=torch.int32, device=dev)
    markers[0, 1, 1] = 2
    return img, markers


def clahe_steps():
    """The CLAHE chain as ``bench.py:445-463`` builds it: Gaussian 5x5 ->
    CLAHE (clip 2.0, grid 4) -> the mean of R and G."""

    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    return [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        ),
        PipelineStep(
            name="CLAHE",
            op_id="preprocessing.clahe",
            stage=Stage.PREPROCESSING,
            params={"clip_limit": CLAHE_CLIP, "grid_size": CLAHE_GRID},
        ),
        PipelineStep(
            name="SelectChannel",
            op_id="preprocessing.select_channel",
            stage=Stage.PREPROCESSING,
            params={"value": "RG"},
        ),
    ]


def clahe_frames(shape) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)


def denoise_steps(apply_crop: bool):
    """Grayscale -> Median 5 -> Sharpen 1.0 -> Normalize 0..255 -> Crop
    (``apply_crop`` False: the preview overlay; True: the slice)."""

    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    p = Stage.PREPROCESSING
    return [
        PipelineStep(name="Grayscale", stage=p),
        PipelineStep(name="NoiseReduction", stage=p, params={"method": "Median", "ksize": 5}),
        PipelineStep(name="Sharpen", stage=p, params={"strength": 1.0}),
        PipelineStep(name="IntensityNormalization", stage=p, params={"alpha": 0.0, "beta": 255.0}),
        PipelineStep(name="Crop", stage=p, params={**CROP_BOX, "apply_crop": apply_crop}),
    ]


def bilateral_steps():
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    return [PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING,
                         params={"method": "Bilateral", "ksize": 5})]


def denoise_frames() -> np.ndarray:
    """The denoise and bilateral paths' BGR batch (8 x 2048^2 x 3)."""

    return np.random.default_rng(0).integers(0, 256, DENOISE_SHAPE, dtype=np.uint8)


def bilateral_tables(ksize: int, dev):
    """(space weights, colour table) of the Bilateral split, on ``dev``."""

    from yamimageprocessor_tpu_torch.ops.registry import dyn_to_torch, get_impl

    _, dyn = get_impl("preprocessing.noise_reduction").split({"method": "Bilateral", "ksize": ksize})
    d = dyn_to_torch(dyn, dev)
    return d["space_w"], d["color_lut"]


def bound_ms(nbytes: float, f32_ops: float = 0.0, int_ops: float = 0.0, *, f32_inst: float = 0.0,
             minmax: float = 0.0, minmax_rate: float = INT32_OPS_PER_S, wavefronts: float = 0.0,
             f64_inst: float = 0.0):
    """(least time in ms, what bounds it) on an H100 SXM: the bytes at the
    memory rate, and on their own pipes float32 operations (an FMA two) or
    FP32 instructions (an FMA one), FP64 instructions, int32 operations,
    packed min and max operations at ``minmax_rate`` (measured by
    :func:`minmax_rate`) and shared-memory wavefronts, whichever is
    longest."""

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(f32_ops / F32_OPS_PER_S, f32_inst / F32_INST_PER_S, int_ops / INT32_OPS_PER_S,
                minmax / minmax_rate, wavefronts / SHARED_WAVEFRONTS_PER_S, f64_inst / F64_INST_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def minmax_rate(dev) -> float:
    """Packed 16x2 min and max operations a second on the card, from
    ``yam_vminmax_rate`` (independent compare-exchange chains on every
    SM)."""

    from yamimageprocessor_tpu_torch import _build

    out = torch.empty(RATE_BLOCKS * 256, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: _build.launch("yam_vminmax_rate", dev, out.data_ptr(), RATE_BLOCKS, RATE_ROUNDS), runs=5)
    return RATE_BLOCKS * 256 * RATE_ROUNDS * 16 / (ms / 1e3)


def median_bound(px: float, ksize: int, rate: float):
    """(bound ms, by) of the median of ``px`` uint8 pixels: bytes in and out;
    up to ksize 9 the packed min and max ops of :data:`MEDIAN_PACKED_OPS`,
    above it the sliding histogram's :data:`MEDIAN_HISTOGRAM_OPS` at the
    int32 rate, whatever the window."""

    if ksize in MEDIAN_PACKED_OPS:
        return bound_ms(2 * px, minmax=MEDIAN_PACKED_OPS[ksize] * px, minmax_rate=rate)
    return bound_ms(2 * px, int_ops=MEDIAN_HISTOGRAM_OPS * px)


def bilateral_bound(px: float, offsets: int, channels: int):
    """(bound ms, by) of the bilateral filter of ``px`` uint8 pixels: bytes
    in and out; a pixel's offset takes 2 + C FP32 instructions (the weight's
    multiply, the sum's add, C fused multiply-adds), one int32 operation for
    the distance (one per-byte sum of absolute differences) and 1/32 of a
    shared-memory wavefront for the colour table's read."""

    n = offsets * px
    return bound_ms(2 * channels * px, f32_inst=(2 + channels) * n, int_ops=n, wavefronts=n / 32)


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
        f"numpy {np.__version__} devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})"
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


def _spiral(side: int) -> np.ndarray:
    fg = np.zeros((side, side), np.uint8)
    top, bottom, left, right = 0, side - 1, 0, side - 1
    while top < bottom and left < right:
        fg[top, left : right + 1] = 1
        fg[top : bottom + 1, right] = 1
        fg[bottom, left : right + 1] = 1
        fg[top : bottom + 1, left] = 1
        top, bottom, left, right = top + 4, bottom - 4, left + 4, right - 4
    return fg


def _watershed_inputs(imgs: torch.Tensor):
    """(opening, markers) the watershed step builds from ``(B, H, W)``
    gray frames: the distance kernel's input and the flood's markers."""

    from yamimageprocessor_tpu_torch.ops import morphology as M
    from yamimageprocessor_tpu_torch.ops.segmentation import watershed_markers
    from yamimageprocessor_tpu_torch.ops.threshold import binary, otsu_threshold

    se = np.ones((3, 3), np.uint8)
    opening = M.open_(binary(imgs, otsu_threshold(imgs), inverse=True), se, 2).contiguous()
    factor = torch.tensor(0.7, dtype=torch.float32, device=imgs.device)
    return opening, watershed_markers(imgs, factor)


def _closed_mask(scene: torch.Tensor) -> torch.Tensor:
    """The segmentation chain's mask before the watershed (Otsu -> open ->
    close): the watershed step's input on the main path."""

    from yamimageprocessor_tpu_torch.models.stages import segmentation_steps
    from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain

    steps = segmentation_steps(watershed=False)
    fn, dyn = get_compiled_chain(steps, scene.shape, np.uint8, batch=1, device=scene.device).pure_callable()
    return fn(scene, dyn)[-1].contiguous()


def cc_inputs(dev) -> dict:
    """The masks CC is checked and timed on, each ``(N, H, W)`` uint8: the
    segmentation chain's sure foreground (the main path's input), the
    scene's opening (larger components), 55% noise, the spiral (one long
    component), an all-foreground frame (the worst case for hot roots) and
    the sure foregrounds of a batch of scenes."""

    scene = torch.from_numpy(dense_scene(SEG_SIDE)).to(dev)[None]
    opening, markers = _watershed_inputs(_closed_mask(scene))
    scenes = [torch.from_numpy(dense_scene(SEG_SIDE, seed=k)).to(dev)[None] for k in range(CC_BATCH)]
    batch_markers = _watershed_inputs(torch.cat([_closed_mask(s) for s in scenes]))[1]
    noise = np.random.default_rng(5).random((1, SEG_SIDE, SEG_SIDE)) < 0.55
    return {
        CC_MAIN: (markers > 1).to(torch.uint8),
        "scene opening 2048^2": (opening > 0).to(torch.uint8),
        "55% noise 2048^2": torch.from_numpy(noise.astype(np.uint8)).to(dev),
        "spiral 1024^2": torch.from_numpy(_spiral(1024)).to(dev)[None],
        "all foreground 2048^2": torch.ones((1, SEG_SIDE, SEG_SIDE), dtype=torch.uint8, device=dev),
        f"sure foregrounds of {CC_BATCH} scenes 2048^2": (batch_markers > 1).to(torch.uint8),
    }


def bench_y_planes(dev) -> torch.Tensor:
    """The CLAHE path's Y planes: the bench's frames after the Gaussian."""

    from yamimageprocessor_tpu_torch.ops.color import bgr_to_ycrcb
    from yamimageprocessor_tpu_torch.ops.registry import dyn_to_torch, get_impl
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8_planes

    _, dyn = get_impl("preprocessing.noise_reduction").split({"method": "Gaussian", "ksize": 5})
    t5 = dyn_to_torch(dyn, dev)["taps"]
    bgr = torch.from_numpy(clahe_frames(CLAHE_SHAPE)).to(dev)
    return bgr_to_ycrcb(sep_filter_u8_planes(bgr, t5, t5))[..., 0].contiguous()


def blend_inputs(y, grid, clip):
    """(frames padded to the grid, their uint8 tables, the interpolation
    arrays): the blend's inputs for ``(B, h, w)`` uint8 planes."""

    from yamimageprocessor_tpu_torch.ops import clahe as CL

    work = CL.pad_to_grid(y, grid)
    h, w = work.shape[1:]
    hist = CL.tile_histograms_plain(work, grid)
    luts = CL.clip_and_lut(hist, clip, (h // grid[0]) * (w // grid[1])).to(torch.uint8)
    return work, luts, CL.interp_tensors(h, w, grid, y.shape[1], y.shape[2], y.device)


def time_cc_and_blend(cc_cases: dict, blend: tuple) -> dict:
    """Device ms of CC on each of ``cc_cases`` and of the blend on the
    bench's Y planes (``blend``: its inputs)."""

    from yamimageprocessor_tpu_torch.ops.clahe import clahe_blend
    from yamimageprocessor_tpu_torch.ops.labeling import cc_min_index

    times = {f"cc {name}": time_ms(lambda fg=fg: cc_min_index(fg)) for name, fg in cc_cases.items()}
    times[f"clahe_blend bench Y {tuple(blend[0].shape)} grid {CLAHE_GRID}"] = time_ms(lambda: clahe_blend(*blend))
    return times


def histogram_cases(dev) -> dict:
    """The frames histogram256 is timed on, each ``(N, L)`` uint8: the
    flagship chain's (its batch after the Gaussian), uniform bytes (the
    flagship input), the segmentation chain's two (the scene, for Otsu,
    and the closed mask, for the markers' Otsu), and a constant frame."""

    from yamimageprocessor_tpu_torch.ops.registry import dyn_to_torch, get_impl
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8

    _, dyn = get_impl("preprocessing.noise_reduction").split({"method": "Gaussian", "ksize": 5})
    t5 = dyn_to_torch(dyn, dev)["taps"]
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, FLAGSHIP_SHAPE, dtype=np.uint8)).to(dev)
    scene = torch.from_numpy(dense_scene(SEG_SIDE)).to(dev)[None]
    n = FLAGSHIP_SHAPE[0]
    return {
        HIST_MAIN: sep_filter_u8(images, t5, t5).view(n, -1),
        "uniform (8,2048^2)": images.view(n, -1),
        "scene 2048^2": scene.view(1, -1),
        "closed mask 2048^2": _closed_mask(scene).reshape(1, -1).contiguous(),
        "constant 2048^2": torch.full((1, SEG_SIDE * SEG_SIDE), 77, dtype=torch.uint8, device=dev),
        HIST_ONE: images[:1].view(1, -1),
    }


def empty_launch_ms(dev):
    """Device ms of an empty kernel launched through ``_build.launch``: the
    fixed cost of a launch (None for a checkout without one)."""

    from yamimageprocessor_tpu_torch import _build

    if "yam_empty" not in _build.SIGNATURES:
        return None
    return time_ms(lambda: _build.launch("yam_empty", dev))


#: substrings of the kernels' names in a profiler trace, by group
_FLAGSHIP_GROUPS = {
    "sepconv_": "sepconv",
    "histogram256_kernel": "histogram256",
    "lut_apply_kernel": "lut_apply",
}
_SEG_GROUPS = {
    "histogram256_kernel": "histogram256",
    "chamfer_kernel": "distance",
    "cc_local": "cc",
    "cc_border": "cc",
    "cc_compress": "cc",
    "flood_kernel": "flood",
}
_EDGE_GROUPS = {
    "gradient_window": "gradient",
    "gradient_tile": "gradient",
    "canny_window": "canny_candidates",
    "adaptive_": "adaptive_threshold",
    "grow_": "region_grow",
    "cc_local": "cc",
    "cc_border": "cc",
    "cc_compress": "cc",
}
_CLAHE_GROUPS = {
    "sepconv_": "sepconv",
    "tile_histogram_kernel": "tile_histogram",
    "clahe_blend_kernel": "clahe_blend",
}


def chain_profiles(dev) -> dict:
    """Kernels a call and device ms by group of the flagship chain (a batch)
    and the segmentation chain (a frame), from ``torch.profiler``, and the
    ms a call of each back to back (the segmentation chain on one scene)."""

    from yamimageprocessor_tpu_torch.models.stages import flagship_chain, segmentation_chain

    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, FLAGSHIP_SHAPE, dtype=np.uint8)).to(dev)
    fn, dyn = flagship_chain(FLAGSHIP_SHAPE, dev)
    scene = torch.from_numpy(dense_scene(SEG_SIDE)).to(dev)[None]
    seg_fn, seg_dyn = segmentation_chain(scene.shape, dev)
    profiles = {
        "flagship": chain_profile(lambda: fn(images, dyn), _FLAGSHIP_GROUPS),
        "segmentation": chain_profile(lambda: seg_fn(scene, seg_dyn), _SEG_GROUPS),
    }
    profiles["flagship"]["back_to_back_ms"] = back_to_back_ms(lambda: fn(images, dyn))
    profiles["segmentation"]["back_to_back_ms"] = back_to_back_ms(lambda: seg_fn(scene, seg_dyn), calls=SEG_FRAMES)
    return profiles


def time_filters(dev, digests: dict) -> dict:
    """Device ms ``{"median": {ksize: ms}, "bilateral": {ksize: ms}}`` of
    the median at every ksize of :data:`MEDIAN_KSIZES` on the denoise
    path's gray frames and of the bilateral filter at every ksize of
    :data:`BILATERAL_KSIZES` on its BGR batch; each output's SHA-256 goes
    into ``digests``."""

    from yamimageprocessor_tpu_torch.ops.bilateral import bilateral_filter
    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
    from yamimageprocessor_tpu_torch.ops.median import median_filter

    bgr = torch.from_numpy(denoise_frames()).to(dev)
    gray = bgr_to_gray(bgr).contiguous()
    times = {"median": {}, "bilateral": {}}
    for k in MEDIAN_KSIZES:
        digests[f"median k{k} (8,2048,2048)"] = sha256(median_filter(gray, k))
        times["median"][k] = time_ms(lambda k=k: median_filter(gray, k), runs=5)
    for k in BILATERAL_KSIZES:
        tables = bilateral_tables(k, dev)
        digests[f"bilateral k{k} (8,2048,2048,3)"] = sha256(bilateral_filter(bgr, *tables, k))
        times["bilateral"][k] = time_ms(lambda k=k: bilateral_filter(bgr, *tables, k), runs=5)
    return times


def filter_cases(dev) -> dict:
    """CC, the blend, histogram256, the median and the bilateral filter on
    :func:`cc_inputs`, the bench's Y planes, :func:`histogram_cases` and
    the denoise path's frames (:func:`time_filters`): device ms and a
    SHA-256 of every output, an empty launch's time, and the kernels a call
    and back-to-back ms of the flagship and segmentation chains."""

    from yamimageprocessor_tpu_torch import cuda_kernels as ck
    from yamimageprocessor_tpu_torch.ops.clahe import clahe_blend
    from yamimageprocessor_tpu_torch.ops.labeling import cc_min_index

    cc_cases = cc_inputs(dev)
    blend = blend_inputs(bench_y_planes(dev), (CLAHE_GRID, CLAHE_GRID), CLAHE_CLIP)
    hist_cases = histogram_cases(dev)
    digests = {name: sha256(cc_min_index(fg)) for name, fg in cc_cases.items()}
    digests["clahe_blend"] = sha256(clahe_blend(*blend))
    digests.update({f"histogram256 {name}": sha256(ck.histogram256_batch(f)) for name, f in hist_cases.items()})
    times = time_cc_and_blend(cc_cases, blend)
    times.update({f"histogram256 {name}": time_ms(lambda f=f: ck.histogram256_batch(f)) for name, f in hist_cases.items()})
    times["empty launch"] = empty_launch_ms(dev)
    filters = time_filters(dev, digests)
    times.update({f"median k{k} (8,2048,2048)": ms for k, ms in filters["median"].items()})
    times.update({f"bilateral k{k} (8,2048,2048,3)": ms for k, ms in filters["bilateral"].items()})
    profiles = chain_profiles(dev)
    for name, split in profiles.items():
        print_profile(name, split)
    return {"times": times, "digests": digests,
            "kernels_a_call": {name: split["kernels"] for name, split in profiles.items()},
            "back_to_back_ms": {name: split["back_to_back_ms"] for name, split in profiles.items()}}


def extraction_cases(dev) -> dict:
    """The hull and annotation kernels on every extraction label set:
    device ms and a SHA-256 of every output, each set's tallest region's
    rows, and the peak device memory of ``region_tables`` on the blobs
    frame."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD
    from yamimageprocessor_tpu_torch.ops import regionprops as RP

    blobs = blobs_frame()
    sets = extraction_label_sets(dev, extraction_frame(), {n: [extraction_frame(seed=s) for s in range(n)]
                                                             for n in EXTRACT_BATCHES},
                                 extraction_frame(EXTRACT_WIDE_SIDE), blobs)
    times, digests, rows = {}, {}, {}
    for name, (labels, imgs) in sets.items():
        case = measured_case(labels, imgs)
        digests[f"hull_areas {name}"] = sha256(hull_of(RP, case))
        digests[f"annotate {name}"] = sha256(XD.region_annotate(imgs, case["boxes"]))
        times[f"hull_areas {name}"] = time_ms(lambda: hull_of(RP, case))
        times[f"annotate {name}"] = time_ms(lambda: XD.region_annotate(imgs, case["boxes"]))
        rows[name] = longest_rows(case)
    del case, sets
    return {"times": times, "digests": digests, "longest_rows": rows, "blobs_peak_memory": blobs_peak_memory(blobs)}


def texture_cases(dev) -> dict:
    """The dense filter, the LBP codes, HOG cells (9 bins 8x8 on the 32
    gray scenes and a 2048^2 frame, 32 bins 2x2) and GLCM counts (one scene
    and a flat frame at (1, 0), distance 64, 8 scenes) on the texture
    phase's 32 gray scenes (and 4 as float32): device ms and a SHA-256 of
    every output; the HOG, Gabor and Hu-moments tables' host ms a frame on
    :data:`TEXTURE_TIMED_TABLE_FRAMES` scenes (not compared: an older
    checkout's float64 columns need not be the reference's bits)."""

    from yamimageprocessor_tpu_torch.ops import hogf as HG
    from yamimageprocessor_tpu_torch.ops import texture as TX
    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
    from yamimageprocessor_tpu_torch.ops.filter2d_cuda import filter2d_u8
    from yamimageprocessor_tpu_torch.ops.registry import get_impl
    from yamimageprocessor_tpu_torch.ops.tables import gabor_kernel

    frames = np.stack([extraction_frame(seed=s) for s in range(TEXTURE_FRAMES)])
    gray = bgr_to_gray(torch.from_numpy(frames).to(dev)).contiguous()
    small = gray[:1, :FILTER_SMALL_SIDE, :FILTER_SMALL_SIDE].contiguous()
    floats = (gray[:TEXTURE_DTYPE_FRAMES].to(torch.float32) * 0.731).contiguous()
    taps = {k: torch.from_numpy(gabor_kernel(k, 5.0, 0.0, 10.0, 0.5, 0.0)).to(dev) for k in FILTER_KSIZES}
    cases = {
        "filter2d ksize 21": lambda: filter2d_u8(gray, taps[21], xla_order=True),
        "filter2d ksize 21 numpy order": lambda: filter2d_u8(gray, taps[21], xla_order=False),
        "filter2d ksize 3": lambda: filter2d_u8(gray, taps[3], xla_order=True),
        f"filter2d ksize 101 on {FILTER_SMALL_SIDE}^2": lambda: filter2d_u8(small, taps[101], xla_order=True),
        f"filter2d ksize 101 on {TEXTURE_DTYPE_FRAMES} scenes": lambda: filter2d_u8(
            gray[:TEXTURE_DTYPE_FRAMES], taps[101], xla_order=True),
        f"filter2d ksize 21 float32 {TEXTURE_DTYPE_FRAMES} scenes": lambda: filter2d_u8(floats, taps[21], xla_order=True),
    }
    for p, r in LBP_CASES:
        for golden in (False, True):
            cases[f"lbp_codes P{p} R{r}{' golden' if golden else ''}"] = (
                lambda p=p, r=r, golden=golden: TX.lbp_codes(gray, p, r, golden=golden))
    cases[f"lbp_codes P8 R1.0 float32 {TEXTURE_DTYPE_FRAMES} scenes"] = lambda: TX.lbp_codes(floats, 8, 1.0)
    wide = bgr_to_gray(torch.from_numpy(extraction_frame(HOG_WIDE_SIDE))[None].to(dev)).contiguous()
    flat = torch.full((1, EXTRACT_SIDE, EXTRACT_SIDE), 77, dtype=torch.uint8, device=dev)
    cases.update({
        "hog_cells 9 bins 8x8": lambda: HG.hog_cells(gray, 9, 8),
        "hog_cells 32 bins 2x2": lambda: HG.hog_cells(gray, 32, 2),
        f"hog_cells 9 bins 8x8 on {HOG_WIDE_SIDE}^2": lambda: HG.hog_cells(wide, 9, 8),
        "glcm_counts one scene (1, 0)": lambda: TX.glcm_counts(gray[:1], 1, 0),
        "glcm_counts flat (1, 0)": lambda: TX.glcm_counts(flat, 1, 0),
        "glcm_counts distance 64": lambda: TX.glcm_counts(gray[:1], 64, 0),
        "glcm_counts 8 scenes": lambda: TX.glcm_counts(gray[:8], 1, 0),
    })
    times, digests = {}, {}
    for name, fn in cases.items():
        digests[name] = sha256(fn())
        times[name] = time_ms(fn)
    tables_ms = {}
    for op in ("hog", "gabor", "hu_moments"):
        fn = get_impl(f"extraction.{op}").data_fn
        fn(frames[0])  # warm-up: the first call builds what it needs
        torch.cuda.synchronize()
        start = time.perf_counter()
        for f in frames[:TEXTURE_TIMED_TABLE_FRAMES]:
            fn(f)
        torch.cuda.synchronize()
        tables_ms[op] = (time.perf_counter() - start) * 1e3 / TEXTURE_TIMED_TABLE_FRAMES
    return {"times": times, "digests": digests, "tables_ms": tables_ms}


def shape_cases(dev) -> dict:
    """The contour trace (the 32 scenes' labels, the blobs, the 4001-row
    disk), the Fourier lines (the 32 scenes' largest contours and the
    disk's, at num_coeff 10 and 512) and the mean boundary errors (frame
    0's 64 x 20 candidates, the disk's 20), each the wrapper's launch object:
    device ms and each case's split by launch (:func:`launch_split`), the
    trace's output digests and the rounded reconstructions' digests (the
    lines themselves may differ in their last bits between designs; each is
    held to its own plain version here); the host-clock ms of a whole
    ``trace_contours`` call (its launch object built, its reads back) and
    its host split (:func:`host_split`); and
    the Fourier chain's host-clock ms on the 32 scenes (labels, trace,
    lines, paint and reads back); the errors' output digests and routes;
    the approximate-shape table's host split (:func:`approximate_shape_split`)."""

    from yamimageprocessor_tpu_torch.ops import extraction as EXT
    from yamimageprocessor_tpu_torch.ops import polygon as PG
    from yamimageprocessor_tpu_torch.ops import shape as SH
    from yamimageprocessor_tpu_torch.ops.contours import TraceLaunch, trace_contours
    from yamimageprocessor_tpu_torch.ops.extraction_device import region_count_bound, region_labels
    from yamimageprocessor_tpu_torch.ops.fourier import LinesLaunch, fourier_lines
    from yamimageprocessor_tpu_torch.ops.labeling import label
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    frames = np.stack([extraction_frame(seed=s) for s in range(TEXTURE_FRAMES)])
    sets = {"32 scenes": region_labels(torch.from_numpy(frames).to(dev)).contiguous(),
            f"blobs {BLOBS_SIDE}^2": region_labels(torch.from_numpy(blobs_frame())[None].to(dev)).contiguous(),
            f"tall disk {TALL_SIDE}^2": label(torch.from_numpy(np.ascontiguousarray(tall_disk_mask())).to(dev)
                                              ).contiguous()}
    times, digests, splits, traced, host = {}, {}, {}, {}, {}
    for name, lab in sets.items():
        n = region_count_bound(lab)
        traced[name] = trace_contours(lab, n)
        digests[f"trace_contours {name}"] = sha256(torch.cat([t.reshape(-1).to(torch.int64) for t in traced[name]]))
        launch = TraceLaunch(lab, n)
        times[f"trace_contours {name}"] = time_ms(launch.run)
        splits[f"trace_contours {name}"] = launch_split(launch.run)
        host[f"trace_contours {name}"] = wall_ms(lambda: trace_contours(lab, n), calls=RUNS)
        splits[f"trace_contours {name} on the host"] = host_split(lambda: trace_contours(lab, n))
    cont = traced["32 scenes"]
    offsets = cont.offsets.cpu().numpy()
    largest = EXT._largest(cont.frames.cpu().numpy(), cont.area2.cpu().numpy(), len(frames))
    main_pts, main_offs = EXT._gather(cont.points, offsets, largest[largest >= 0])
    disk = traced[f"tall disk {TALL_SIDE}^2"]
    for name, pts, offs in (("32 scenes", main_pts, main_offs), ("tall disk", disk.points, disk.offsets.cpu().tolist())):
        for k in SHAPE_COEFFS:
            fourier_kernel_vs_plain(name, pts, offs, k)
            digests[f"fourier_lines {name} {k} rounded"] = sha256(torch.round(fourier_lines(pts, offs, k)[2]))
            launch = LinesLaunch(pts, offs, k)
            times[f"fourier_lines {name}, num_coeff {k}"] = time_ms(launch.run)
            splits[f"fourier_lines {name}, num_coeff {k}"] = launch_split(launch.run)
    manager = PipelineManager(fourier_steps(SHAPE_COEFFS[0]), device=dev)
    digests["fourier chain"] = sha256(manager.apply(frames))
    chain = {f"{len(frames)} frames, num_coeff {SHAPE_COEFFS[0]}": wall_ms(lambda: manager.apply(frames),
                                                                           calls=SHAPE_CHAIN_CALLS)}
    disk_offs = disk.offsets.cpu().tolist()
    disk_cands = SH.candidate_polygons(disk.points.cpu().numpy().astype(np.int64),
                                       SH.farthest_pairs(disk.points, disk_offs)[0])
    verts, vert_offsets = PG.pack_candidates(disk_cands)
    cases = {"frame 0": EXT.shape_candidates(frames[0], device=dev)[2],
             "tall disk": (disk.points, disk_offs, verts.to(dev), vert_offsets,
                           torch.zeros(len(disk_cands), dtype=torch.int64))}
    for name, args in cases.items():
        launch = PG.ErrorsLaunch(*args)
        launch.run()
        digests[f"polygon_mean_errors {name}"] = sha256(launch.out)
        times[f"polygon_mean_errors {name}"] = time_ms(launch.run)
        splits[f"polygon_mean_errors {name}"] = launch_split(launch.run)
        if hasattr(launch, "counts"):
            splits[f"polygon_mean_errors {name} routes"] = launch.counts()
    return {"times": times, "digests": digests, "trace_host_ms": host, "chain_host_ms": chain, "split": splits,
            "table_host_ms": approximate_shape_split(frames[:SHAPE_TABLE_FRAMES], dev)}


def approximate_shape_split(frames, dev) -> dict:
    """The approximate-shape table's host-clock ms a frame by part, from
    ``ops/extraction.py:approximate_shape_data`` itself: while it runs, the
    functions it calls are wrapped by timers, each part its own time less
    that of the parts it calls: ``trace`` (``_contours``: labels, the trace
    and its reads back), ``gather`` and ``farthest_pairs`` (the kept
    contours', on the card), ``douglas_peucker`` (``candidate_polygons``, 20
    candidates a contour), ``pack``, the errors call's ``errors plan and
    upload`` (``ErrorsLaunch``) and ``errors launch and wait`` (the launch,
    then a wait for the card, which the read back would make), ``selection
    and measures`` (``select_epsilon``, ``contour_area``, ``arc_length``);
    ``rest``: the rest of ``whole``, the table's own call a frame (the
    frame's upload, the read back, the edges' lengths, the columns)."""

    from yamimageprocessor_tpu_torch.ops import extraction as EXT
    from yamimageprocessor_tpu_torch.ops import polygon as PG
    from yamimageprocessor_tpu_torch.ops import shape as SH

    parts, inner = defaultdict(float), [0.0]

    def timed(name, fn, wait=False):
        def call(*args, **kwargs):
            outer, inner[0] = inner[0], 0.0
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if wait:
                torch.cuda.synchronize()
            took = time.perf_counter() - start
            parts[name] += (took - inner[0]) * 1e3
            inner[0] = outer + took
            return out
        return call

    wraps = [(EXT, "_contours", "trace"), (EXT, "_gather", "gather"), (SH, "farthest_pairs", "farthest_pairs"),
             (SH, "candidate_polygons", "douglas_peucker"), (EXT, "pack_candidates", "pack"),
             (PG, "ErrorsLaunch", "errors plan and upload"), (EXT, "polygon_mean_errors", "errors launch and wait"),
             (SH, "select_epsilon", "selection and measures"), (SH, "contour_area", "selection and measures"),
             (SH, "arc_length", "selection and measures")]
    saved = [(module, attr, getattr(module, attr)) for module, attr, _ in wraps]
    EXT.approximate_shape_data(frames[0], SHAPE_THRESHOLD, device=dev)  # warm
    torch.cuda.synchronize()
    try:
        for (module, attr, name), (_, _, fn) in zip(wraps, saved):
            setattr(module, attr, timed(name, fn, wait=attr == "polygon_mean_errors"))
        start = time.perf_counter()
        for f in frames:
            EXT.approximate_shape_data(f, SHAPE_THRESHOLD, device=dev)
        whole = (time.perf_counter() - start) * 1e3
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    out = {name: ms / len(frames) for name, ms in parts.items()}
    out["rest"] = (whole - sum(parts.values())) / len(frames)
    out["whole"] = whole / len(frames)
    return out


def l2_flush(dev):
    """A function that evicts the card's 50 MB L2 by writing a 128 MiB
    buffer: called before a run's sleep, it leaves the run's inputs in
    device memory only (the write is outside the event pair)."""

    junk = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    return lambda: junk.fill_(1)


def stream_tile_cases(dev) -> dict:
    """The stream kernels' inputs on the 16380^2 CLAHE slide's geometry
    (grid 8, 2048^2 stream tiles), as the generic route batches them: name
    -> (tiles, origins).  The middle row's 7 tiles (its fourth row), the last
    row's 7 (the mirror rows: 2044 rows), the corner tile (2044^2: the
    mirror rows and columns), and the middle row as float32 (uint8 levels
    plus a fraction in [0, 1)) and as uint16 (uint8 levels): both with one
    pixel in 4096 outside 0..255 (-3.7 or 300.5 in float32, 300 or 65535
    in uint16), which the histogram adds straight to the output and the
    blend gives level 0's entry.  Seeded on the card."""

    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    side, (tw, th) = STREAM_CLAHE_SIDE, STREAM_TILE
    per_row, last = -(-side // tw) - 1, (side // th) * th  # 7 full tiles a row; the last row's top
    edge = side - last

    def levels(n, h, w):
        return torch.randint(0, 256, (n, h, w), generator=gen, device=dev, dtype=torch.uint8)

    def sprinkle(shape):
        return torch.randint(0, 4096, shape, generator=gen, device=dev) == 0

    middle = levels(per_row, th, tw)
    outside = sprinkle(middle.shape)
    other = torch.randint(0, 2, middle.shape, generator=gen, device=dev).bool()
    frac = torch.rand(middle.shape, generator=gen, device=dev)
    f32 = middle.to(torch.float32) + frac
    f32 = torch.where(outside, torch.where(other, -3.7, 300.5), f32).contiguous()
    u16 = middle.to(torch.int32)
    u16 = torch.where(outside, torch.where(other, 300, 65535), u16).to(torch.uint16).contiguous()
    middle_o = [(3 * th, k * tw) for k in range(per_row)]
    return {
        "middle row": (middle, middle_o),
        "last row": (levels(per_row, edge, tw), [(last, k * tw) for k in range(per_row)]),
        "corner": (levels(1, edge, edge), [(last, last)]),
        "middle row float32": (f32, middle_o),
        "middle row uint16": (u16, middle_o),
    }


def stream_cases(dev) -> dict:
    """The two stream kernels on :func:`stream_tile_cases`: device ms of
    the histogram and of the blend (tables from the middle row's merged
    histograms) on each case, the middle row also with the card's L2
    evicted before each run (``cold``: its 29.4 MB fit the 50 MB L2, so the
    plain runs repeat on a warm L2); a device-to-device copy of the middle
    row's bytes (the rate the blend's bytes can reach); digests of every
    output.  A case that a checkout's wrappers refuse (the uint8-only
    stream kernels before float32 and uint16 frames) times None."""

    from yamimageprocessor_tpu_torch.ops import clahe as CL

    frame, grid = (STREAM_CLAHE_SIDE, STREAM_CLAHE_SIDE), (8, 8)
    cases = stream_tile_cases(dev)
    middle, middle_o = cases["middle row"]
    luts = CL.clahe_stream_luts(CL.grid_hist_stream(middle, middle_o, frame, grid), 40.0, frame, grid)
    flush = l2_flush(dev)
    times, digests, counts = {}, {}, {}
    for name, (t, o) in cases.items():
        counts[name] = t.numel()
        try:
            hist = CL.grid_hist_stream(t, o, frame, grid)
            blended = CL.clahe_stream_blend(t, luts, o, frame, grid)
        except ValueError as err:
            print(f"{name}: refused ({err})")
            times[f"stream_grid_histogram {name}"] = times[f"clahe_stream_blend {name}"] = None
            continue
        digests[f"stream_grid_histogram {name}"] = sha256(hist)
        digests[f"clahe_stream_blend {name}"] = sha256(blended)
        times[f"stream_grid_histogram {name}"] = time_ms(lambda: CL.grid_hist_stream(t, o, frame, grid))
        times[f"clahe_stream_blend {name}"] = time_ms(lambda: CL.clahe_stream_blend(t, luts, o, frame, grid))
    copy = torch.empty_like(middle)
    times["copy middle row"] = time_ms(lambda: copy.copy_(middle))
    for kernel, fn in (("stream_grid_histogram", lambda: CL.grid_hist_stream(middle, middle_o, frame, grid)),
                       ("clahe_stream_blend", lambda: CL.clahe_stream_blend(middle, luts, middle_o, frame, grid)),
                       ("copy", lambda: copy.copy_(middle))):
        times[f"{kernel} middle row, L2 evicted"] = time_ms(fn, before=flush)
    return {"times": times, "digests": digests, "pixels": counts}


def times_one(phase: str, root: str) -> None:
    """Build the port of the checkout ``root`` and run the timed phase's
    cases (:data:`TIMED_PHASES`) on it; print their JSON as the last line."""

    sys.path.insert(0, root)
    dev = torch.device("cuda", 0)
    phase_build()
    import yamimageprocessor_tpu_torch as port

    print(json.dumps({"package": port.__file__, **TIMED_PHASES[phase](dev)}))


def _mean(values):
    return None if any(v is None for v in values) else sum(values) / len(values)


def times_in_turns(phase: str, roots) -> None:
    """Time the phase's cases on the checkouts ``roots`` (older ones,
    unpacked with ``git archive``) and on this one, in turns (the roots,
    this, this, the roots backwards; each a process of its own, its output
    printed), fail unless every output digest agrees, and print the mean of
    each checkout's two runs of every number (``times``, host ms, counts)."""

    import os

    smi = phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    order = list(roots) + [here, here] + list(reversed(roots))
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--times-one", phase, tree],
                             capture_output=True, text=True, check=True, timeout=1200)
        print(f"== {phase} on {tree}")
        print(out.stdout.strip())
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    for name, digest in runs[0]["digests"].items():
        if any(run["digests"].get(name) != digest for run in runs[1:]):
            raise AssertionError(f"{phase} times: {name} differs between {order}")
    trees = list(roots) + [here]
    summary = {}
    for key, table in runs[0].items():
        if key in ("package", "digests") or not isinstance(table, dict):
            continue
        if not all(v is None or isinstance(v, (int, float)) for run in runs for v in run[key].values()):
            continue  # nested tables (splits, kernels a call): printed above with each run
        summary[key] = {name: {tree: _mean([run[key][name] for t, run in zip(order, runs) if t == tree])
                               for tree in trees} for name in table}
        for name, row in summary[key].items():
            each = ", ".join("None" if run[key][name] is None else f"{run[key][name]:.4f}" for run in runs)
            print(f"{key} {name}: " + ", ".join(f"{tree} {'None' if v is None else f'{v:.4f}'}"
                                                for tree, v in row.items()) + f" (runs {each})")
    print(f"card: {smi}")
    print(json.dumps({"phase": phase, "order": order, **summary}))


def phase_kernels(dev) -> dict:
    from yamimageprocessor_tpu_torch import cuda_kernels as ck
    from yamimageprocessor_tpu_torch.ops import clahe as CL
    from yamimageprocessor_tpu_torch.ops.color import bgr_to_ycrcb
    from yamimageprocessor_tpu_torch.ops.distance import (
        MAX_WIDTH,
        ROWS_PER_CHUNK,
        distance_transform,
        distance_transform_plain,
    )
    from yamimageprocessor_tpu_torch.ops.labeling import cc_min_index, cc_min_index_plain
    from yamimageprocessor_tpu_torch.ops.registry import dyn_to_torch, get_impl
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import (
        sep_filter_u8,
        sep_filter_u8_plain,
        sep_filter_u8_planes,
        sep_filter_u8_planes_plain,
    )
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep
    from yamimageprocessor_tpu_torch.ops.watershed import TILE_COLS, TILE_ROWS, cost_planes, flood, flood_plain, tiles

    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def noise_mask(shape, fraction):
        return (torch.rand(shape, generator=gen, device=dev) < fraction).to(torch.uint8) * 255

    def taps(ksize):
        _, dyn = get_impl("preprocessing.noise_reduction").split({"method": "Gaussian", "ksize": ksize})
        return dyn_to_torch(dyn, dev)["taps"]

    def unaligned(shape):
        # contiguous frames whose base is 1 byte past a 16-byte boundary
        n = int(np.prod(shape))
        return rand((n + 1,))[1:].view(shape)

    big = rand(FLAGSHIP_SHAPE)
    odd = rand((3, 37, 1001))
    err = {
        name: 0
        for name in ("sepconv", "histogram256", "lut_apply", "distance", "cc", "flood", "tile_histogram", "clahe_blend")
    }

    # widths 7, 1001: not a multiple of 16; 1040: aligned rows, a 16-byte band
    # at the right; offset 1: the base 1 byte past alignment
    sep_frames = {
        f"{FLAGSHIP_SHAPE}": big,
        "(3,37,1001)": odd,
        "(2,5,7)": rand((2, 5, 7)),  # narrower and shorter than the halo: periodic reflection
        "(2,130,1040)": rand((2, 130, 1040)),
        "(2,70,2056) base+1": unaligned((2, 70, 2056)),
        "(1,64,1001) base+1": unaligned((1, 64, 1001)),
    }
    for ksize in SEPCONV_KSIZES:
        t = taps(ksize)
        for name, imgs in sep_frames.items():
            err["sepconv"] |= exact(f"sepconv k{ksize} {name}", sep_filter_u8(imgs, t, t), sep_filter_u8_plain(imgs, t, t))
    for c in (3, 4, 17):
        chan_frames = {f"(2,64,96,{c})": rand((2, 64, 96, c)), f"(1,41,101,{c}) base+1": unaligned((1, 41, 101, c))}
        for ksize in (3, 5, 7, 13):
            t = taps(ksize)
            for name, imgs in chan_frames.items():
                err["sepconv"] |= exact(
                    f"sepconv planes k{ksize} {name}",
                    sep_filter_u8_planes(imgs, t, t),
                    sep_filter_u8_planes_plain(imgs, t, t),
                )
    # rising taps: a pass that read its taps in reverse would differ; through
    # the templated instances (3, 5 and 7 in both passes) and the generic one
    for ky, kx in ((3, 3), (5, 5), (7, 7), (5, 3), (13, 9)):
        ty, tx = (torch.from_numpy(np.linspace(0.1, 0.9, k) / np.linspace(0.1, 0.9, k).sum()).float().to(dev)
                  for k in (ky, kx))
        for name, imgs in (("(3,37,1001)", odd), ("(1,41,101,3) base+1", unaligned((1, 41, 101, 3))),
                           ("(2,64,96,4)", rand((2, 64, 96, 4)))):
            got, want = (
                (sep_filter_u8(imgs, ty, tx), sep_filter_u8_plain(imgs, ty, tx)) if imgs.ndim == 3
                else (sep_filter_u8_planes(imgs, ty, tx), sep_filter_u8_planes_plain(imgs, ty, tx))
            )
            err["sepconv"] |= exact(f"sepconv asymmetric k{ky}x{kx} {name}", got, want)
    t5 = taps(5)
    # the CLAHE path's input, interleaved, as its Gaussian filters it
    bgr_bench = torch.from_numpy(clahe_frames(CLAHE_SHAPE)).to(dev)
    bgr_smooth = sep_filter_u8_planes(bgr_bench, t5, t5)
    err["sepconv"] |= exact(
        f"sepconv planes k5 {CLAHE_SHAPE}", bgr_smooth, sep_filter_u8_planes_plain(bgr_bench, t5, t5)
    )
    gray = np.random.default_rng(0).integers(0, 256, GAUSS_SHAPE, dtype=np.uint8)
    check_digest("gauss_1024_input", gray)
    for ksize in GAUSS_KSIZES:
        step = PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING, params={"ksize": ksize})
        check_digest(f"gauss{ksize}_1024_output", PipelineManager([step], device=dev).apply(gray))
    print(f"kernels: sepconv bit-exact at k {SEPCONV_KSIZES} on {', '.join(sep_frames)}; interleaved 3 and 4 "
          f"and 17 channels at k 3/5/7/13, {CLAHE_SHAPE} at k 5; asymmetric taps at k 3x3 to 13x9; the 1024^2 "
          f"frame at k {GAUSS_KSIZES} == the JAX package's digests")

    hist_cases = histogram_cases(dev)
    mixed = torch.cat([hist_cases[k] for k in ("scene 2048^2", "closed mask 2048^2", "constant 2048^2")])
    for name, frames in (
        ("(8,2048,2048)", big.view(FLAGSHIP_SHAPE[0], -1)),
        ("constant (2,1000^2)", torch.full((2, 1000 * 1000), 77, dtype=torch.uint8, device=dev)),
        ("(3,37,1001)", odd.view(3, -1)),
        ("unaligned", unaligned((3, 37037))),
        *hist_cases.items(),
        ("scene, closed mask and constant in one batch", mixed),
        *((f"length {k}", rand((3, k))) for k in (1, 15, 17, 2**20 + 3)),
        ("length 2^20+3 base+1", unaligned((2, 2**20 + 3))),
        (f"{F7_FRAMES} frames of 60", rand((F7_FRAMES, 60))),
    ):
        err["histogram256"] |= exact(
            f"histogram {name}", ck.histogram256_batch(frames), ck.histogram256_batch_plain(frames)
        )
    print(f"kernels: histogram256 bit-exact on (8,2048,2048), a constant pair, (3,37,1001), unaligned, "
          f"{', '.join(hist_cases)}, a mixed batch, lengths 1/15/17/2^20+3, base+1, {F7_FRAMES} frames of 60")

    for name, frames in (
        ("(8,2048,2048)", big.view(FLAGSHIP_SHAPE[0], -1)),
        ("(3,37,1001)", odd.view(3, -1)),
        ("unaligned", unaligned((3, 37037))),
        (f"{F7_FRAMES} frames of 60", rand((F7_FRAMES, 60))),
    ):
        n = frames.shape[0]
        for kind, luts in (("per-frame", rand((n, 256))), ("shared", rand((256,)))):
            err["lut_apply"] |= exact(
                f"lut_apply {kind} {name}",
                ck.lut_apply_batch(frames, luts),
                ck.lut_apply_batch_plain(frames, luts),
            )
    print(f"kernels: lut_apply bit-exact, per-frame and shared tables, on (8,2048,2048), (3,37,1001), unaligned, "
          f"{F7_FRAMES} frames of 60")

    scene = torch.from_numpy(dense_scene(SEG_SIDE)).to(dev)[None]
    closed = _closed_mask(scene)  # the main path's watershed input
    opening, markers = _watershed_inputs(closed)
    cases = [
        ("scene opening 2048^2", opening),
        ("30% noise 2048^2", noise_mask((1, SEG_SIDE, SEG_SIDE), 0.7)),
        ("all foreground 2048^2", torch.full((1, SEG_SIDE, SEG_SIDE), 255, dtype=torch.uint8, device=dev)),
        ("(3,37,1001)", noise_mask((3, 37, 1001), 0.7)),
        # 4-column groups that are not on a 4-byte boundary
        ("unaligned (2,40,64)", noise_mask((2 * 40 * 64 + 1,), 0.7)[1:].view(2, 40, 64)),
    ] + [(f"width {w}", noise_mask((2, 19, w), 0.6)) for w in (1, 2, 3, 4, 5, MAX_WIDTH)]
    for name, masks in cases:
        err["distance"] |= exact(f"distance {name}", distance_transform(masks), distance_transform_plain(masks))
    if float(distance_transform(cases[2][1]).min()) < 2.9e8:
        raise AssertionError("distance: an all-foreground frame must stay near INF")
    try:
        distance_transform(noise_mask((1, 2, MAX_WIDTH + 1), 0.6))
    except ValueError:
        pass
    else:
        raise AssertionError(f"distance: a frame {MAX_WIDTH + 1} wide must be refused")
    print(f"kernels: distance bit-exact on the scene's opening, 30% noise, all foreground (stays INF), "
          f"(3,37,1001), unaligned, widths 1-5 and {MAX_WIDTH} (the widest; one more is refused)")
    # chunk sizes, the two worst cases and a batch, each against its plain version
    want = distance_transform_plain(opening)
    for rows in sorted({1, 16, 64, ROWS_PER_CHUNK, SEG_SIDE}):
        got = distance_transform(opening, rows_per_chunk=rows)
        err["distance"] |= exact(f"distance scene opening, {rows} rows a chunk", got, want)
        print(f"  distance scene opening, {rows} rows a chunk: fix-up rounds (forward, backward) "
              f"{distance_transform.last_rounds.tolist()}")
    worst = {}
    for name, row in (("zero in the first row", 0), ("zero in the last row", SEG_SIDE - 1)):
        masks = torch.full((1, SEG_SIDE, SEG_SIDE), 255, dtype=torch.uint8, device=dev)
        masks[0, row, SEG_SIDE // 3] = 0
        worst[name] = masks
        err["distance"] |= exact(f"distance {name} 2048^2", distance_transform(masks), distance_transform_plain(masks))
        print(f"  distance {name} 2048^2: fix-up rounds (forward, backward) "
              f"{distance_transform.last_rounds.tolist()}")
    batch = torch.cat([opening, noise_mask((1, SEG_SIDE, SEG_SIDE), 0.7), opening.flip(1)]).contiguous()
    want = distance_transform_plain(batch)
    # at 16 rows a chunk the batch's chunks do not all fit: fewer, longer ones
    for rows in (ROWS_PER_CHUNK, 16):
        got = distance_transform(batch, rows_per_chunk=rows)
        err["distance"] |= exact(f"distance batch (3,2048,2048), {rows} rows a chunk", got, want)
    print(f"kernels: distance bit-exact on the scene's opening at {sorted({1, 16, 64, ROWS_PER_CHUNK, SEG_SIDE})} "
          f"rows a chunk, on both worst cases at 2048^2 and on a (3,2048,2048) batch at {ROWS_PER_CHUNK} and 16")

    cc_cases = cc_inputs(dev)
    sure_fg = cc_cases[CC_MAIN]
    checkerboard = (torch.arange(SEG_SIDE, device=dev).view(-1, 1) + torch.arange(SEG_SIDE, device=dev)) % 2 == 0
    ragged = (noise_mask((3, 1000, 999), 0.45) > 0).to(torch.uint8)
    for name, fg in (
        *cc_cases.items(),
        ("checkerboard 2048^2", checkerboard.to(torch.uint8)[None]),
        ("55% noise (3,1000,999)", ragged),
    ):
        err["cc"] |= exact(f"cc {name}", cc_min_index(fg), cc_min_index_plain(fg))
    print(f"kernels: cc (min-index field) bit-exact on {', '.join(cc_cases)}, a 2048^2 checkerboard and "
          "55% noise (3,1000,999)")

    small = torch.from_numpy(dense_scene(512)).to(dev)[None]
    bgr = torch.stack([scene[0], scene[0].roll(3, 1), (255 - scene[0]) // 2], dim=-1)[None].contiguous()
    for name, imgs in (
        ("chain input 2048^2", closed),
        ("raw scene 512^2", small),
        ("raw scene 2048^2", scene),
        ("raw BGR scene 2048^2", bgr),
    ):
        mk = markers if imgs is closed else _watershed_inputs(imgs[..., 0] if imgs.ndim == 4 else imgs)[1]
        err["flood"] |= exact(f"flood {name}", flood(imgs, mk), flood_plain(imgs, mk))
        print(f"  flood {name}: {flood.last_sweeps.tolist()} sweeps")
    scenes = torch.stack([torch.from_numpy(dense_scene(SEG_SIDE, seed=k)) for k in range(FLOOD_BATCH)]).to(dev)
    scene_markers = _watershed_inputs(scenes)[1]
    got = flood(scenes, scene_markers)
    flood_batch_sweeps = flood.last_sweeps.tolist()
    for i in range(FLOOD_BATCH):
        err["flood"] |= exact(
            f"flood batch frame {i}", got[i : i + 1], flood_plain(scenes[i : i + 1], scene_markers[i : i + 1])
        )
    print(f"  flood batch of {FLOOD_BATCH} scenes 2048^2: sweeps {flood_batch_sweeps}")
    lone = {side: single_marker(side, dev) for side in (SEG_CPU_SIDE, SEG_SIDE)}
    lone_want = flood_plain(*lone[SEG_CPU_SIDE])
    lone_plain_sweeps = flood_plain.last_sweeps.tolist()
    err["flood"] |= exact(f"flood single marker {SEG_CPU_SIDE}^2", flood(*lone[SEG_CPU_SIDE]), lone_want)
    print(f"  flood single marker {SEG_CPU_SIDE}^2: {flood.last_sweeps.tolist()} sweeps (plain {lone_plain_sweeps})")
    # uint16 frames built in int32 (torch has few uint16 ops on the card)
    wide32 = small.to(torch.int32) * 4
    wide32[..., SEG_CPU_SIDE // 2] = 999  # a column whose edge costs pass 255
    wide_markers = _watershed_inputs(small)[1]
    for name, wide in (
        ("gray", wide32.to(torch.uint16)),
        ("BGR", torch.stack([wide32[0], wide32[0].roll(2, 0), wide32[0] // 3], dim=-1)[None].to(torch.uint16)),
    ):
        if not cost_planes(wide)[2]:
            raise AssertionError("flood: a uint16 frame must take the wide-cost instance")
        err["flood"] |= exact(f"flood uint16 {name} costs above 255 512^2", flood(wide, wide_markers),
                              flood_plain(wide, wide_markers))
    print("kernels: flood bit-exact on the chain's watershed input, the raw scene at 512^2 and 2048^2, "
          f"a BGR scene, a batch of {FLOOD_BATCH} scenes (each frame alone), a single-marker frame, "
          "uint16 gray and BGR frames with costs above 255")

    # the CLAHE path's Y planes: the bench's frames after the Gaussian
    y_bench = bgr_to_ycrcb(bgr_smooth)[..., 0].contiguous()
    del bgr_smooth
    grid4 = (CLAHE_GRID, CLAHE_GRID)
    zeros = torch.zeros((2, 1024, 1024), dtype=torch.uint8, device=dev)
    for name, y, grid in (
        ("bench Y (64,1024,1024) grid 4", y_bench, grid4),
        ("(1,1024,1024) grid 64", rand((1, 1024, 1024)), (64, 64)),
        ("odd tiles (3,1000,999) grid 7", CL.pad_to_grid(rand((3, 1000, 999)), (7, 7)), (7, 7)),
        ("constant 0 (2,1024,1024) grid 2", zeros, (2, 2)),
        ("constant 255 (2,1024,1024) grid 2", zeros + 255, (2, 2)),
        ("unaligned (2,96,120) grid 8", unaligned((2, 96, 120)), (8, 8)),
    ):
        err["tile_histogram"] |= exact(
            f"tile_histogram {name}", CL.tile_histograms(y, grid), CL.tile_histograms_plain(y, grid)
        )
    many = rand((F7_TILES, 8, 8))
    err["tile_histogram"] |= exact(
        f"tile_histogram ({F7_TILES},8,8) grid 2", CL.tile_histograms(many, (2, 2)), CL.tile_histograms_plain(many, (2, 2))
    )
    if int(CL.tile_histograms(zeros, (2, 2))[..., 0].min()) != 512 * 512:
        raise AssertionError("tile_histogram: a constant tile must put all its 512^2 pixels in one bin")
    print("kernels: tile_histogram bit-exact on the bench's Y planes (64,1024,1024) at grid 4, grid 64, "
          "odd tiles (3,1000,999) at grid 7, constant 0 and 255 (one bin holds 512^2), unaligned, "
          f"({F7_TILES},8,8) at grid 2")

    for name, y, grid, clip in (
        ("bench Y (64,1024,1024) grid 4 clip 2", y_bench, grid4, CLAHE_CLIP),
        ("(1,1000,1000) grid 4 clip 40", rand((1, 1000, 1000)), (4, 4), 40.0),
        ("(2,300,200) grid 5 clip 0", rand((2, 300, 200)), (5, 5), 0.0),
        ("(1,1000,1000) grid 2 clip 2", rand((1, 1000, 1000)), (2, 2), 2.0),
        ("(1,1024,1024) grid 64 clip 40", rand((1, 1024, 1024)), (64, 64), 40.0),
        ("(3,1000,999) grid 7 clip 2", rand((3, 1000, 999)), (7, 7), 2.0),
        ("unaligned (2,96,120) grid 8 clip 40", unaligned((2, 96, 120)), (8, 8), 40.0),
        ("bands across tile rows (2,200,160) grid 5 clip 2", rand((2, 200, 160)), (5, 5), 2.0),
        ("tables from global memory (1,64,2040) grid 64 clip 2", rand((1, 64, 2040)), (64, 64), 2.0),
        ("(2,100,130) grid 1 clip 2", rand((2, 100, 130)), (1, 1), 2.0),
        (f"({F7_TILES},8,8) grid 2 clip 2", many, (2, 2), 2.0),
        (f"(1,{F7_TILES},16) grid 2 clip 2", rand((1, F7_TILES, 16)), (2, 2), 2.0),
    ):
        work, luts, interp = blend_inputs(y, grid, clip)
        if name.startswith("tables from global memory") and CL.blend_shared_bytes(work, luts):
            raise AssertionError("clahe_blend: a grid whose tables do not fit a block must read them from global")
        err["clahe_blend"] |= exact(
            f"clahe_blend {name}", CL.clahe_blend(work, luts, interp), CL.clahe_blend_plain(work, luts, interp)
        )
        if name.startswith("(1,1000,1000) grid 4"):
            # tables of any values, not only cumulative ones
            noise = rand(tuple(luts.shape))
            err["clahe_blend"] |= exact(
                "clahe_blend random tables", CL.clahe_blend(work, noise, interp), CL.clahe_blend_plain(work, noise, interp)
            )
    print("kernels: clahe_blend bit-exact on the bench's Y planes, 1000^2 at grids 4 and 2, 300x200 at grid 5 "
          "(clip 0), grid 64, (3,1000,999) at grid 7 (odd tiles, cropped), random tables, unaligned, bands "
          "across tile rows, tables from global memory, grid 1, "
          f"({F7_TILES},8,8) and (1,{F7_TILES},16) at grid 2")

    flat = big.view(FLAGSHIP_SHAPE[0], -1)
    luts = rand((FLAGSHIP_SHAPE[0], 256))
    times = {
        "sepconv": paired_ms(lambda: sep_filter_u8(big, t5, t5), lambda: sep_filter_u8_plain(big, t5, t5)),
        "histogram256": paired_ms(
            lambda: ck.histogram256_batch(hist_cases[HIST_MAIN]),
            lambda: ck.histogram256_batch_plain(hist_cases[HIST_MAIN]),
        ),
        "lut_apply": paired_ms(lambda: ck.lut_apply_batch(flat, luts), lambda: ck.lut_apply_batch_plain(flat, luts)),
        "distance": paired_ms(
            lambda: distance_transform(opening), lambda: distance_transform_plain(opening), plain_runs=3
        ),
        "cc": paired_ms(lambda: cc_min_index(sure_fg), lambda: cc_min_index_plain(sure_fg), plain_runs=5),
        "flood": paired_ms(lambda: flood(closed, markers), lambda: flood_plain(closed, markers), plain_runs=3),
        "tile_histogram": paired_ms(
            lambda: CL.tile_histograms(y_bench, grid4), lambda: CL.tile_histograms_plain(y_bench, grid4), plain_runs=5
        ),
    }
    work, luts, interp = blend_inputs(y_bench, grid4, CLAHE_CLIP)
    times["clahe_blend"] = paired_ms(
        lambda: CL.clahe_blend(work, luts, interp), lambda: CL.clahe_blend_plain(work, luts, interp), plain_runs=5
    )
    case_times = time_cc_and_blend(cc_cases, (work, luts, interp))
    # sepconv on the CLAHE path's interleaved batch, in place
    sep_clahe = paired_ms(
        lambda: sep_filter_u8_planes(bgr_bench, t5, t5),
        lambda: sep_filter_u8_planes_plain(bgr_bench, t5, t5),
        plain_runs=3,
    )
    del bgr_bench
    # histogram256 on every main-path input: kernel and plain (paired), and
    # bincount on each single frame; and the fixed cost of a launch
    hist_times = {}
    for name, frames in hist_cases.items():
        k, p = paired_ms(lambda f=frames: ck.histogram256_batch(f), lambda f=frames: ck.histogram256_batch_plain(f))
        lib = time_ms(lambda f=frames: torch.bincount(f.view(-1), minlength=256)) if frames.shape[0] == 1 else None
        hist_times[name] = {"ms": k, "plain_ms": p, "library_ms": lib}
    library = {"histogram256": hist_times[HIST_ONE]["library_ms"]}
    floor_ms = empty_launch_ms(dev)
    # the flood's event pair against the profiler's sum of its kernels (the
    # cooperative launch and the few small torch ops around it)
    flood_device_ms = profiled_device_ms(lambda: flood(closed, markers))
    flood(closed, markers)
    sweeps, levels, swept = (int(v) for v in flood.last_stats[0])
    ty, tx = tiles(SEG_SIDE, SEG_SIDE)
    flood_stats = {"sweeps": sweeps, "levels": levels, "tiles_swept": swept, "tile_share": swept / (sweeps * ty * tx)}
    flood_batch_ms = time_ms(lambda: flood(scenes, scene_markers), runs=10)
    flood(*lone[SEG_SIDE])
    lone_stats = [int(v) for v in flood.last_stats[0]]
    flood_lone_ms = time_ms(lambda: flood(*lone[SEG_SIDE]), runs=5)
    for name, (k, p) in times.items():
        print(f"time {name}: kernel {k:.4f} ms, plain {p:.4f} ms")
    for name, ms in case_times.items():
        print(f"time {name}: {ms:.4f} ms")
    planes_px = float(np.prod(CLAHE_SHAPE))
    sep_clahe_bound = bound_ms(2 * planes_px, 20 * planes_px)[0]
    print(f"time sepconv on the CLAHE batch {CLAHE_SHAPE} in place: kernel {sep_clahe[0]:.4f} ms, plain "
          f"{sep_clahe[1]:.4f} ms, bound {sep_clahe_bound:.4f} ms")
    for rows in (32, 64, 128, 256, SEG_SIDE):
        ms = time_ms(lambda: distance_transform(opening, rows_per_chunk=rows))
        per_row = f" = {1e3 * ms / (2 * SEG_SIDE):.3f} us a row (one chunk: the sequential walk)" if rows == SEG_SIDE else ""
        print(f"time distance scene opening, {rows} rows a chunk: {ms:.4f} ms{per_row}")
    for name, masks in worst.items():
        ms = time_ms(lambda: distance_transform(masks), runs=5)
        print(f"time distance {name} 2048^2, {ROWS_PER_CHUNK} rows a chunk: {ms:.4f} ms")
    for name, t in hist_times.items():
        lib = "" if t["library_ms"] is None else f", torch.bincount {t['library_ms']:.4f} ms"
        print(f"time histogram256 {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms{lib}")
    print(f"time empty launch through _build.launch: {floor_ms:.4f} ms")
    print(f"time flood: event pair {times['flood'][0]:.4f} ms, {flood_device_ms} ms of device time by the "
          f"profiler; {sweeps} sweeps, {levels} levels visited, {swept} tiles of {TILE_ROWS}x{TILE_COLS} swept "
          f"= {100 * flood_stats['tile_share']:.1f}% of sweeps x tiles; bytes of the tiles swept "
          f"{bound_ms(10 * swept * TILE_ROWS * TILE_COLS)[0]:.4f} ms at 3.35 TB/s")
    print(f"time flood batch of {FLOOD_BATCH} scenes 2048^2: {flood_batch_ms:.4f} ms "
          f"({flood_batch_ms / FLOOD_BATCH:.4f} ms a frame; sweeps {flood_batch_sweeps})")
    print(f"time flood single marker {SEG_SIDE}^2: {flood_lone_ms:.4f} ms for {lone_stats[0]} sweeps "
          f"({1e3 * flood_lone_ms / lone_stats[0]:.2f} us a sweep), {lone_stats[1]} levels, "
          f"{100 * lone_stats[2] / (lone_stats[0] * ty * tx):.1f}% of sweeps x tiles swept")

    n_flag = float(np.prod(FLAGSHIP_SHAPE))
    n_seg = float(SEG_SIDE * SEG_SIDE)
    _, h_clahe, w_clahe = y_bench.shape
    n_clahe = float(y_bench.numel())
    n_tiles = CLAHE_SHAPE[0] * CLAHE_GRID * CLAHE_GRID
    bounds = {
        # u8 in and out; 5 + 5 taps, a multiply and an add each
        "sepconv": bound_ms(2 * n_flag, 20 * n_flag),
        "histogram256": bound_ms(n_flag + FLAGSHIP_SHAPE[0] * 256 * 4),
        "lut_apply": bound_ms(2 * n_flag + FLAGSHIP_SHAPE[0] * 256),
        # u8 mask in, f32 out; per pixel and pass 7 adds, 7 mins, 2 scans
        "distance": bound_ms(5 * n_seg, 2 * 20 * n_seg),
        # u8 mask in, int32 out
        "cc": bound_ms(5 * n_seg),
        # u8 image and int32 markers in, int32 labels out, one pass
        "flood": bound_ms(9 * n_seg),
        # u8 in, an int32 histogram of 256 bins out per tile
        "tile_histogram": bound_ms(n_clahe + n_tiles * 256 * 4),
        # u8 in and out, the u8 tables and the row and column arrays (12 B
        # an entry) once; per pixel 2 subtractions, 5 multiplies, 3 FMAs of
        # 2 operations each, a rint and 2 clamps
        "clahe_blend": bound_ms(2 * n_clahe + n_tiles * 256 + 12 * (h_clahe + w_clahe), 16 * n_clahe),
    }
    return {
        "err": err,
        "times": times,
        "library": library,
        "bounds": bounds,
        "hist_times": hist_times,
        "hist_bound_one_ms": bound_ms(n_seg + 256 * 4)[0],
        "empty_launch_ms": floor_ms,
        "case_times": case_times,
        "blend_shared_bytes": CL.blend_shared_bytes(work, luts),
        "flood_device_ms": flood_device_ms,
        "flood_stats": flood_stats,
        "flood_swept_bound_ms": bound_ms(10 * swept * TILE_ROWS * TILE_COLS)[0],
        "sepconv_clahe": {
            "ms_clahe": sep_clahe[0],
            "plain_ms_clahe": sep_clahe[1],
            "bound_ms_clahe": sep_clahe_bound,
        },
    }


def phase_filter_kernels(dev) -> dict:
    """The median and bilateral kernels against their plain versions, bit
    for bit, then the packed min and max rate, each kernel's time, bound
    and share at every ksize timed, sepconv's generic instance at sharpen's
    19 taps, and the plain-torch paths left slow."""

    from yamimageprocessor_tpu_torch.ops.bilateral import bilateral_filter, bilateral_plain, window_offsets
    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
    from yamimageprocessor_tpu_torch.ops.filters import to_uint8
    from yamimageprocessor_tpu_torch.ops.median import median_filter, median_float, median_plain
    from yamimageprocessor_tpu_torch.ops.preprocess import sharpen_taps
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8, sep_filter_u8_plain

    gen = torch.Generator(device=dev).manual_seed(2)

    def rand(shape, dtype=torch.uint8):
        high = 256 if dtype == torch.uint8 else 65536
        return torch.randint(0, high, shape, dtype=torch.int32, device=dev, generator=gen).to(dtype)

    err = {"median": 0, "bilateral": 0}
    bgr = torch.from_numpy(denoise_frames()).to(dev)
    gray = bgr_to_gray(bgr).contiguous()  # the median's input on the denoise path
    side = SMALL_SIDE
    for ksize in MEDIAN_KSIZES:
        cases = {
            f"(2,{side},{side}) uint8": rand((2, side, side)),
            f"(2,{side},{side},3) uint8": rand((2, side, side, 3)),
            f"(2,{side},{side}) uint16": rand((2, side, side), torch.uint16),
            f"(1,{side},{side},3) uint16": rand((1, side, side, 3), torch.uint16),
            "(1,37,1001) uint8": rand((1, 37, 1001)),
            "(1,41,101,4) uint16": rand((1, 41, 101, 4), torch.uint16),
            "(1,41,101,2) uint8": rand((1, 41, 101, 2)),
            "(1,9,7,5) uint8": rand((1, 9, 7, 5)),
            "(1,1,300) uint8 one row": rand((1, 1, 300)),
            "(2,50,1) uint16 one column": rand((2, 50, 1), torch.uint16),
            "(1,3,2,3) uint8 smaller than the window": rand((1, 3, 2, 3)),
            "(5,33,257) uint8 more frames than a block's rows": rand((5, 33, 257)),
        }
        if ksize <= 9:
            cases["denoise gray frames 0-1 (2,2048,2048)"] = gray[:2]
        for name, imgs in cases.items():
            got, want = median_filter(imgs, ksize), median_plain(imgs, ksize)
            err["median"] |= exact(f"median k{ksize} {name}", got.to(torch.int32), want.to(torch.int32))
    print(f"kernels: median bit-exact at k {MEDIAN_KSIZES} on {side}^2 gray and 3-channel uint8 and uint16, "
          "ragged frames, 2, 4 and 5 channels, one row, one column, a frame smaller than the window, a batch of "
          "5, and (k <= 9) the denoise path's gray frames")
    for ksize in BILATERAL_KSIZES:
        sw, lut = bilateral_tables(ksize, dev)
        big = ksize <= 9
        cases = {
            "denoise BGR (8,2048,2048,3)" if ksize == 5 else f"BGR (2,{side},{side},3)":
                bgr if ksize == 5 else rand((2, side, side, 3)),
            "gray (2,2048,2048)" if big else f"gray (2,{side},{side})": gray[:2] if big else rand((2, side, side)),
            "(1,37,101,4)": rand((1, 37, 101, 4)),
            "(1,33,40,2)": rand((1, 33, 40, 2)),
            "(1,29,37,5)": rand((1, 29, 37, 5)),
            "(1,19,23,9)": rand((1, 19, 23, 9)),
            "(1,5,3,3)": rand((1, 5, 3, 3)),
            "(1,1,200,3) one row": rand((1, 1, 200, 3)),
            "(2,50,1) one column": rand((2, 50, 1)),
            "(3,130,257,3)": rand((3, 130, 257, 3)),
            "(5,40,129) more frames than a block's rows": rand((5, 40, 129)),
        }
        for name, imgs in cases.items():
            err["bilateral"] |= exact(
                f"bilateral k{ksize} {name}",
                bilateral_filter(imgs, sw, lut, ksize),
                to_uint8(bilateral_plain(imgs, sw, lut, ksize)),
            )
    # tables other than the split's: out of the range that keeps the
    # division on its fast path (the kernel then divides by __fdiv_rn), and
    # random colour weights in range (the centre's 1)
    sw5, lut5 = bilateral_tables(5, dev)
    in_range = torch.rand(768, generator=gen, device=dev)
    in_range[0] = 1.0
    other = {
        "space weights x 2^-12": (sw5 * 2.0**-12, lut5),
        "space weights x 2^34": (sw5 * 2.0**34, lut5),
        "random colour weights": (sw5, torch.rand(768, generator=gen, device=dev)),
        "random colour weights, centre 1": (sw5, in_range),
    }
    for tables, (sw, lut) in other.items():
        for c in (1, 3, 4, 5):
            imgs = rand((1, 37, 61, c)) if c > 1 else rand((1, 37, 61))
            err["bilateral"] |= exact(
                f"bilateral k5 {tables} (1,37,61,{c})",
                bilateral_filter(imgs, sw, lut, 5),
                to_uint8(bilateral_plain(imgs, sw, lut, 5)),
            )
    print(f"kernels: bilateral bit-exact at k {BILATERAL_KSIZES} on gray and BGR frames (2048^2 at k <= 9, the "
          f"denoise batch at k 5, {side}^2 at k 31), 2, 4, 5 and 9 channels, one row, one column, a frame smaller "
          "than the window, widths that are not a multiple of 4, a batch of 5; at k 5 with 1, 3, 4 and 5 channels "
          "and four tables other than the split's")

    rate = minmax_rate(dev)
    print(f"time packed 16x2 min and max (yam_vminmax_rate, {RATE_BLOCKS} blocks x 256 threads x {RATE_ROUNDS} "
          f"rounds of 16): {rate / 1e12:.3f} T ops/s")
    # times on the main paths' inputs: the gray batch (median), the sharpened
    # median's input to sepconv at 19 taps, the BGR batch (bilateral)
    taps19 = sharpen_taps(dev)
    smooth = median_filter(gray, 5)
    work = torch.nn.functional.pad(gray[:, None].float(), (2, 2, 2, 2), mode="replicate")[:, 0].to(torch.uint8)
    n, h, w = gray.shape
    times = {
        "median": paired_ms(lambda: median_filter(gray, 5), lambda: median_plain(gray, 5), plain_runs=3),
        "bilateral": paired_ms(
            lambda: bilateral_filter(bgr, sw5, lut5, 5),
            lambda: to_uint8(bilateral_plain(bgr, sw5, lut5, 5)),
            plain_runs=3,
        ),
        "sepconv 19": paired_ms(
            lambda: sep_filter_u8(smooth, taps19, taps19), lambda: sep_filter_u8_plain(smooth, taps19, taps19),
            plain_runs=3,
        ),
    }
    library = {
        # one PyTorch computation of the same median: unfold and median(-1)
        # on the frames padded beforehand
        "median": time_ms(lambda: work.unfold(1, 5, 1).unfold(2, 5, 1).reshape(n, h, w, 25).median(-1), runs=5),
    }
    px_gray = float(gray.numel())
    px_bgr = float(bgr.numel() // 3)
    filters = time_filters(dev, {})
    by_ksize = {"median": {}, "bilateral": {}}
    for ksize, ms in filters["median"].items():
        bound = median_bound(px_gray, ksize, rate)
        by_ksize["median"][ksize] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
    for ksize, ms in filters["bilateral"].items():
        bound = bilateral_bound(px_bgr, len(window_offsets(ksize)), 3)
        by_ksize["bilateral"][ksize] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
    for name, rows in by_ksize.items():
        shape = "(8,2048,2048) gray" if name == "median" else "(8,2048,2048,3) BGR"
        for ksize, t in rows.items():
            print(f"time {name} k{ksize} {shape}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of it")
    # the plain-torch paths of float32 frames (no kernel): one 2048^2 frame
    gray_f = gray[:1].float()
    slow = {
        f"median_float k{k} (1,2048,2048)": time_ms(lambda k=k: median_float(gray_f, k), runs=3, warmup=1)
        for k in (3, 5, 7)
    }
    bgr_f = bgr[:1].float()
    slow["bilateral_plain k5 float32 (1,2048,2048,3)"] = time_ms(
        lambda: bilateral_plain(bgr_f, sw5, lut5, 5), runs=3, warmup=1
    )
    for name, (k, p) in times.items():
        print(f"time {name}: kernel {k:.4f} ms, plain {p:.4f} ms")
    print(f"time median library (unfold + median(-1) on the padded gray batch): {library['median']:.4f} ms")
    for name, ms in slow.items():
        print(f"time {name} (plain torch): {ms:.4f} ms")

    bounds = {
        "median": median_bound(px_gray, 5, rate),
        "bilateral": bilateral_bound(px_bgr, len(window_offsets(5)), 3),
        # u8 in and out; 19 + 19 taps, a multiply and an add each
        "sepconv 19": bound_ms(2 * px_gray, f32_ops=2 * 2 * 19 * px_gray),
    }
    return {"err": err, "times": times, "library": library, "bounds": bounds, "slow": slow, "by_ksize": by_ksize,
            "minmax_rate": rate}


def _counters():
    from yamimageprocessor_tpu_torch import cuda_kernels as ck
    from yamimageprocessor_tpu_torch.ops import clahe as CL
    from yamimageprocessor_tpu_torch.ops.distance import distance_transform
    from yamimageprocessor_tpu_torch.ops.labeling import cc_min_index
    from yamimageprocessor_tpu_torch.ops.bilateral import bilateral_filter
    from yamimageprocessor_tpu_torch.ops.median import median_filter
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8
    from yamimageprocessor_tpu_torch.ops.watershed import flood
    from yamimageprocessor_tpu_torch.ops import extraction_device as XD
    from yamimageprocessor_tpu_torch.ops import hogf as HG
    from yamimageprocessor_tpu_torch.ops import regionprops as RP
    from yamimageprocessor_tpu_torch.ops import texture as TX
    from yamimageprocessor_tpu_torch.ops.filter2d_cuda import filter2d_u8
    from yamimageprocessor_tpu_torch.ops.contours import trace_contours
    from yamimageprocessor_tpu_torch.ops.fourier import fourier_lines
    from yamimageprocessor_tpu_torch.ops.polygon import polygon_mean_errors
    from yamimageprocessor_tpu_torch.ops import edges as ED
    from yamimageprocessor_tpu_torch.ops import growing as GR
    from yamimageprocessor_tpu_torch.ops import threshold as TH

    return {
        "sepconv": sep_filter_u8,
        "histogram256": ck.histogram256_batch,
        "lut_apply": ck.lut_apply_batch,
        "distance": distance_transform,
        "cc": cc_min_index,
        "flood": flood,
        "tile_histogram": CL.tile_histograms,
        "clahe_blend": CL.clahe_blend,
        "median": median_filter,
        "bilateral": bilateral_filter,
        "region_scan": RP.region_scan,
        "hull_areas": RP.hull_pixel_areas,
        "annotate": XD.region_annotate,
        "glcm_counts": TX.glcm_counts,
        "lbp_codes": TX.lbp_codes,
        "filter2d": filter2d_u8,
        "hog_cells": HG.hog_cells,
        "trace_contours": trace_contours,
        "fourier_lines": fourier_lines,
        "polygon_mean_errors": polygon_mean_errors,
        "stream_grid_histogram": CL.grid_hist_stream,
        "clahe_stream_blend": CL.clahe_stream_blend,
        "gradient": ED.gradient_u8,
        "canny_candidates": ED.canny_candidates,
        "adaptive_threshold": TH.adaptive_threshold,
        "region_grow": GR.region_grow,
    }


def drive(name: str, kernels, fn) -> dict:
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; the named kernels must have launched."""

    counters = _counters()
    for counter in counters.values():
        counter.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: counters[k].launches for k in kernels}
    print(f"{name}: launches during the main path {launches}")
    missing = [k for k, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"{name}: kernels not launched on the main path: {missing}")
    return {"out": out, "launches": launches}


def phase_flagship(dev) -> dict:
    from yamimageprocessor_tpu_torch.models.stages import flagship_chain, flagship_forward, preprocess_steps
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    images = np.random.default_rng(0).integers(0, 256, FLAGSHIP_SHAPE, dtype=np.uint8)
    check_digest("flagship_input", images)
    x = torch.from_numpy(images).to(dev)
    manager = PipelineManager(preprocess_steps(), device=dev)

    run = drive(
        "flagship",
        ("sepconv", "histogram256", "lut_apply"),
        lambda: (flagship_forward(x), manager.apply(images[0])),
    )
    out, frame_out = run["out"]
    check_digest("flagship_output", out)
    exact("flagship manager.apply frame 0", torch.from_numpy(frame_out), out[0].cpu())
    cpu_out = flagship_forward(torch.from_numpy(images[:2]))
    exact("flagship cuda vs cpu (frames 0-1)", out[:2].cpu(), cpu_out)
    print(f"flagship: {FLAGSHIP_SHAPE} on cuda == the JAX package's digest == the port's CPU run; "
          "manager.apply == forward")

    fn, dyn = flagship_chain(FLAGSHIP_SHAPE, dev)
    device_ms = time_ms(lambda: fn(x, dyn))
    loop_ms = back_to_back_ms(lambda: fn(x, dyn))
    rate = float(np.prod(FLAGSHIP_SHAPE)) * FLAGSHIP_STEPS / 1e6 / (loop_ms / 1e3)
    print(
        f"flagship: {loop_ms:.4f} ms per batch back to back ({RUNS} batches), "
        f"{rate:.1f} MPix*steps/s; device time {device_ms:.4f} ms per batch"
    )
    print_profile("flagship", chain_profile(lambda: fn(x, dyn), _FLAGSHIP_GROUPS))
    return run["launches"]


def phase_segmentation(dev) -> dict:
    from yamimageprocessor_tpu_torch.models.stages import (
        segmentation_chain,
        segmentation_forward,
        segmentation_steps,
    )
    from yamimageprocessor_tpu_torch.ops.watershed import flood
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    scene = dense_scene(SEG_SIDE)
    check_digest("segmentation_input", scene)
    x = torch.from_numpy(scene).to(dev)[None]
    manager = PipelineManager(segmentation_steps(), device=dev)

    run = drive(
        "segmentation",
        ("histogram256", "distance", "cc", "flood"),
        lambda: (segmentation_forward(x), manager.apply(scene)),
    )
    out, frame_out = run["out"]
    sweeps = flood.last_sweeps.tolist()
    check_digest("segmentation_output", out[0])
    exact("segmentation manager.apply", torch.from_numpy(frame_out), out[0].cpu())
    small = dense_scene(SEG_CPU_SIDE)
    exact(
        f"segmentation {SEG_CPU_SIDE}^2 cuda vs cpu",
        segmentation_forward(torch.from_numpy(small).to(dev)[None]).cpu(),
        segmentation_forward(torch.from_numpy(small)[None]),
    )
    print(f"segmentation: {SEG_SIDE}^2 on cuda == the JAX package's digest; {SEG_CPU_SIDE}^2 == the port's "
          f"CPU run; manager.apply == forward; flood sweeps {sweeps}")

    fn, dyn = segmentation_chain(x.shape, dev)
    frames = [torch.from_numpy(dense_scene(SEG_SIDE, seed=k)).to(dev)[None] for k in range(SEG_FRAMES)]
    for f in frames[:2]:
        fn(f, dyn)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for f in frames:
        fn(f, dyn)
    end.record()
    end.synchronize()
    loop_ms = start.elapsed_time(end) / SEG_FRAMES
    frame_ms = time_ms(lambda: fn(x, dyn), runs=10)
    print(
        f"segmentation: {loop_ms:.4f} ms per frame back to back over {SEG_FRAMES} frames "
        f"= {1e3 / loop_ms:.2f} frames/s; {frame_ms:.4f} ms per call on the seed-3 scene "
        f"(event pair behind a queued sleep)"
    )
    print_profile("segmentation", chain_profile(lambda: fn(x, dyn), _SEG_GROUPS))
    return run["launches"]


def chain_profile(fn, groups: dict, runs: int = 3) -> dict:
    """Kernels per call of ``fn`` and their device time in ms per call, by
    group (the path's own kernels, then everything else by name), from
    ``torch.profiler``."""

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    split = {g: 0.0 for g in groups.values()}
    other = defaultdict(float)
    kernels = 0
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels += 1
        group = next((g for key, g in groups.items() if key in event.name), None)
        if group is None:
            other[event.name[:90]] += event.device_time_total
        else:
            split[group] += event.device_time_total
    split = {g: t / 1e3 / runs for g, t in split.items()}
    split["other"] = sum(other.values()) / 1e3 / runs
    top = sorted(((t / 1e3 / runs, name) for name, t in other.items()), reverse=True)[:8]
    return {"kernels": kernels / runs, "device_ms": split, "other_top": top}


def print_profile(name: str, split: dict) -> None:
    unit = "a frame" if name == "segmentation" else "a batch"
    print(f"{name} profile: {split['kernels']:.0f} kernels {unit}; device ms {unit} "
          + ", ".join(f"{g} {t:.4f}" for g, t in split["device_ms"].items()))
    for t, kernel in split["other_top"]:
        print(f"  other {t:9.4f} ms  {kernel}")


def phase_clahe(dev) -> dict:
    from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    def chain(shape, device):
        return get_compiled_chain(clahe_steps(), shape, np.uint8, batch=shape[0], device=device).pure_callable()

    images = clahe_frames(CLAHE_SHAPE)
    check_digest("clahe_input", images)
    x = torch.from_numpy(images).to(dev)
    fn, dyn = chain(CLAHE_SHAPE, dev)
    manager = PipelineManager(clahe_steps(), device=dev)

    run = drive(
        "clahe",
        ("sepconv", "tile_histogram", "clahe_blend"),
        lambda: (fn(x, dyn)[-1], manager.apply(images)),
    )
    out, stack_out = run["out"]
    check_digest("clahe_output", out)
    exact("clahe manager.apply", torch.from_numpy(stack_out), out.cpu())
    odd = clahe_frames(CLAHE_1000_SHAPE)
    check_digest("clahe_1000_input", odd)
    fn1000, dyn1000 = chain(CLAHE_1000_SHAPE, dev)
    check_digest("clahe_1000_output", fn1000(torch.from_numpy(odd).to(dev), dyn1000)[-1])
    small = np.random.default_rng(1).integers(0, 256, CLAHE_CPU_SHAPE, dtype=np.uint8)
    card_fn, card_dyn = chain(CLAHE_CPU_SHAPE, dev)
    cpu_fn, cpu_dyn = chain(CLAHE_CPU_SHAPE, "cpu")
    exact(
        "clahe (3,120,100,3) cuda vs cpu",
        card_fn(torch.from_numpy(small).to(dev), card_dyn)[-1].cpu(),
        cpu_fn(torch.from_numpy(small), cpu_dyn)[-1],
    )
    print(f"clahe: {CLAHE_SHAPE} and {CLAHE_1000_SHAPE} on cuda == the JAX package's digests; "
          f"{CLAHE_CPU_SHAPE} == the port's CPU run; manager.apply == forward")

    device_ms = time_ms(lambda: fn(x, dyn))
    loop_ms = back_to_back_ms(lambda: fn(x, dyn))
    mpix = float(np.prod(CLAHE_SHAPE[:3])) / 1e6
    print(
        f"clahe: {loop_ms:.4f} ms per batch back to back ({RUNS} batches) = {mpix / (loop_ms / 1e3):.1f} MPix/s; "
        f"device time {device_ms:.4f} ms per batch = {mpix / (device_ms / 1e3):.1f} MPix/s"
    )
    print_profile("clahe", chain_profile(lambda: fn(x, dyn), _CLAHE_GROUPS))
    return run["launches"]


_DENOISE_GROUPS = {
    "median_": "median",
    "sepconv_": "sepconv",
    "lut_apply_kernel": "lut_apply",
}
_BILATERAL_GROUPS = {"bilateral_": "bilateral"}


def _batch_chain(steps, shape, device):
    from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain

    return get_compiled_chain(steps, shape, np.uint8, batch=shape[0], device=device).pure_callable()


def _drive_chain(name: str, steps, kernels, digest: str, dev) -> dict:
    """One chain on the BGR batch through the chain runner and the
    manager: launches, the JAX package's digest, frame 0 by the manager,
    frames 0-1 against the port's CPU run, then its times."""

    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    images = denoise_frames()
    check_digest("denoise_input", images)
    x = torch.from_numpy(images).to(dev)
    fn, dyn = _batch_chain(steps, DENOISE_SHAPE, dev)
    manager = PipelineManager(steps, device=dev)
    run = drive(name, kernels, lambda: (fn(x, dyn)[-1], manager.apply(images[0])))
    out, frame_out = run["out"]
    check_digest(digest, out)
    exact(f"{name} manager.apply frame 0", torch.from_numpy(frame_out), out[0].cpu())
    k = DENOISE_CPU_FRAMES
    cpu_fn, cpu_dyn = _batch_chain(steps, (k,) + DENOISE_SHAPE[1:], "cpu")
    exact(f"{name} cuda vs cpu (frames 0-{k - 1})", out[:k].cpu(), cpu_fn(torch.from_numpy(images[:k]), cpu_dyn)[-1])
    print(f"{name}: {DENOISE_SHAPE} on cuda == the JAX package's digest, shape {tuple(out.shape)}; frames 0-{k - 1} "
          "== the port's CPU run; manager.apply == forward")
    device_ms = time_ms(lambda: fn(x, dyn))
    loop_ms = back_to_back_ms(lambda: fn(x, dyn))
    mpix = float(np.prod(DENOISE_SHAPE[:3])) / 1e6
    print(f"{name}: {loop_ms:.4f} ms per batch back to back ({RUNS} batches) = {mpix / (loop_ms / 1e3):.1f} MPix/s; "
          f"device time {device_ms:.4f} ms per batch = {mpix / (device_ms / 1e3):.1f} MPix/s")
    return {"launches": run["launches"], "fn": fn, "dyn": dyn, "x": x}


def phase_denoise(dev) -> dict:
    run = _drive_chain("denoise", denoise_steps(False), ("median", "sepconv", "lut_apply"), "denoise_output", dev)
    print_profile("denoise", chain_profile(lambda: run["fn"](run["x"], run["dyn"]), _DENOISE_GROUPS))
    # the same chain ending in the crop itself: the chain runner follows the
    # change of shape
    fn, dyn = _batch_chain(denoise_steps(True), DENOISE_SHAPE, dev)
    cropped = fn(run["x"], dyn)[-1]
    check_digest("denoise_crop_output", cropped)
    print(f"denoise crop: {tuple(cropped.shape)} == the JAX package's digest")
    return run["launches"]


def phase_bilateral(dev) -> dict:
    run = _drive_chain("bilateral", bilateral_steps(), ("bilateral",), "bilateral_output", dev)
    print_profile("bilateral", chain_profile(lambda: run["fn"](run["x"], run["dyn"]), _BILATERAL_GROUPS))
    return run["launches"]


# ---------------------------------------------------------------------------
# edges: Sobel, Prewitt, Laplacian, Canny edge, adaptive threshold, border
# removal and region growing


def edge_steps():
    """``{name: steps}``: each of the seven ops alone at its defaults, and
    a Gaussian 5 -> Canny chain (``scripts/torch_port_digests.py:edge_steps``)."""

    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    seg = Stage.SEGMENTATION
    chains = {name: [PipelineStep(name=n, op_id=op, stage=seg, params={})] for name, (n, op) in EDGE_OPS.items()}
    chains["gauss_canny"] = [
        PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING, params={"method": "Gaussian", "ksize": 5}),
        PipelineStep(name="Edge", op_id="segmentation.edge", stage=seg, params={}),
    ]
    return chains


def edge_kernel_checks(gray: torch.Tensor, scene: torch.Tensor, dev) -> dict:
    """K1-K4 against their plain versions, bit for bit: the gradient at
    every Sobel and Laplacian ksize of EDGE_SOBEL_KSIZES and
    EDGE_LAPLACIAN_KSIZES and Prewitt, Canny's candidates at apertures 3, 5
    and 7 and the hysteresis on them, on the BGR batch's gray frames; the
    adaptive threshold at EDGE_BLOCK_SIZES (past 13 taps on the scene), the
    region growing on both; the gradient, Canny's candidates and the
    adaptive threshold on EDGE_ODD_SHAPES too; then the growing and the
    hysteresis on ``_spiral(2048)`` against ``scipy.ndimage.label``
    (4-connected; 3x3)."""

    from scipy import ndimage as ndi

    from yamimageprocessor_tpu_torch.ops import edges as E
    from yamimageprocessor_tpu_torch.ops import growing as G
    from yamimageprocessor_tpu_torch.ops.tables import gaussian_taps
    from yamimageprocessor_tpu_torch.ops.threshold import adaptive_threshold, adaptive_threshold_plain

    err = {"gradient": 0, "canny_candidates": 0, "adaptive_threshold": 0, "region_grow": 0}
    cases = [(E.SOBEL, k) for k in EDGE_SOBEL_KSIZES] + [(E.PREWITT, 3)]
    cases += [(E.LAPLACIAN, k) for k in EDGE_LAPLACIAN_KSIZES]
    rng = np.random.default_rng(24)
    odd = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev) for shape in EDGE_ODD_SHAPES]
    for kind, ksize in cases:
        for frames in [gray] + odd:
            err["gradient"] = max(err["gradient"], exact(
                f"gradient kind {kind} ksize {ksize} {tuple(frames.shape)}", E.gradient_u8(frames, kind, ksize),
                E.gradient_plain(frames, kind, ksize)))
    low, high = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (50, 150))
    for aperture in (3, 5, 7):
        plane = E.canny_candidates(gray, low, high, aperture)
        err["canny_candidates"] = max(err["canny_candidates"], exact(
            f"canny candidates aperture {aperture}", plane, E.canny_candidates_plain(gray, low, high, aperture)))
        exact(f"hysteresis aperture {aperture}", E.hysteresis(plane[:2]), E.hysteresis_plain(plane[:2]))
        for frames in odd:
            err["canny_candidates"] = max(err["canny_candidates"], exact(
                f"canny candidates aperture {aperture} {tuple(frames.shape)}", E.canny_candidates(frames, low, high, aperture),
                E.canny_candidates_plain(frames, low, high, aperture)))
    for block in EDGE_BLOCK_SIZES:
        taps = torch.from_numpy(gaussian_taps(block, 0.0).astype(np.float32)).to(dev)
        for c in (-100, 2, 100):
            c_ceil = torch.tensor(c, dtype=torch.int32, device=dev)
            for frames in [gray if block <= 13 else scene] + (odd if c == 2 else []):
                err["adaptive_threshold"] = max(err["adaptive_threshold"], exact(
                    f"adaptive block {block} C {c} {tuple(frames.shape)}", adaptive_threshold(frames, taps, c_ceil),
                    adaptive_threshold_plain(frames, taps, c_ceil)))
    equal = torch.full((1, SEG_SIDE, SEG_SIDE), 77, dtype=torch.uint8, device=dev)
    grow_cases = ((gray, (50, 50), 10), (scene, (50, 50), 10), (scene, (0, 0), 12), (gray, (-7, 9999), 255),
                  (equal, (1000, 3), 0), (gray, (50, 50), -1), (scene, (0, 0), -1), (odd[0], (2048, 2046), 40))
    for frames, seed, tol in grow_cases:
        sx, sy, t = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (*seed, tol))
        err["region_grow"] = max(err["region_grow"], exact(
            f"region grow {tuple(frames.shape)} seed {seed} tol {tol}", G.region_grow(frames, sx, sy, t),
            G.region_grow_plain(frames, sx, sy, t)))
    spiral = _spiral(SEG_SIDE)
    zero = torch.tensor(0, dtype=torch.int32, device=dev)
    grown = G.region_grow(torch.from_numpy(spiral * 200).to(dev)[None], zero, zero, zero)[0].cpu().numpy() == 255
    lab, _ = ndi.label(spiral == 1, structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    if not np.array_equal(grown, lab == lab[0, 0]):
        raise AssertionError("region grow on the spiral != scipy.ndimage.label's component")
    plane = spiral.copy()
    corner = np.arange(0, SEG_SIDE // 2, 8)  # (4k, 4k) lies on ring k: every even ring holds a strong pixel
    plane[corner, corner] = 2
    edges = E.hysteresis(torch.from_numpy(plane).to(dev)[None])[0].cpu().numpy()
    lab8, _ = ndi.label(plane > 0, structure=np.ones((3, 3)))
    keep = np.zeros(lab8.max() + 1, bool)
    keep[np.unique(lab8[plane == 2])] = True
    keep[0] = False
    if not np.array_equal(edges, keep[lab8]):
        raise AssertionError("hysteresis on the spiral != scipy.ndimage.label's components")
    print(f"edges kernels == plain: gradient {len(cases)} cases, canny candidates 3 apertures, adaptive "
          f"{len(EDGE_BLOCK_SIZES)} block sizes x 3 C (C 2 on the odd shapes), each on the batch and {EDGE_ODD_SHAPES}; "
          f"the hysteresis; region "
          f"grow {len(grow_cases)} cases (noise, the scene, its background, all-equal, tol -1, unaligned rows); "
          f"spiral {SEG_SIDE}^2: region "
          f"grow ({int(grown.sum())} px) and hysteresis ({int(edges.sum())} px, {int(keep.sum())} rings) == scipy")
    return err


def gradient_bounds(kind: int, ksize: int, px: float) -> dict:
    """``{"taps": (ms, by), "folded": (ms, by)}``: the gradient's bound from
    the first count, 4k multiply-adds a pixel (two x-passes and two y-passes)
    and ~20 operations of the magnitude, and from the least count once the
    taps are folded, a pixel's two x-passes and two y-passes costing one
    int32 operation for each nonzero tap but the first of each pass, the
    output ~20 (Sobel, Prewitt: the magnitude) or 5 (the Laplacian's add,
    absolute value, INT32_MIN test and saturation); 1 B in and 1 B out a
    pixel both ways."""

    from yamimageprocessor_tpu_torch.ops import edges as E

    t0, t1 = E.gradient_taps(kind, ksize)
    folded = 2 * (int(np.count_nonzero(t0)) - 1 + int(np.count_nonzero(t1)) - 1)
    out = 5 if kind == E.LAPLACIAN else 20
    return {"taps": bound_ms(2 * px, int_ops=(4 * len(t0) + 20) * px),
            "folded": bound_ms(2 * px, int_ops=(folded + out) * px)}


def canny_bounds(aperture: int, px: float) -> dict:
    """``{"taps": (ms, by), "folded": (ms, by)}``: Canny's candidates'
    bound from the first count, 4k + 30 int32 operations a pixel (the two
    x-passes and two y-passes, then the magnitude and the suppression), and
    from the least count once the taps fold (:func:`gradient_bounds`' count
    of the passes) plus the same 30: the L1 magnitude and the directions'
    fixed-point products and compares (~13), the eight neighbour compares,
    the two thresholds and the selects (~17); 1 B in and 1 B out a pixel
    both ways."""

    from yamimageprocessor_tpu_torch.ops.tables import deriv_taps

    t0, t1 = deriv_taps(0, aperture), deriv_taps(1, aperture)
    folded = 2 * (int(np.count_nonzero(t0)) - 1 + int(np.count_nonzero(t1)) - 1)
    return {"taps": bound_ms(2 * px, int_ops=(4 * aperture + 30) * px),
            "folded": bound_ms(2 * px, int_ops=(folded + 30) * px)}


def edge_inputs(dev) -> dict:
    """The edge kernels' timed inputs: the denoise batch's 8 gray 2048^2
    frames and 8 copies of the 2048^2 dense scene (region growing at (0, 0)
    grows over its background: one component over most of each frame)."""

    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray

    gray = bgr_to_gray(torch.from_numpy(denoise_frames()).to(dev)).contiguous()
    scene = torch.from_numpy(dense_scene(SEG_SIDE)).to(dev)[None].repeat(gray.shape[0], 1, 1).contiguous()
    return {"gray": gray, "background": scene}


def edge_kernel_times(gray: torch.Tensor, dev) -> dict:
    """Device ms of K1-K4, their plain versions and (the gradient) conv2d
    in float32, on the BGR batch's gray frames at the ops' defaults, with
    the bounds; then the gradient at EDGE_TIMED_GRADIENTS and region growing
    on the background stack (:func:`edge_inputs`), each beside its plain
    version and its bound (the gradient's both ways, :func:`gradient_bounds`)."""

    import torch.nn.functional as F

    from yamimageprocessor_tpu_torch.ops import edges as E
    from yamimageprocessor_tpu_torch.ops import growing as G
    from yamimageprocessor_tpu_torch.ops.tables import gaussian_taps
    from yamimageprocessor_tpu_torch.ops.threshold import adaptive_threshold, adaptive_threshold_plain

    px = float(gray.numel())
    low, high = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (50, 150))
    taps = torch.from_numpy(gaussian_taps(11, 0.0).astype(np.float32)).to(dev)
    c_ceil = torch.tensor(2, dtype=torch.int32, device=dev)
    sx, sy, tol = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (50, 50, 10))
    times = {
        "gradient": paired_ms(lambda: E.gradient_u8(gray, E.SOBEL, 3), lambda: E.gradient_plain(gray, E.SOBEL, 3),
                              plain_runs=3),
        "canny_candidates": paired_ms(lambda: E.canny_candidates(gray, low, high, 3),
                                      lambda: E.canny_candidates_plain(gray, low, high, 3), plain_runs=3),
        "adaptive_threshold": paired_ms(lambda: adaptive_threshold(gray, taps, c_ceil),
                                        lambda: adaptive_threshold_plain(gray, taps, c_ceil), plain_runs=3),
        "region_grow": paired_ms(lambda: G.region_grow(gray, sx, sy, tol),
                                 lambda: G.region_grow_plain(gray, sx, sy, tol), plain_runs=3),
    }
    # Sobel's two 3x3 derivatives as one float32 conv2d (zero padding, no magnitude: the yardstick only)
    d = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=dev)
    weight = torch.stack([d, d.t()]).unsqueeze(1)
    planes = gray.to(torch.float32).unsqueeze(1)
    torch.backends.cudnn.allow_tf32 = False
    library = {"gradient": time_ms(lambda: F.conv2d(planes, weight, padding=1)), "canny_candidates": None,
               "adaptive_threshold": None, "region_grow": None}
    k11 = 11
    sobel3 = gradient_bounds(E.SOBEL, 3, px)
    canny3 = canny_bounds(3, px)
    bounds = {
        # the least count once the taps fold (the 4k + 20 count beside it below)
        "gradient": sobel3["folded"],
        # the same, plus the magnitude and the suppression (the 4k + 30 count beside it below)
        "canny_candidates": canny3["folded"],
        # 2k fused multiply-adds a pixel (x-pass, y-pass)
        "adaptive_threshold": bound_ms(2 * px, f32_inst=2 * k11 * px),
        # gray in, output out (the labels are scratch)
        "region_grow": bound_ms(2 * px),
    }
    for name in times:
        print(f"edges {name}: {times[name][0]:.4f} ms (plain {times[name][1]:.4f} ms, library {library[name]}), "
              f"bound {bounds[name][0]:.4f} ms by {bounds[name][1]} on {tuple(gray.shape)}")
    print(f"edges gradient sobel 3: bound {sobel3['taps'][0]:.4f} ms (4k + 20 int32 a pixel), "
          f"{sobel3['folded'][0]:.4f} ms (folded taps)")
    print(f"edges canny_candidates aperture 3: bound {canny3['taps'][0]:.4f} ms (4k + 30 int32 a pixel), "
          f"{canny3['folded'][0]:.4f} ms (folded taps + 30)")
    cases = {}
    for name, ksize in EDGE_TIMED_GRADIENTS[1:]:
        kind = E.KINDS[name]
        ms, plain = paired_ms(lambda: E.gradient_u8(gray, kind, ksize), lambda: E.gradient_plain(gray, kind, ksize),
                              plain_runs=3)
        both = gradient_bounds(kind, ksize, px)
        cases[f"gradient {name} {ksize}"] = {"ms": ms, "plain_ms": plain, "bound_ms": both["folded"][0],
                                             "taps_bound_ms": both["taps"][0]}
    for aperture in (5, 7):
        ms, plain = paired_ms(lambda: E.canny_candidates(gray, low, high, aperture),
                              lambda: E.canny_candidates_plain(gray, low, high, aperture), plain_runs=3)
        both = canny_bounds(aperture, px)
        cases[f"canny_candidates {aperture}"] = {"ms": ms, "plain_ms": plain, "bound_ms": both["folded"][0],
                                                 "taps_bound_ms": both["taps"][0]}
    for block in EDGE_TIMED_BLOCK_SIZES:
        if block == k11 or block > 35:  # past 35 the plain version takes seconds a call
            continue
        taps_k = torch.from_numpy(gaussian_taps(block, 0.0).astype(np.float32)).to(dev)
        ms, plain = paired_ms(lambda: adaptive_threshold(gray, taps_k, c_ceil),
                              lambda: adaptive_threshold_plain(gray, taps_k, c_ceil), plain_runs=3)
        cases[f"adaptive_threshold {block}"] = {"ms": ms, "plain_ms": plain,
                                                "bound_ms": bound_ms(2 * px, f32_inst=2 * block * px)[0]}
    background = edge_inputs(dev)["background"]
    zero, tol12 = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (0, 12))
    ms, plain = paired_ms(lambda: G.region_grow(background, zero, zero, tol12),
                          lambda: G.region_grow_plain(background, zero, zero, tol12), plain_runs=3)
    cases["region_grow background (0, 0) tol 12"] = {"ms": ms, "plain_ms": plain,
                                                     "bound_ms": bound_ms(2 * background.numel())[0]}
    for name, row in cases.items():
        print(f"edges {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + f" on {tuple(gray.shape)}")
    return {"times": times, "bounds": bounds, "library": library, "cases": cases}


def edge_cases(dev) -> dict:
    """The gradient at EDGE_TIMED_GRADIENTS and Sobel 9 (the runtime-k
    kernel), Canny's candidates at apertures 3, 5 and 7, the adaptive
    threshold at EDGE_TIMED_BLOCK_SIZES (C 2) on the gray frames, and region
    growing on the noise (seed (50, 50), tol 10) and the background (seed
    (0, 0), tol 12) of :func:`edge_inputs`: device ms and a SHA-256 of
    every output."""

    from yamimageprocessor_tpu_torch.ops.tables import gaussian_taps
    from yamimageprocessor_tpu_torch.ops.threshold import adaptive_threshold

    from yamimageprocessor_tpu_torch.ops import edges as E
    from yamimageprocessor_tpu_torch.ops import growing as G

    inputs = edge_inputs(dev)
    gray = inputs["gray"]
    calls = {f"gradient {name} {k}": (lambda kind=E.KINDS[name], k=k: E.gradient_u8(gray, kind, k))
             for name, k in EDGE_TIMED_GRADIENTS + (("sobel", 9),)}
    low, high = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (50, 150))
    for aperture in (3, 5, 7):
        calls[f"canny_candidates {aperture}"] = lambda a=aperture: E.canny_candidates(gray, low, high, a)
    c_ceil = torch.tensor(2, dtype=torch.int32, device=dev)
    for block in EDGE_TIMED_BLOCK_SIZES:
        taps = torch.from_numpy(gaussian_taps(block, 0.0).astype(np.float32)).to(dev)
        calls[f"adaptive_threshold {block}"] = lambda t=taps: adaptive_threshold(gray, t, c_ceil)
    for name, seed, tol in (("gray", (50, 50), 10), ("background", (0, 0), 12)):
        sx, sy, t = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (*seed, tol))
        calls[f"region_grow {name} {seed} tol {tol}"] = lambda f=inputs[name], a=sx, b=sy, c=t: G.region_grow(f, a, b, c)
    digests = {name: sha256(fn()) for name, fn in calls.items()}
    times = {name: time_ms(fn) for name, fn in calls.items()}
    return {"times": times, "digests": digests}


#: each timed phase's cases, by the name ``--times-one`` takes
TIMED_PHASES = {"filters": filter_cases, "extraction": extraction_cases, "texture": texture_cases,
                "shape": shape_cases, "stream": stream_cases, "edges": edge_cases}
#: the command-line flag of each timed phase
TIMES_FLAGS = {"--times-of": "filters", "--extraction-times-of": "extraction", "--texture-times-of": "texture",
               "--shape-times-of": "shape", "--stream-times-of": "stream", "--edges-times-of": "edges"}


def phase_edges(dev) -> dict:
    """The seven ops and the Gaussian -> Canny chain through the chain
    runner on the BGR batch and the scene, and frame 0 through the
    manager, in one run with the counts set to 0; each output against the
    JAX package's digest, a 512^2 crop of each input against the port's CPU
    run; then K1-K4 against their plain versions, and their times."""

    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    begin = time.perf_counter()
    images = denoise_frames()
    check_digest("denoise_input", images)
    scene = dense_scene(SEG_SIDE)
    check_digest("segmentation_input", scene)
    x = torch.from_numpy(images).to(dev)
    xs = torch.from_numpy(scene).to(dev)[None]
    chains = edge_steps()
    runners = {name: (_batch_chain(steps, DENOISE_SHAPE, dev), _batch_chain(steps, (1, SEG_SIDE, SEG_SIDE), dev))
               for name, steps in chains.items()}
    managers = {name: PipelineManager(steps, device=dev) for name, steps in chains.items()}

    def main_path():
        out = {}
        for name, ((fb, db), (fs, ds)) in runners.items():
            out[name] = (fb(x, db)[-1], fs(xs, ds)[-1], managers[name].apply(images[0]))
        return out

    run = drive("edges", EDGE_KERNELS + ("cc",), main_path)
    for name, (bgr_out, scene_out, frame_out) in run["out"].items():
        check_digest(f"edges_{name}_bgr", bgr_out)
        check_digest(f"edges_{name}_scene", scene_out[0])
        exact(f"edges {name} manager.apply frame 0", torch.from_numpy(frame_out), bgr_out[0].cpu())
    crop = EDGE_CPU_SIDE
    for name, steps in chains.items():
        for label, frames in (("bgr", images[:1, :crop, :crop]), ("scene", scene[None, :crop, :crop])):
            shape = frames.shape
            card_fn, card_dyn = _batch_chain(steps, shape, dev)
            cpu_fn, cpu_dyn = _batch_chain(steps, shape, "cpu")
            exact(f"edges {name} {label} {crop}^2 cuda vs cpu", card_fn(torch.from_numpy(frames).to(dev), card_dyn)[-1].cpu(),
                  cpu_fn(torch.from_numpy(frames), cpu_dyn)[-1])
    print(f"edges: {len(chains)} chains on {DENOISE_SHAPE} and the {SEG_SIDE}^2 scene == the JAX package's digests; "
          f"{crop}^2 crops == the port's CPU run; manager.apply == the chain runner")
    gray = bgr_to_gray(x).contiguous()
    err = edge_kernel_checks(gray, xs.contiguous(), dev)
    timed = edge_kernel_times(gray, dev)
    chain_ms = {name: time_ms(lambda f=f, d=d: f(x, d), runs=5) for name, ((f, d), _) in runners.items()}
    print(f"edges chains device ms on {DENOISE_SHAPE}: {json.dumps(chain_ms)}")
    for name in ("sobel", "edge", "adaptive", "region_growing"):
        f, d = runners[name][0]
        print_profile(f"edges {name}", chain_profile(lambda: f(x, d), _EDGE_GROUPS))
    print(f"edges phase: {time.perf_counter() - begin:.1f} s")
    return {"launches": run["launches"], "err": err, **timed}


# ---------------------------------------------------------------------------
# extraction: region properties (BASELINE config 4)


def extraction_frame(side: int = EXTRACT_SIDE, seed: int = 3) -> np.ndarray:
    """``bench.py:_extra_extraction``'s BGR frame: the dense scene, gray
    repeated over three channels."""

    return np.repeat(dense_scene(side, seed)[..., None], 3, axis=-1)


def blobs_frame(side: int = BLOBS_SIDE) -> np.ndarray:
    """4x4 blobs of 220 on an 8-pixel pitch, BGR: (side / 8)^2 regions (a
    copy of ``scripts/torch_port_digests.py:blobs_frame``)."""

    img = np.zeros((side, side), np.uint8)
    for y in range(2, side, 8):
        img[y : y + 4] = np.where((np.arange(side) % 8 >= 2) & (np.arange(side) % 8 < 6), 220, 0)
    return np.repeat(img[..., None], 3, axis=-1)


def tall_disk_mask(side: int = TALL_SIDE, radius: int = TALL_RADIUS) -> np.ndarray:
    """One frame holding one disk of ``radius``: the hull's longest chain."""

    yy, xx = np.ogrid[:side, :side]
    return ((yy - side // 2) ** 2 + (xx - side // 2) ** 2 <= radius * radius)[None]


def disk_contour(radius: int) -> np.ndarray:
    """The boundary pixels of a digital disk of ``radius`` (those with a
    4-neighbour outside) by angle from the top, int64 ``(x, y)``: about 4
    sqrt(2) radius points, a contour without a trace."""

    r = np.arange(-radius, radius + 1)
    yy, xx = np.meshgrid(r, r, indexing="ij")
    inside = yy**2 + xx**2 <= radius * radius
    pad = np.pad(inside, 1)
    edge = inside & ~(pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:])
    y, x = np.nonzero(edge)
    order = np.argsort(np.arctan2(x - radius, -(y - radius)), kind="stable")
    return np.stack([x[order], y[order]], axis=1).astype(np.int64) + 48


def polygon_adversarial_cases() -> list:
    """(contour, polygons) pairs where the boundary errors' filter, its
    ties and its range matter: a square ring of lattice points and a
    wobbling strip, each against a square (points on its edges and
    vertices), its first one and two vertices, its vertices repeated
    (denom == 0), a polygon with collinear runs, every fifth contour point,
    the contour itself and one point thrice; the ring scaled by 3 and moved
    so that its coordinates reach 2^24 (the filter's proven range), 2^24 +
    1, -2^24 and -2^24 - 1, each against a square, a quadrilateral and a
    two-vertex polygon half the range long."""

    rng = np.random.default_rng(24)
    square = np.array([[0, 0], [6, 0], [6, 6], [0, 6]])
    ring = np.array([[x, 0] for x in range(7)] + [[6, y] for y in range(1, 7)] + [[x, 6] for x in range(5, -1, -1)]
                    + [[0, y] for y in range(5, 0, -1)])
    wobble = rng.integers(-3, 4, (300, 2)) + np.stack([np.arange(300) % 40, np.arange(300) // 40 * 3], 1)
    cases = [(contour, [square, square[:1], square[:2], np.repeat(square, 2, axis=0),
                        np.array([[0, 0], [2, 0], [4, 0], [6, 0], [6, 6], [3, 6], [0, 6]]), contour[::5], contour,
                        np.array([[3, 3], [3, 3], [3, 3]])]) for contour in (ring, wobble)]
    limit = POLYGON_FILTER_LIMIT
    for base in (limit - 18, limit - 17, -limit, -limit - 1):
        cases.append((ring * 3 + base, [square * 3 + base, np.array([[0, 0], [18, 1], [17, 18], [1, 17]]) + base,
                                        np.array([[0, 0], [limit // 2, 0]]) + base]))
    return cases


def pack_polygon_cases(cases) -> tuple:
    """The arguments of ``polygon_mean_errors`` for (contour, polygons)
    pairs, as numpy: int32 points, offsets (a list), int32 vertices, int64
    vertex offsets and owners."""

    from yamimageprocessor_tpu_torch.ops.polygon import pack_candidates

    contours = [c for c, _ in cases]
    points = np.concatenate(contours).astype(np.int32)
    offsets = [0] + np.cumsum([len(c) for c in contours]).tolist()
    owner = np.array([r for r, (_, ps) in enumerate(cases) for _ in ps], np.int64)
    verts, vert_offsets = pack_candidates([p for _, ps in cases for p in ps])
    return points, offsets, verts.numpy(), vert_offsets.numpy(), owner


def convex_chain_masks(side: int = CHAIN_SIDE):
    """(masks, vertices): two frames of one region each whose right (frame
    0) or left (frame 1) outline is a strictly convex lattice chain of
    ``vertices`` vertices, near ``hull_stack_capacity(side, side)``: the
    primitive edge vectors (dt, dx) taken cheapest first by ``2 dt + |dx|``
    while the rows and the columns last, in order of falling slope, each
    row between two vertices at the floor of their chord."""

    from math import gcd

    cands = [(a, n - a if up else a - n) for n in range(1, 400) for a in range(1, n + 1)
             for up in ((True, False) if a < n else (True,)) if gcd(a, n - a) == 1]
    cands.sort(key=lambda v: (2 * v[0] + abs(v[1]), -v[1]))
    rows, rise, fall, chosen = side - 1, side - 1, side - 1, []
    for a, b in cands:
        if a <= rows and (b <= rise if b >= 0 else -b <= fall):
            chosen.append((a, b))
            rows -= a
            rise, fall = (rise - b, fall) if b >= 0 else (rise, fall + b)
    chosen.sort(key=lambda v: -v[1] / v[0])
    t, x = 0, (side - 1) - sum(b for _, b in chosen if b > 0)
    edge = np.full(side, -1, np.int64)
    edge[0] = x
    for a, b in chosen:
        ts = np.arange(t, t + a + 1)
        edge[ts] = (x * a + (ts - t) * b) // a
        t, x = t + a, x + b
    right = np.arange(side)[None, :] <= edge[:, None]
    return np.stack([right, right[:, ::-1]]), len(chosen) + 1


def annotation_edge_boxes(n: int, h: int, w: int) -> torch.Tensor:
    """(n, 8, 7) int32 annotation boxes (``annotation_boxes``' rows):
    a box clipped at all four frame edges, a box one pixel wide, a later
    region's outline across an earlier region's disk, a disk across the
    frame's corner, an invalid box, then random boxes reaching past the
    frame; frame k's boxes shifted by k."""

    rng = np.random.default_rng(5)
    rows = []
    for k in range(n):
        fixed = [
            [0, 0, 0, 0, 0, 0, 0],  # region 0, never painted
            [1, -1, -1, h, w, h // 2, w // 2],
            [1, 5, 10 + k, 15, 11 + k, 9, 10 + k],
            [1, 8, 3, 30, 12 + k, 25, 5],
            [1, 0, w - 10, 2, w, k, w - 2],
            [0, 3, 3, 9, 9, 5, 5],
        ]
        rand = [[1, *rng.integers(-4, h + 4, 1), *rng.integers(-4, w + 4, 1), *rng.integers(-4, h + 4, 1),
                 *rng.integers(-4, w + 4, 1), *rng.integers(-4, h + 4, 1), *rng.integers(-4, w + 4, 1)]
                for _ in range(2)]
        rows.append(fixed + rand)
    return torch.tensor(rows, dtype=torch.int32)


def table_digest(tables) -> str:
    """SHA-256 of the exact columns (area, bbox, solidity over regions
    1..n; int64, int64, float64) of the port's tables, as
    ``scripts/torch_port_digests.py:table_digest`` hashes the JAX
    package's."""

    h = hashlib.sha256()
    for t in tables:
        for column, dtype in ((t["meas"].area, np.int64), (t["meas"].bbox, np.int64), (t["solidity"], np.float64)):
            h.update(np.ascontiguousarray(np.asarray(column)[1:], dtype=dtype).tobytes())
    return h.hexdigest()


def same_tables(name: str, got, want) -> None:
    """Every column of two lists of tables equal bit for bit."""

    for k, (a, b) in enumerate(zip(got, want)):
        for col in ("area", "bbox", "centroid_r", "centroid_c", "mu20", "mu02", "mu11", "perimeter"):
            if not np.array_equal(getattr(a["meas"], col), getattr(b["meas"], col)):
                raise AssertionError(f"{name} frame {k}: {col} differs")
        if not np.array_equal(a["solidity"], b["solidity"]):
            raise AssertionError(f"{name} frame {k}: solidity differs")


def hull_of(RP, case: dict) -> torch.Tensor:
    """The hull kernel's wrapper on a case (a checkout whose wrapper takes
    no width: without it)."""

    import inspect

    args = (case["mn"], case["mx"], case["lo"], case["hi"])
    if "width" in inspect.signature(RP.hull_pixel_areas).parameters:
        return RP.hull_pixel_areas(*args, width=case["labels"].shape[2])
    return RP.hull_pixel_areas(*args)


def measured_case(labels: torch.Tensor, imgs: torch.Tensor) -> dict:
    """The label pass's outputs on ``labels`` and the annotation boxes:
    the hull's and the annotation's inputs."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD
    from yamimageprocessor_tpu_torch.ops import regionprops as RP

    nseg = XD.region_count_bound(labels)
    box, sums, mn, mx = RP.region_scan(labels, nseg)
    return {"labels": labels, "nseg": nseg, "mn": mn, "mx": mx, "box": box, "lo": box[..., 0].contiguous(),
            "hi": box[..., 2].contiguous(), "sums": sums, "boxes": XD.annotation_boxes(box, sums), "imgs": imgs}


def extraction_kernels_vs_plain(name: str, labels: torch.Tensor, imgs: torch.Tensor) -> dict:
    """The label pass, the hull and the annotation (on ``imgs``) against
    their plain versions on one batch of labels, bit for bit; the label
    pass also against the parent's composition (row extremes, their bbox,
    the sums about the bbox centre).  Returns the intermediates for
    timing."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD
    from yamimageprocessor_tpu_torch.ops import regionprops as RP

    case = measured_case(labels, imgs)
    nseg, box, sums, mn, mx = case["nseg"], case["box"], case["sums"], case["mn"], case["mx"]
    pbox, psums, pmn, pmx = RP.region_scan_plain(labels, nseg)
    err = {"region_scan": max(exact(f"region_scan {name} {k}", a, b) for k, a, b in
                              (("box", box, pbox), ("sums", sums, psums), ("mn", mn, pmn), ("mx", mx, pmx)))}
    omn, omx = RP.row_extremes_plain(labels, nseg)
    obox = RP.bounding_boxes(omn, omx)
    sr2, sc2 = (obox[..., 0] + obox[..., 2]).contiguous(), (obox[..., 1] + obox[..., 3]).contiguous()
    for k, a, b in (("box", box, obox), ("sums", sums, RP.moment_sums_plain(labels, sr2, sc2, nseg)),
                    ("mn", mn, omn), ("mx", mx, omx)):
        exact(f"region_scan {name} {k} vs the parent's composition", a, b)
    lo, hi, boxes = case["lo"], case["hi"], case["boxes"]
    err["hull_areas"] = exact(f"hull_areas {name}", hull_of(RP, case), RP.hull_pixel_areas_plain(mn, mx, lo, hi))
    err["annotate"] = exact(f"annotate {name}", XD.region_annotate(imgs, boxes), XD.region_annotate_plain(imgs, boxes))
    torch.cuda.synchronize()
    case["err"] = err
    return case


def annotation_edge_cases(dev) -> int:
    """The annotation kernel against its plain version on
    :func:`annotation_edge_boxes`, gray and BGR, uint8, uint16 and
    float32; returns the max abs error (0)."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD

    n, h, w = EDGE_SHAPE
    boxes = annotation_edge_boxes(n, h, w).to(dev)
    rng = np.random.default_rng(6)
    err = 0
    for shape in ((n, h, w), (n, h, w, 3)):
        for dtype in (torch.uint8, torch.uint16, torch.float32):
            imgs = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int32)).to(dtype).to(dev)
            err = max(err, exact(f"annotate edge boxes {tuple(shape)} {dtype}", XD.region_annotate(imgs, boxes),
                                 XD.region_annotate_plain(imgs, boxes)))
    return err


def region_scan_bound(labels: torch.Tensor, nseg: int):
    """The label pass's bound: the labels read once, the (N, nseg, H)
    extremes, the boxes and the sums written once."""

    from yamimageprocessor_tpu_torch.ops import regionprops as RP

    n, h, w = labels.shape
    g = n * nseg
    return bound_ms(4 * n * h * w + 2 * 4 * g * h + 4 * 4 * g + 8 * RP.SUMS * g)


def extraction_kernel_times(case: dict, hull_annotate: dict) -> dict:
    """Each kernel's, its plain version's and the library calls' device
    ms on one case (the hull's and the annotation's from
    :func:`hull_annotate_times`), and each kernel's bound."""

    from yamimageprocessor_tpu_torch.ops import regionprops as RP

    lab, nseg = case["labels"], case["nseg"]
    n, h, w = lab.shape
    times = {
        "region_scan": paired_ms(lambda: RP.region_scan(lab, nseg), lambda: RP.region_scan_plain(lab, nseg),
                                 plain_runs=3),
        **{k: (v["ms"], v["plain_ms"]) for k, v in hull_annotate.items()},
    }
    # the PyTorch calls that compute the label pass's function, given its
    # index and values: scatter_reduce_ amin and amax for the extremes,
    # index_add_ of the (pixels, 9) sums (the port calls neither)
    slot = RP._region_index(lab, nseg)
    rows = torch.arange(h, device=lab.device).reshape(1, h, 1)
    at = torch.where(slot < n * nseg, slot * h + rows, n * nseg * h).reshape(-1)
    cols = torch.arange(w, dtype=torch.int32, device=lab.device).expand(n, h, w).reshape(-1)
    fmn = torch.full((n * nseg * h + 1,), RP.BIG, dtype=torch.int32, device=lab.device)
    fmx = torch.full((n * nseg * h + 1,), -1, dtype=torch.int32, device=lab.device)
    vslot, values = RP.origin_values(lab, nseg)
    acc = torch.zeros((n * nseg + 1, RP.SUMS), dtype=torch.int64, device=lab.device)
    library = {
        "region_scan": time_ms(lambda: (fmn.scatter_reduce_(0, at, cols, "amin"),
                                        fmx.scatter_reduce_(0, at, cols, "amax"), acc.index_add_(0, vslot, values))),
        "hull_areas": None,
        "annotate": None,
    }
    del vslot, values, slot, at, cols
    bounds = {"region_scan": region_scan_bound(lab, nseg), **hull_annotate_bounds(case)}
    return {"times": times, "library": library, "bounds": bounds}


def hull_annotate_bounds(case: dict) -> dict:
    """The hull's and the annotation's bounds on a case."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD

    n, h, w = case["labels"].shape
    g = n * case["nseg"]
    heights = float((case["hi"] - case["lo"] + 1).clamp_min(0)[:, 1:].sum())
    imgs = case["imgs"]
    return {
        # each region's rows of mn and mx, its first and last row in; the area out
        "hull_areas": bound_ms(2 * 4 * heights + 2 * 4 * g + 8 * g),
        # the image and the boxes in, the annotated image out
        "annotate": bound_ms(2 * imgs.numel() * imgs.element_size() + 4 * XD.ANNOTATION_BOX * g),
    }


def longest_rows(case: dict) -> int:
    """Rows of the case's tallest region: the hull's longest chain."""

    return int((case["hi"] - case["lo"] + 1).clamp_min(0)[:, 1:].max()) if case["nseg"] > 1 else 0


def hull_annotate_times(name: str, case: dict, plain_runs: int) -> dict:
    """The hull's and the annotation's kernel and plain ms on a case
    (plain, kernel, kernel, plain), beside their bounds and the tallest
    region's rows; printed."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD
    from yamimageprocessor_tpu_torch.ops import regionprops as RP

    mn, mx, lo, hi, boxes, imgs = (case[k] for k in ("mn", "mx", "lo", "hi", "boxes", "imgs"))
    times = {
        "hull_areas": paired_ms(lambda: hull_of(RP, case), lambda: RP.hull_pixel_areas_plain(mn, mx, lo, hi),
                                plain_runs=plain_runs),
        "annotate": paired_ms(lambda: XD.region_annotate(imgs, boxes), lambda: XD.region_annotate_plain(imgs, boxes),
                              plain_runs=plain_runs),
    }
    bounds = hull_annotate_bounds(case)
    out = {k: {"ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bounds[k][0]} for k in times}
    out["hull_areas"]["longest_rows"] = longest_rows(case)
    print(f"time on {name} ({case['nseg'] - 1} regions max, tallest {longest_rows(case)} rows): hull_areas kernel "
          f"{times['hull_areas'][0]:.4f} ms, plain {times['hull_areas'][1]:.4f}, bound "
          f"{bounds['hull_areas'][0]:.6f}; annotate kernel {times['annotate'][0]:.4f}, plain "
          f"{times['annotate'][1]:.4f}, bound {bounds['annotate'][0]:.4f}")
    return out


def wall_ms(fn, calls: int = EXTRACT_REPS) -> float:
    """Host wall ms a call of ``fn`` back to back, after a warm call, each
    call ending in what it reads back from the device."""

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / calls


def phase_extraction(dev) -> dict:
    from yamimageprocessor_tpu_torch.ops import extraction_device as XD
    from yamimageprocessor_tpu_torch.ops import regionprops as RP
    from yamimageprocessor_tpu_torch.ops.extraction import REGION_COLUMNS, histogram_data, hu_moments_data
    from yamimageprocessor_tpu_torch.ops.labeling import label
    from yamimageprocessor_tpu_torch.ops.registry import get_impl
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    frame = extraction_frame()
    batches = {n: [extraction_frame(seed=s) for s in range(n)] for n in EXTRACT_BATCHES}
    wide = extraction_frame(EXTRACT_WIDE_SIDE)
    blobs = blobs_frame()
    for key, frames in (("1024", [frame]), ("4096", [wide]), ("blobs", [blobs]),
                        *((f"batch{n}", b) for n, b in batches.items())):
        check_digest(f"extract_{key}_input", np.stack(frames))
    impl = get_impl("extraction.region_properties")
    manager = PipelineManager([PipelineStep(name="Region Properties", stage=Stage.ANALYSIS)], device=dev)

    XD.clear_table_cache()
    # the table path, then the annotation path, each with the counts set to 0
    tables_run = drive(
        "extraction tables",
        ("histogram256", "cc", "region_scan", "hull_areas"),
        lambda: (
            impl.data_fn(frame),
            {n: XD.region_tables(b) for n, b in batches.items()},
            XD.region_tables([wide]),
            XD.region_tables([blobs]),
            hu_moments_data(frame),
            histogram_data(frame),
        ),
    )
    annotation_run = drive("extraction annotation", ("histogram256", "cc", "region_scan", "annotate"),
                           lambda: manager.apply(frame))
    data, batch_tables, wide_tables, blob_tables, hu, hist = tables_run["out"]
    annotated = annotation_run["out"]
    launches = {k: tables_run["launches"].get(k, 0) + annotation_run["launches"].get(k, 0)
                for k in ("histogram256", "cc") + EXTRACT_KERNELS}
    one = XD.region_table(frame)  # a memo hit: the table data_fn made
    counts = {"1024": [one["meas"].count], "4096": [t["meas"].count for t in wide_tables],
              "blobs": [t["meas"].count for t in blob_tables]}
    for key, tables in (("1024", [one]), ("4096", wide_tables), ("blobs", blob_tables),
                        *((f"batch{n}", t) for n, t in batch_tables.items())):
        got = table_digest(tables)
        if got != DIGESTS[f"extract_{key}_table"]:
            raise AssertionError(f"extract_{key}_table: {got}, the JAX package's is {DIGESTS[f'extract_{key}_table']}")
    # the dense scene has a disk every 128 pixels, the blobs one every 8
    want = {"1024": [(EXTRACT_SIDE // 128) ** 2], "4096": [(EXTRACT_WIDE_SIDE // 128) ** 2],
            "blobs": [(BLOBS_SIDE // 8) ** 2]}
    if counts != want:
        raise AssertionError(f"extraction region counts {counts}, want {want}")
    if tuple(data) != REGION_COLUMNS or data["centroid"].shape != (want["1024"][0], 2):
        raise AssertionError(f"extraction data_fn columns {tuple(data)}")
    check_digest("extract_annotated_1024", annotated)
    XD.clear_table_cache()
    cpu_frames = [frame] + batches[EXTRACT_BATCHES[0]][:EXTRACT_CPU_BATCH]
    same_tables("extraction cuda vs cpu", [one] + batch_tables[EXTRACT_BATCHES[0]][:EXTRACT_CPU_BATCH],
                XD.region_tables(cpu_frames, device="cpu"))
    exact("extraction annotation cuda vs cpu", torch.from_numpy(annotated),
          XD.region_properties_device_fn(torch.from_numpy(frame)[None], {})[0])
    for name, got, want in (("hu_moments", hu, hu_moments_data(frame, device="cpu")),
                            ("histogram", hist, histogram_data(frame, device="cpu"))):
        if list(got) != list(want) or any(not np.array_equal(got[k], want[k]) for k in got):
            raise AssertionError(f"extraction {name} data on cuda differs from the CPU run: {got} {want}")
    print(f"extraction: exact columns == the JAX package's digests on {EXTRACT_SIDE}^2 ({counts['1024'][0]} regions), batches of "
          f"{EXTRACT_BATCHES}, {EXTRACT_WIDE_SIDE}^2 ({counts['4096'][0]} regions) and {BLOBS_SIDE}^2 blobs "
          f"({counts['blobs'][0]} regions); the annotated {EXTRACT_SIDE}^2 frame == its digest; every column == "
          f"the port's CPU run on {len(cpu_frames)} frames; data_fn columns {len(data)}; Hu moments and histogram "
          f"statistics == the port's CPU run")

    # kernels A-D against their plain versions
    yy, xx = np.mgrid[:EXTRACT_SIDE, :EXTRACT_SIDE]
    noise = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, EXTRACT_SIDE, EXTRACT_SIDE, 3),
                                                               dtype=np.uint8)).to(dev)
    masks = {
        "checkerboard": (yy + xx) % 2 == 0,
        "all background": np.zeros_like(yy, bool),
        "all foreground": np.ones_like(yy, bool),
    }
    cases = {}
    for name, (labels, imgs) in extraction_label_sets(dev, frame, batches, wide, blobs).items():
        cases[name] = extraction_kernels_vs_plain(name, labels, imgs)
    errors = {k: max(c["err"][k] for c in cases.values()) for k in EXTRACT_KERNELS}
    errors["annotate"] = max(errors["annotate"], annotation_edge_cases(dev))
    print(f"hull: hull_stack_capacity({CHAIN_SIDE}, {CHAIN_SIDE}) = {RP.hull_stack_capacity(CHAIN_SIDE, CHAIN_SIDE)}")
    scene = cases[f"scene {EXTRACT_SIDE}^2"]
    for dtype in (torch.float32, torch.uint16):  # the annotation copies a pixel's bytes whatever the dtype
        imgs = scene["imgs"].to(torch.int32).mul(7).to(dtype)
        errors["annotate"] = max(errors["annotate"], exact(
            f"annotate scene {dtype}", XD.region_annotate(imgs, scene["boxes"]),
            XD.region_annotate_plain(imgs, scene["boxes"])))
    for name, mask in masks.items():
        lab = label(torch.from_numpy(mask)[None].to(dev))
        for colour, imgs in (("BGR", noise), ("gray", noise[..., 0].contiguous())):
            err = extraction_kernels_vs_plain(f"{name} {colour}", lab, imgs)["err"]
            errors = {k: max(errors[k], err[k]) for k in EXTRACT_KERNELS}
    print(f"kernels: region_scan, hull_areas and annotate bit-exact on {', '.join(cases)}, and on a "
          f"{EXTRACT_SIDE}^2 checkerboard, all-background and all-foreground frame (gray and BGR); annotate also on "
          "float32 and uint16 copies of the scene and on boxes clipped at every frame edge, one pixel wide, across "
          "an earlier disk and a disk across a corner (gray and BGR, uint8, uint16, float32); region_scan also "
          "== the parent's composition")
    # the label pass on each of the five label sets
    scan_times = {}
    for name, case in cases.items():
        lab, nseg = case["labels"], case["nseg"]
        scan_times[name] = {"ms": time_ms(lambda: RP.region_scan(lab, nseg)),
                            "bound_ms": region_scan_bound(lab, nseg)[0]}
        print(f"time region_scan on {name} ({nseg - 1} regions max): kernel {scan_times[name]['ms']:.4f} ms, "
              f"bound {scan_times[name]['bound_ms']:.4f}")

    # the hull and the annotation on every label set
    case_times = {name: hull_annotate_times(name, case, plain_runs=1 if name in SLOW_PLAIN_CASES else 3)
                  for name, case in cases.items()}
    main_case, one_case = f"batch {EXTRACT_BATCHES[-1]}", f"scene {EXTRACT_SIDE}^2"
    timed = extraction_kernel_times(cases[main_case], case_times[main_case])
    one_frame = extraction_kernel_times(cases[one_case], case_times[one_case])
    for k in EXTRACT_KERNELS:
        print(f"time {k} on {main_case}: kernel {timed['times'][k][0]:.4f} ms, plain {timed['times'][k][1]:.4f}, "
              f"library {timed['library'][k]}, bound {timed['bounds'][k][0]:.4f} ({timed['bounds'][k][1]}); "
              f"one {EXTRACT_SIDE}^2 frame: kernel {one_frame['times'][k][0]:.4f}, "
              f"bound {one_frame['bounds'][k][0]:.4f}")

    # the data path and the annotation chain: device time (event pairs, the
    # region count known) and back to back on the host clock (upload, the
    # two reads back and the host's float64 finish included)
    rates = {}
    for name, frames in (("1 frame", [frame]), *((f"{n} frames", b) for n, b in batches.items())):
        x = torch.from_numpy(np.stack(frames)).to(dev)
        nseg = XD.region_count_bound(XD.region_labels(x))
        device_ms = time_ms(lambda: XD.region_pack(XD.region_labels(x), nseg), runs=10)

        def tables():
            XD.clear_table_cache()
            return XD.region_tables(frames)

        loop_ms = wall_ms(tables)
        mpix = len(frames) * EXTRACT_SIDE * EXTRACT_SIDE / 1e6
        rates[name] = {"device_ms": device_ms, "wall_ms": loop_ms, "device_mpix_s": mpix / (device_ms / 1e3),
                       "wall_mpix_s": mpix / (loop_ms / 1e3)}
        print(f"extraction data path, {name} of {EXTRACT_SIDE}^2: device {device_ms:.4f} ms "
              f"({rates[name]['device_mpix_s']:.1f} MPix/s); back to back {loop_ms:.4f} ms a call "
              f"({rates[name]['wall_mpix_s']:.1f} MPix/s)")
    # where the 32-frame call's host time goes, one pass on the host clock
    frames = batches[EXTRACT_BATCHES[-1]]
    marks = [time.perf_counter()]
    tokens = [XD._frame_token(f) for f in frames]
    marks.append(time.perf_counter())
    x = torch.from_numpy(np.stack(frames)).to(dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    labels = XD.region_labels(x)
    maxima = labels.amax(dim=(1, 2)).cpu()
    pack = XD.region_pack(labels, int(maxima.max()) + 1).cpu().numpy()
    marks.append(time.perf_counter())
    finished = [XD._finalize_region_table(pack[k, : int(c) + 1], int(c)) for k, c in enumerate(maxima)]
    marks.append(time.perf_counter())
    split = dict(zip(("content tokens", "stack and upload", "device and two reads back", "float64 finish"),
                     np.diff(marks) * 1e3))
    same_tables("extraction host split", finished, batch_tables[EXTRACT_BATCHES[-1]])
    rates["host split 32 frames ms"] = split
    print(f"extraction data path, {len(frames)} frames, host clock split (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; {len(tokens)} tokens")
    x = torch.from_numpy(frame)[None].to(dev)
    nseg = XD.region_count_bound(XD.region_labels(x))

    def annotate_device():
        box, sums, _ = XD.measure(XD.region_labels(x), nseg)
        return XD.region_annotate(x, XD.annotation_boxes(box, sums))

    ann_device = time_ms(annotate_device, runs=10)
    ann_wall = wall_ms(lambda: manager.apply(frame))
    rates["annotation"] = {"device_ms": ann_device, "wall_ms": ann_wall}
    print(f"extraction annotation chain, one {EXTRACT_SIDE}^2 frame: device {ann_device:.4f} ms; manager.apply "
          f"back to back {ann_wall:.4f} ms")
    x32 = torch.from_numpy(np.stack(batches[EXTRACT_BATCHES[-1]])).to(dev)
    nseg32 = XD.region_count_bound(XD.region_labels(x32))
    print_profile("extraction", chain_profile(lambda: XD.region_pack(XD.region_labels(x32), nseg32),
                                              _EXTRACTION_GROUPS))
    del cases
    peak = blobs_peak_memory(blobs)
    torch.cuda.empty_cache()
    return {"launches": launches, "timed": timed, "one_frame": one_frame, "main_case": main_case,
            "rates": rates, "err": errors, "scan_times": scan_times, "case_times": case_times, "peak": peak}


def texture_table_digest(tables) -> str:
    """SHA-256 of what the texture tables were computed from, frame by
    frame, as ``scripts/torch_port_digests.py:texture_table_digest`` hashes
    the JAX package's: the GLCM's pair counts at (1, 0) and the fractal
    dimension's box counts (the ``inputs`` the driven data_fns read back
    from the card), LBP's bin counts and Gabor's mean (their columns).  The
    float64 formulas after the counts (``glcm_props``, ``np.polyfit``) run on
    the host and are held against the port's CPU run instead: they may round
    otherwise on another host's numpy and LAPACK."""

    h = hashlib.sha256()
    for table in tables:
        for values, dtype in (
            (table["haralick"].inputs["counts"], np.int64),
            (table["fractal"].inputs["counts"], np.int64),
            (table["lbp"]["count"], np.int64),
            (table["gabor"]["mean"], np.float64),
        ):
            h.update(np.ascontiguousarray(values, dtype=dtype).tobytes())
    return h.hexdigest()


def lbp_least_ops(p: int, r: float) -> int:
    """Least float32 instructions of a pixel's codes in the chain's
    arithmetic, ``fma(w0, d0, w1 * d1)``, ``fma(w2, d2, .)``, ``fma(w3, d3,
    .)`` a sample: a term whose weight is exactly 0, or whose corner is the
    centre (a difference of 0), changes nothing and is dropped; a sample
    left with one term of weight 1 is its corner's comparison with the
    centre and needs no instruction; any other sample needs one a term (a
    multiply, then FMAs), and each distinct corner those read one
    difference.  The comparisons (which may run on the integer pipe) and
    the code's popcounts are not counted.  At (8, 1): 8 differences and 3
    a diagonal sample, 20."""

    from yamimageprocessor_tpu_torch.ops import texture as TX

    corners, weights = TX.lbp_chain_params(p, r)
    ops, needed = 0, set()
    for (y0, x0), w in zip(corners.tolist(), weights.tolist()):
        terms = [((y0 + k // 2, x0 + k % 2), w[k]) for k in range(4) if w[k] != 0 and (y0 + k // 2, x0 + k % 2) != (0, 0)]
        if len(terms) == 1 and terms[0][1] == 1.0 or not terms:
            continue
        ops += len(terms)
        needed.update(corner for corner, _ in terms)
    return len(needed) + ops


def lbp_f64_least_ops(p: int, r: float, n: int, h: int, w: int) -> int:
    """Least float64 instructions of ``n`` frames' codes in the data path's
    arithmetic, ``v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + ...``
    compared with the centre, on ``h x w`` frames: the fractions and their
    complements once a row and a column of each sample (a position add, a
    floor, a subtraction, a complement: 4 each); a pixel's term with a
    factor exactly 0 is dropped, a factor exactly 1 needs no multiply,
    the terms left need one add fewer than their count.  The fractions are
    this frame size's own (``(y + pad) + dr`` rounds by row)."""

    from yamimageprocessor_tpu_torch.ops import texture as TX

    pad = TX.lbp_pad(r)
    per_pixel = 0
    for dr, dc in TX.lbp_offsets(p, r).tolist():
        ry, cx = (np.arange(h, dtype=np.float64) + pad) + dr, (np.arange(w, dtype=np.float64) + pad) + dc
        fy, fx = ry - np.floor(ry), cx - np.floor(cx)
        terms = np.zeros((h, w), np.int64)
        mults = np.zeros((h, w), np.int64)
        for a in (1 - fy, fy):
            for b in (1 - fx, fx):
                live = (a != 0)[:, None] & (b != 0)[None, :]
                terms += live
                mults += live * ((a != 1).astype(np.int64)[:, None] + (b != 1).astype(np.int64)[None, :])
        per_pixel += int(mults.sum() + np.maximum(terms - 1, 0).sum())
    return n * per_pixel + 4 * p * (h + w)


def texture_edge_checks(dev, err: dict) -> None:
    """The filter and LBP kernels against their plain versions on the
    edge frames (:data:`TEXTURE_EDGE_SHAPES`), every kernel shape of
    :data:`FILTER_EDGE_KERNELS` in both orders and every case of
    :data:`LBP_EDGE_CASES` in both arithmetics, on uint8, uint16 and
    float32 frames (ksize 101 on uint8 only); then the filter's wide
    kernels (one block an SM, the largest whose tile fits) and one it
    refuses."""

    from yamimageprocessor_tpu_torch.ops import texture as TX
    from yamimageprocessor_tpu_torch.ops.filter2d_cuda import filter2d_u8, filter2d_u8_plain

    gen = torch.Generator(device=dev).manual_seed(5)

    def frames(shape, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)
        if dtype == torch.uint16:
            return torch.randint(0, 4000, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)
        return torch.rand(shape, generator=gen, device=dev) * 300 - 20

    for dtype in (torch.uint8, torch.uint16, torch.float32):
        for shape in TEXTURE_EDGE_SHAPES:
            batch = frames(shape, dtype).contiguous()
            for kh, kw in FILTER_EDGE_KERNELS:
                if kh * kw > 10000 and dtype != torch.uint8:
                    continue  # the generic instance again: its plain version costs a launch a tap
                taps = (torch.rand((kh, kw), generator=gen, device=dev) - 0.45).contiguous()
                for xla_order in (True, False):
                    err["filter2d"] = max(err["filter2d"], exact(
                        f"filter2d {dtype} {shape} {kh}x{kw} xla_order={xla_order}",
                        filter2d_u8(batch, taps, xla_order=xla_order),
                        filter2d_u8_plain(batch, taps, xla_order=xla_order)))
            for p, r in LBP_EDGE_CASES:
                for golden in (False, True):
                    err["lbp_codes"] = max(err["lbp_codes"], exact(
                        f"lbp_codes {dtype} {shape} P{p} R{r} golden={golden}",
                        TX.lbp_codes(batch, p, r, golden=golden),
                        (TX.lbp_codes_f64_plain if golden else TX.lbp_codes_f32_plain)(batch, p, r)))
    batch = frames(FILTER_WIDE_SHAPE, torch.uint8).contiguous()
    for k in FILTER_WIDE_KSIZES:
        taps = ((torch.rand((k, k), generator=gen, device=dev) - 0.45) / k).contiguous()
        for xla_order in (True, False):
            err["filter2d"] = max(err["filter2d"], exact(
                f"filter2d {FILTER_WIDE_SHAPE} ksize {k} xla_order={xla_order}",
                filter2d_u8(batch, taps, xla_order=xla_order), filter2d_u8_plain(batch, taps, xla_order=xla_order)))
    k = FILTER_REFUSED_KSIZE
    try:
        filter2d_u8(batch, torch.zeros((k, k), device=dev), xla_order=True)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"filter2d: a ksize-{k} kernel, whose tile does not fit, was not refused")
    print(f"texture edge frames: filter2d at {FILTER_EDGE_KERNELS} in both orders and lbp_codes at {LBP_EDGE_CASES} "
          f"in both arithmetics on {TEXTURE_EDGE_SHAPES}, uint8, uint16 and float32, bit-exact; filter2d at ksizes "
          f"{FILTER_WIDE_KSIZES} on {FILTER_WIDE_SHAPE}, both orders, bit-exact; ksize {FILTER_REFUSED_KSIZE} refused")


def phase_texture(dev) -> dict:
    """The texture features: the LBP, Gabor and HOG chains through the
    pipeline manager on the 32 BGR 1024^2 scenes and the five data_fns on
    the first 8, against the JAX package's digests and the port's CPU run;
    the four kernels against their plain versions; their times, bounds and
    PyTorch yardsticks."""

    from yamimageprocessor_tpu_torch.ops import hogf as HG
    from yamimageprocessor_tpu_torch.ops import texture as TX
    from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
    from yamimageprocessor_tpu_torch.ops.filter2d_cuda import filter2d_u8, filter2d_u8_plain
    from yamimageprocessor_tpu_torch.ops.registry import get_impl
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.ops.tables import gabor_kernel
    from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    frames = np.stack([extraction_frame(seed=s) for s in range(TEXTURE_FRAMES)])
    check_digest("texture_input", frames)
    steps = {n: [PipelineStep(name=n, stage=Stage.ANALYSIS)] for n in TEXTURE_CHAINS}
    managers = {n: PipelineManager(steps[n], device=dev) for n in TEXTURE_CHAINS}
    data_fns = {k: get_impl(f"extraction.{k}").data_fn for k in ("lbp", "haralick", "gabor", "hog", "fractal")}
    run = drive(
        "texture",
        TEXTURE_KERNELS + ("lut_apply", "histogram256"),
        lambda: (
            {n: m.apply(frames) for n, m in managers.items()},
            [{k: fn(f) for k, fn in data_fns.items()} for f in frames[:TEXTURE_TABLE_FRAMES]],
        ),
    )
    outs, tables = run["out"]
    for n in TEXTURE_CHAINS:
        check_digest(f"texture_{n.lower()}_output", outs[n])
    got = texture_table_digest(tables)
    if got != DIGESTS["texture_tables"]:
        raise AssertionError(f"texture_tables: {got}, the JAX package's is {DIGESTS['texture_tables']}")
    for n in TEXTURE_CHAINS:
        cpu = PipelineManager(steps[n], device="cpu").apply(frames[0])
        exact(f"texture {n} cuda vs cpu (frame 0)", torch.from_numpy(outs[n][0]), torch.from_numpy(cpu))
    for k, fn in data_fns.items():
        cpu, card = fn(frames[0], device="cpu"), tables[0][k]
        if list(cpu) != list(card) or any(np.asarray(cpu[c]).tobytes() != np.asarray(card[c]).tobytes() for c in cpu):
            raise AssertionError(f"texture {k}_data on cuda differs from the CPU run")
    tables_ms = {}
    timed_fns = dict(data_fns, hu_moments=get_impl("extraction.hu_moments").data_fn)
    for k, fn in timed_fns.items():
        start = time.perf_counter()
        for f in frames[:TEXTURE_TABLE_FRAMES]:
            fn(f)
        torch.cuda.synchronize()
        tables_ms[k] = (time.perf_counter() - start) * 1e3 / TEXTURE_TABLE_FRAMES
    print(f"texture: {TEXTURE_CHAINS} chains on {frames.shape} == the JAX package's digests == the port's CPU run on "
          f"frame 0; the 5 data_fns on {TEXTURE_TABLE_FRAMES} frames: their exact inputs (GLCM and box counts, "
          f"LBP's bins, Gabor's mean) == the JAX package's digest, every column == the port's CPU run on frame 0; "
          f"host-clock ms a frame (and Hu moments') {json.dumps(tables_ms)}")

    # the kernels against their plain versions
    gray = bgr_to_gray(torch.from_numpy(frames).to(dev)).contiguous()
    flat = torch.full((1, EXTRACT_SIDE, EXTRACT_SIDE), 77, dtype=torch.uint8, device=dev)
    err = {k: 0 for k in TEXTURE_KERNELS}
    for d in GLCM_DISTANCES:
        for a in GLCM_ANGLES:
            dx, dy = TX.glcm_offset(d, a)
            for name, batch in (("scenes", gray[:TEXTURE_TABLE_FRAMES]), ("flat", flat)):
                err["glcm_counts"] = max(err["glcm_counts"], exact(
                    f"glcm_counts {name} d{d} ({dx},{dy})", TX.glcm_counts(batch, dx, dy),
                    TX.glcm_counts_plain(batch, dx, dy)))
    wide = bgr_to_gray(torch.from_numpy(extraction_frame(HOG_WIDE_SIDE))[None].to(dev)).contiguous()
    flat_wide = torch.full((1, HOG_WIDE_SIDE, HOG_WIDE_SIDE), 77, dtype=torch.uint8, device=dev)
    ragged = wide[:, : GLCM_RAGGED_CROP[1], : GLCM_RAGGED_CROP[2]].contiguous()
    glcm_more = [(f"ragged {tuple(ragged.shape)}", ragged, 1, 0),
                 (f"flat {HOG_WIDE_SIDE}^2 (one key, {flat_wide.numel() - HOG_WIDE_SIDE} counts)", flat_wide, 1, 0)]
    glcm_more += [(f"3 scenes ({dx},{dy})", gray[:3], dx, dy) for dx, dy in GLCM_BATCH_OFFSETS]
    for name, batch, dx, dy in glcm_more:
        err["glcm_counts"] = max(err["glcm_counts"], exact(
            f"glcm_counts {name}", TX.glcm_counts(batch, dx, dy), TX.glcm_counts_plain(batch, dx, dy)))
    del flat_wide, ragged
    for p, r in LBP_CASES:
        for golden in (False, True):
            err["lbp_codes"] = max(err["lbp_codes"], exact(
                f"lbp_codes P{p} R{r} golden={golden}", TX.lbp_codes(gray, p, r, golden=golden),
                (TX.lbp_codes_f64_plain if golden else TX.lbp_codes_f32_plain)(gray, p, r)))
    taps = {k: torch.from_numpy(gabor_kernel(k, 5.0, 0.0, 10.0, 0.5, 0.0)).to(dev) for k in FILTER_KSIZES}
    small = gray[:1, :FILTER_SMALL_SIDE, :FILTER_SMALL_SIDE].contiguous()
    for k in FILTER_KSIZES:
        batch = small if k == FILTER_KSIZES[-1] else gray
        for xla_order in (True, False):
            err["filter2d"] = max(err["filter2d"], exact(
                f"filter2d ksize {k} xla_order={xla_order}", filter2d_u8(batch, taps[k], xla_order=xla_order),
                filter2d_u8_plain(batch, taps[k], xla_order=xla_order)))
    hog_ragged = gray[: HOG_RAGGED_CROP[0], : HOG_RAGGED_CROP[1], : HOG_RAGGED_CROP[2]].contiguous()
    for (nb, side), batch in ((HOG_CASES[0], gray), (HOG_CASES[1], gray), (HOG_CASES[0], wide),
                              (HOG_CASES[1], hog_ragged)):
        err["hog_cells"] = max(err["hog_cells"], exact(
            f"hog_cells {nb} bins, {side}x{side} on {tuple(batch.shape)}", HG.hog_cells(batch, nb, side),
            HG.hog_cells_plain(batch, nb, side)))
    for side, nb in HOG_ORDER_CASES:
        crop = gray[:2, : 3 * side, : 8 * side].contiguous()
        err["hog_cells"] = max(err["hog_cells"], exact(
            f"hog_cells {nb} bins, {side}x{side} ({HG.cell_order(side, nb)}) on {tuple(crop.shape)}",
            HG.hog_cells(crop, nb, side), HG.hog_cells_plain(crop, nb, side)))
    # float32 (fractional values) and uint16 frames launch the same kernels
    scenes = gray[:TEXTURE_DTYPE_FRAMES].to(torch.float32)
    others = {
        "float32": (scenes * 0.731 + torch.rand(scenes.shape, generator=torch.Generator(dev).manual_seed(0),
                                                 device=dev) * 3.0).contiguous(),
        "uint16": (scenes.to(torch.int32) * 251 + 17).to(torch.uint16).contiguous(),
    }
    for name, batch in others.items():
        for p, r in LBP_CASES[:2]:
            for golden in (False, True):
                err["lbp_codes"] = max(err["lbp_codes"], exact(
                    f"lbp_codes {name} P{p} R{r} golden={golden}", TX.lbp_codes(batch, p, r, golden=golden),
                    (TX.lbp_codes_f64_plain if golden else TX.lbp_codes_f32_plain)(batch, p, r)))
        for k in FILTER_KSIZES[:-1]:
            for xla_order in (True, False):
                err["filter2d"] = max(err["filter2d"], exact(
                    f"filter2d {name} ksize {k} xla_order={xla_order}",
                    filter2d_u8(batch, taps[k], xla_order=xla_order),
                    filter2d_u8_plain(batch, taps[k], xla_order=xla_order)))
        for nb, side in HOG_CASES:
            err["hog_cells"] = max(err["hog_cells"], exact(
                f"hog_cells {name} {nb} bins, {side}x{side}", HG.hog_cells(batch, nb, side),
                HG.hog_cells_plain(batch, nb, side)))
    texture_edge_checks(dev, err)
    print(f"kernels: glcm_counts bit-exact at distances {GLCM_DISTANCES} and angles 0..pi on 8 scenes and a flat "
          f"frame, and on {[name for name, *_ in glcm_more]}; hog_cells at {HOG_CASES[1]} on {HOG_RAGGED_CROP}; lbp_codes at {LBP_CASES} in both arithmetics on the 32 scenes; filter2d at ksizes "
          f"{FILTER_KSIZES[:-1]} on the 32 scenes and {FILTER_KSIZES[-1]} on {FILTER_SMALL_SIDE}^2, both orders; "
          f"hog_cells at {HOG_CASES} on the 32 scenes and {HOG_CASES[0]} on {HOG_WIDE_SIDE}^2, and at (side, bins) "
          f"{HOG_ORDER_CASES} on 8-cell-wide crops; lbp_codes at {LBP_CASES[:2]}, filter2d at ksizes "
          f"{FILTER_KSIZES[:-1]} and hog_cells at {HOG_CASES} on {TEXTURE_DTYPE_FRAMES} float32 and uint16 scenes")

    # times at the main paths' shapes: GLCM one frame (haralick_data), the
    # other three the 32-frame chains
    px = float(gray.numel())
    one = gray[:1]
    times = {
        "glcm_counts": paired_ms(lambda: TX.glcm_counts(one, 1, 0), lambda: TX.glcm_counts_plain(one, 1, 0)),
        "lbp_codes": paired_ms(lambda: TX.lbp_codes(gray, 8, 1.0), lambda: TX.lbp_codes_f32_plain(gray, 8, 1.0),
                               plain_runs=3),
        "filter2d": paired_ms(lambda: filter2d_u8(gray, taps[21], xla_order=True),
                              lambda: filter2d_u8_plain(gray, taps[21], xla_order=True), plain_runs=1),
        "hog_cells": paired_ms(lambda: HG.hog_cells(gray, 9, 8), lambda: HG.hog_cells_plain(gray, 9, 8),
                               plain_runs=3),
    }
    cells = (EXTRACT_SIDE // 8) ** 2 * TEXTURE_FRAMES
    bounds = {
        "glcm_counts": bound_ms(float(one.numel()) + 65536 * 4),
        "lbp_codes": bound_ms(2 * px, f32_inst=lbp_least_ops(8, 1.0) * px),
        "filter2d": bound_ms(2 * px, f32_inst=21 * 21 * px),
        "hog_cells": bound_ms(px + cells * 9 * 4, f32_inst=HOG_OPS_PER_PIXEL * px),
    }
    small_px = float(small.numel())
    wide_cells = (HOG_WIDE_SIDE // 8) ** 2
    by_input = {
        "glcm_counts": {
            "flat 1024^2": {"ms": time_ms(lambda: TX.glcm_counts(flat, 1, 0)),
                            "bound_ms": bound_ms(float(flat.numel()) + 65536 * 4)[0]},
            "distance 64": {"ms": time_ms(lambda: TX.glcm_counts(one, 64, 0))},
            "8 scenes": {"ms": time_ms(lambda: TX.glcm_counts(gray[:8], 1, 0)),
                         "bound_ms": bound_ms(8 * float(one.numel()) + 8 * 65536 * 4)[0]},
        },
        "lbp_codes": {
            f"P{p} R{r}{' golden' if golden else ''}": {
                "ms": time_ms(lambda: TX.lbp_codes(gray, p, r, golden=golden)),
                "bound_ms": bound_ms(2 * px, **({"f64_inst": lbp_f64_least_ops(p, r, *gray.shape)} if golden else
                                                {"f32_inst": lbp_least_ops(p, r) * px}))[0]}
            for p, r in LBP_CASES for golden in (False, True) if (p, golden) != (8, False)
        },
        "filter2d": {
            "ksize 3": {"ms": time_ms(lambda: filter2d_u8(gray, taps[3], xla_order=True)),
                        "bound_ms": bound_ms(2 * px, f32_inst=9 * px)[0]},
            "ksize 21 numpy order": {"ms": time_ms(lambda: filter2d_u8(gray, taps[21], xla_order=False)),
                                     "bound_ms": bound_ms(2 * px, f32_inst=2 * 441 * px)[0]},
            f"ksize 101 on {FILTER_SMALL_SIDE}^2": {
                "ms": time_ms(lambda: filter2d_u8(small, taps[101], xla_order=True), runs=5),
                "bound_ms": bound_ms(2 * small_px, f32_inst=101 * 101 * small_px)[0]},
        },
        "hog_cells": {
            "32 bins 2x2": {"ms": time_ms(lambda: HG.hog_cells(gray, 32, 2)),
                            "bound_ms": bound_ms(px + px / 4 * 32 * 4, f32_inst=HOG_OPS_PER_PIXEL * px)[0]},
            f"{HOG_WIDE_SIDE}^2": {"ms": time_ms(lambda: HG.hog_cells(wide, 9, 8)),
                                   "bound_ms": bound_ms(float(wide.numel()) + wide_cells * 9 * 4,
                                                        f32_inst=HOG_OPS_PER_PIXEL * float(wide.numel()))[0]},
        },
    }
    for name, batch in others.items():  # the float32 and uint16 scenes: the bytes in grow, the work does not
        n_px, size = float(batch.numel()), batch.element_size()
        label = f"{name} {TEXTURE_DTYPE_FRAMES} scenes"
        by_input["lbp_codes"][f"P8 R1.0 {label}"] = {
            "ms": time_ms(lambda: TX.lbp_codes(batch, 8, 1.0)),
            "bound_ms": bound_ms((size + 1) * n_px, f32_inst=lbp_least_ops(8, 1.0) * n_px)[0]}
        by_input["filter2d"][f"ksize 21 {label}"] = {
            "ms": time_ms(lambda: filter2d_u8(batch, taps[21], xla_order=True)),
            "bound_ms": bound_ms((size + 1) * n_px, f32_inst=21 * 21 * n_px)[0]}
        by_input["hog_cells"][label] = {
            "ms": time_ms(lambda: HG.hog_cells(batch, 9, 8)),
            "bound_ms": bound_ms(size * n_px + n_px / 64 * 9 * 4, f32_inst=HOG_OPS_PER_PIXEL * n_px)[0]}
    del scenes, others
    # one PyTorch call each, where one computes the same function: bincount
    # of the pair index (formed beforehand), conv2d in float32 (TF32 off;
    # zero padding, the frames as float beforehand)
    src, dst = one[0, :, :-1].to(torch.int64), one[0, :, 1:].to(torch.int64)
    pairs = (src * 256 + dst).reshape(-1)
    x = gray.to(torch.float32)[:, None]
    weight = taps[21][None, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library = {
            "glcm_counts": time_ms(lambda: torch.bincount(pairs, minlength=65536)),
            "filter2d": time_ms(lambda: torch.nn.functional.conv2d(x, weight, padding=10), runs=5),
            "lbp_codes": None,
            "hog_cells": None,
        }
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for k in TEXTURE_KERNELS:
        print(f"time {k}: kernel {times[k][0]:.4f} ms, plain {times[k][1]:.4f}, library {library[k]}, "
              f"bound {bounds[k][0]:.4f} ({bounds[k][1]}); by input {json.dumps(by_input[k])}")

    # the chains: device time and back to back on the 32 scenes
    x8 = torch.from_numpy(frames).to(dev)
    chains = {}
    for n in TEXTURE_CHAINS:
        fn, dyn = get_compiled_chain(steps[n], frames.shape, np.uint8, batch=TEXTURE_FRAMES, device=dev).pure_callable()
        chains[n] = {"device_ms": time_ms(lambda: fn(x8, dyn), runs=5),
                     "back_to_back_ms": back_to_back_ms(lambda: fn(x8, dyn), calls=5)}
        print(f"texture chain {n} on {frames.shape}: device {chains[n]['device_ms']:.4f} ms, back to back "
              f"{chains[n]['back_to_back_ms']:.4f} ms "
              f"({TEXTURE_FRAMES * EXTRACT_SIDE * EXTRACT_SIDE / 1e6 / (chains[n]['back_to_back_ms'] / 1e3):.1f} MPix/s)")
    del gray, x, x8
    torch.cuda.empty_cache()
    return {"launches": {k: run["launches"][k] for k in TEXTURE_KERNELS}, "err": err, "times": times,
            "bounds": bounds, "library": library, "by_input": by_input, "tables_ms": tables_ms, "chains": chains}


def fourier_steps(num_coeff: int):
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    return [PipelineStep(name="Fourier", stage=Stage.ANALYSIS, params={"num_coeff": num_coeff})]


def shape_table_digest(fourier_tables, shape_tables) -> str:
    """SHA-256 of each frame's Fourier table's exact columns and
    approximate-shape table (a copy of
    ``scripts/torch_port_digests.py:shape_table_digest``)."""

    h = hashlib.sha256()
    for fourier, shape in zip(fourier_tables, shape_tables):
        h.update(b"|")
        if len(fourier):
            for column in ("num_coeff", "area", "perimeter", "circularity"):
                dtype = np.int64 if column == "num_coeff" else np.float64
                h.update(np.ascontiguousarray(np.asarray(fourier[column]), dtype=dtype).tobytes())
        if len(shape):
            for column, dtype in (("region_index", np.int64), ("area", np.float64), ("perimeter", np.float64),
                                  ("vertices", np.int64)):
                h.update(np.ascontiguousarray(np.asarray(shape[column]), dtype=dtype).tobytes())
            h.update("\n".join(str(e) for e in np.asarray(shape["edge_lengths"])).encode())
    return h.hexdigest()


def same_shape_tables(name: str, card: dict, cpu: dict) -> float:
    """Every column of two tables of one frame equal (Fourier's spectral
    lines within FOURIER_LINE_TOL of the largest line); returns the lines'
    largest difference over that scale."""

    if list(card) != list(cpu):
        raise AssertionError(f"{name}: columns {list(card)[:6]} on the card, {list(cpu)[:6]} on the CPU")
    lines = [c for c in card if c.startswith("coeff_")]
    for c in card:
        if c not in lines and (np.asarray(card[c]).dtype != np.asarray(cpu[c]).dtype
                               or np.asarray(card[c]).tolist() != np.asarray(cpu[c]).tolist()):
            raise AssertionError(f"{name}: column {c} on the card differs from the CPU run")
    if not lines:
        return 0.0
    a = np.array([card[c][0] for c in lines])
    b = np.array([cpu[c][0] for c in lines])
    rel = float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    if rel > FOURIER_LINE_TOL:
        raise AssertionError(f"{name}: spectral lines {rel} of the largest apart")
    return rel


def fourier_kernel_vs_plain(name: str, pts: torch.Tensor, offs, k: int) -> tuple:
    """fourier_lines on the card against its plain version on the same
    contours: (largest reconstruction difference in pixels, largest line
    difference over its contour's scale); raises past the tolerances or
    where a rounded reconstruction differs."""

    from yamimageprocessor_tpu_torch.ops.fourier import fourier_lines, fourier_lines_plain

    got_c, got_o, got_r = fourier_lines(pts, offs, k)
    want_c, want_o, want_r = fourier_lines_plain(pts, offs, k)
    rel = 0.0
    for a, b in zip(want_o[:-1], want_o[1:]):
        scale = max(1.0, float(torch.linalg.vector_norm(want_c[a:b], dim=1).max()))
        rel = max(rel, float((got_c[a:b] - want_c[a:b]).abs().max()) / scale)
    recon = float((got_r - want_r).abs().max())
    if got_o != want_o or rel > FOURIER_LINE_TOL or recon > FOURIER_RECON_TOL:
        raise AssertionError(f"fourier_lines {name} k {k}: lines {rel}, reconstruction {recon}")
    if not torch.equal(torch.round(got_r), torch.round(want_r)):
        raise AssertionError(f"fourier_lines {name} k {k}: a rounded reconstruction differs")
    return recon, rel


def trace_bound(labels: torch.Tensor, cont) -> tuple:
    """(bound ms, by): the label map read and the points and areas written
    once.  Every move's successor is formed at once, so the trace has no
    inherent chain of dependent steps."""

    return bound_ms(labels.numel() * 4 + cont.points.numel() * 4 + cont.area2.numel() * 8)


def fourier_bound(offs, k: int) -> tuple:
    """(bound ms, by) of the 2k lines and the reconstruction of each
    contour: its points read, lines and reconstruction written; in FP64
    instructions the n sincospi of the twiddles and the least work the
    function needs, the lesser of the direct sums (2 x 2k x n complex
    multiply-adds) and an FFT pair (2 x (n / 2) log2 n radix-2
    butterflies), whatever route the kernel takes."""

    ns = [b - a for a, b in zip(offs[:-1], offs[1:])]
    inst = sum(min(2 * 2 * min(k, n) * n * FOURIER_F64_PER_MAC,
                   2 * (n / 2) * (math.log2(n) if n > 1 else 0.0) * FFT_F64_PER_BUTTERFLY)
               + SINCOSPI_F64 * n for n in ns)
    nbytes = sum(8 * n + 16 * n + 32 * min(k, n) for n in ns)
    return bound_ms(nbytes, f64_inst=inst)


def route_macs_taken(offs, k: int) -> int:
    """The complex multiply-adds, both ways, of the routes the kernel takes
    (``ops/fourier.py:route``, ``route_macs``): a diagnostic of the chosen
    routes beside the bound, not a bound."""

    from yamimageprocessor_tpu_torch.ops.fourier import route, route_macs

    ns = [b - a for a, b in zip(offs[:-1], offs[1:])]
    return sum(2 * route_macs(n, k)[route(n, k) == "direct"] for n in ns)


def forced_route_ms(pts: torch.Tensor, offs, k: int) -> dict:
    """Device ms of the lines with every contour forced onto each route
    (``ops/fourier.py:route`` replaced for the launch object's plan), each
    held to the plain version first: the measurement behind the route's
    cost model (``STAGE_COST``)."""

    from yamimageprocessor_tpu_torch.ops import fourier as FO

    chosen, out = FO.route, {}
    try:
        for forced in ("fft", "direct"):
            FO.route = lambda n, kk, forced=forced: forced
            fourier_kernel_vs_plain(f"every contour {forced}", pts, offs, k)
            out[forced] = time_ms(FO.LinesLaunch(pts, offs, k).run)
    finally:
        FO.route = chosen
    return out


def launch_split(fn) -> dict:
    """Each kernel's device ms a call of ``fn`` and its launches a call,
    from one ``torch.profiler`` session of :data:`SPLIT_RUNS` calls; the
    rest of the event pair (launch gaps) is ``time_ms(fn)`` less their sum."""

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(SPLIT_RUNS):
            fn()
        torch.cuda.synchronize()
    ms, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0][:60]
            ms[name] += e.device_time_total / 1e3 / SPLIT_RUNS
            count[name] += 1
    return {name: [round(ms[name], 5), count[name] / SPLIT_RUNS] for name in sorted(ms, key=ms.get, reverse=True)}


def host_split(fn, top: int = 12) -> dict:
    """The host's ms a call of ``fn`` by profiler event, its own time (a
    wait for the card inside the CUDA call that waits), the ``top``
    largest, with their count a call, from one ``torch.profiler`` session
    of :data:`SPLIT_RUNS` calls; the rest of a call's host clock is Python
    between them."""

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(SPLIT_RUNS):
            fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return {e.key[:60]: [round(e.self_cpu_time_total / 1e3 / SPLIT_RUNS, 5), e.count / SPLIT_RUNS] for e in rows}


def polygon_work(points, offs, verts, vert_offsets, owner) -> tuple:
    """(triples in float32 reach, pairs whose nearest edge needs the
    division): the (candidate, point, edge) triples whose candidate spans
    less than POLYGON_SPAN_LIMIT with the point within it of every vertex
    (coordinates within POLYGON_FILTER_LIMIT), and the (candidate, point)
    pairs whose nearest edge (the least squared distance to a segment,
    exact in integers) has its nearest point inside the edge."""

    pts, vs = (np.asarray(t.cpu() if torch.is_tensor(t) else t, np.int64) for t in (points, verts))
    offs, vo, own = (np.asarray(t) for t in (offs, vert_offsets, owner))
    near, inside = 0, 0
    for c, r in enumerate(own):
        p, v = pts[offs[r] : offs[r + 1]], vs[vo[c] : vo[c + 1]]
        lo, hi = v.min(0), v.max(0)
        reach = (np.abs(p - lo) < POLYGON_SPAN_LIMIT).all(1) & (np.abs(p - hi) < POLYGON_SPAN_LIMIT).all(1)
        if (hi - lo < POLYGON_SPAN_LIMIT).all() and np.abs(v).max() <= POLYGON_FILTER_LIMIT:
            near += int((reach & (np.abs(p).max(1) <= POLYGON_FILTER_LIMIT)).sum()) * len(v)
        p, v = p.astype(np.float64), v.astype(np.float64)
        d = np.roll(v, -1, axis=0) - v
        den = (d * d).sum(1)
        e = p[:, None, :] - v[None]
        num = (e * d[None]).sum(2)
        cross = e[..., 0] * d[None, :, 1] - e[..., 1] * d[None, :, 0]
        first, second = num <= 0, num >= den[None]
        with np.errstate(all="ignore"):
            q = np.where(first, (e * e).sum(2), np.where(second, ((e - d[None]) ** 2).sum(2), cross * cross / den[None]))
        nearest = np.argmin(q, axis=1)
        rows = np.arange(len(p))
        inside += int((~first[rows, nearest] & ~second[rows, nearest]).sum())
    return near, inside


def polygon_bound(points, offs, verts, vert_offsets, owner) -> tuple:
    """(bound ms, by): the points and vertices read once, the means
    written; POLYGON_RULE_OUT instructions a (candidate, point, edge) to
    rule it out, FP32 within the float32 pass's reach and FP64 elsewhere
    (:func:`polygon_work`), POLYGON_F64_PER_POINT FP64 a (candidate, point)
    for its nearest edge's exact distance, and POLYGON_F64_DIVISION more
    where that edge's nearest point is inside it; the pipes apart."""

    vo = np.asarray(vert_offsets)
    ns = np.diff(np.asarray(offs))[np.asarray(owner)]
    nv = np.diff(vo)
    near, inside = polygon_work(points, offs, verts, vert_offsets, owner)
    return bound_ms(8 * float(np.asarray(offs)[-1]) + 8 * float(vo[-1]) + 8 * len(nv),
                    f32_inst=POLYGON_RULE_OUT * float(near),
                    f64_inst=POLYGON_RULE_OUT * float(np.sum(ns * nv) - near) + POLYGON_F64_PER_POINT * float(np.sum(ns))
                    + POLYGON_F64_DIVISION * inside)


def phase_shape(dev) -> dict:
    """Fourier descriptors and the approximate shape: the Fourier chain
    (num_coeff 10 and 512) through the pipeline manager on the 32 BGR
    1024^2 scenes and both tables on the first 8, against the JAX package's
    digests and the port's CPU run; the three kernels against their plain
    versions (also on the blobs frame and the 4001-row disk); their times,
    bounds and PyTorch yardstick; the chain's host-clock ms at 1, 8 and 32
    frames and the tables' host ms a frame."""

    from yamimageprocessor_tpu_torch.ops import extraction as EXT
    from yamimageprocessor_tpu_torch.ops import polygon as PG
    from yamimageprocessor_tpu_torch.ops import shape as SH
    from yamimageprocessor_tpu_torch.ops.contours import TraceLaunch, trace_contours, trace_contours_plain
    from yamimageprocessor_tpu_torch.ops.extraction_device import region_count_bound, region_labels
    from yamimageprocessor_tpu_torch.ops.fourier import LinesLaunch, fourier_lines_plain
    from yamimageprocessor_tpu_torch.ops.labeling import label
    from yamimageprocessor_tpu_torch.ops.registry import get_impl
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    frames = np.stack([extraction_frame(seed=s) for s in range(TEXTURE_FRAMES)])
    check_digest("shape_input", frames)
    first = frames[:SHAPE_TABLE_FRAMES]
    managers = {k: PipelineManager(fourier_steps(k), device=dev) for k in SHAPE_COEFFS}
    fourier_data = get_impl("extraction.fourier").data_fn
    shape_data = get_impl("extraction.approximate_shape").data_fn
    run = drive(
        "shape",
        SHAPE_KERNELS + ("cc", "histogram256"),
        lambda: (
            {k: m.apply(frames) for k, m in managers.items()},
            [fourier_data(f, SHAPE_COEFFS[0]) for f in first],
            [shape_data(f, SHAPE_THRESHOLD) for f in first],
        ),
    )
    outs, ftables, stables = run["out"]
    for k in SHAPE_COEFFS:
        check_digest(f"shape_fourier{k}_output", outs[k])
    got = shape_table_digest(ftables, stables)
    if got != DIGESTS["shape_tables"]:
        raise AssertionError(f"shape_tables: {got}, the JAX package's is {DIGESTS['shape_tables']}")
    for k in SHAPE_COEFFS:
        cpu = PipelineManager(fourier_steps(k), device="cpu").apply(frames)
        exact(f"fourier chain num_coeff {k} cuda vs cpu", torch.from_numpy(outs[k]), torch.from_numpy(cpu))
    line_rel = 0.0
    for i, f in enumerate(first):
        line_rel = max(line_rel, same_shape_tables(f"fourier_data frame {i}", ftables[i],
                                                   fourier_data(f, SHAPE_COEFFS[0], device="cpu")))
        same_shape_tables(f"approximate_shape_data frame {i}", stables[i], shape_data(f, SHAPE_THRESHOLD, device="cpu"))
    tables_ms = {}
    for key, fn in (("fourier", lambda f: fourier_data(f, SHAPE_COEFFS[0])),
                    ("approximate_shape", lambda f: shape_data(f, SHAPE_THRESHOLD))):
        start = time.perf_counter()
        for f in first:
            fn(f)
        torch.cuda.synchronize()
        tables_ms[key] = (time.perf_counter() - start) * 1e3 / len(first)
    print(f"shape: the Fourier chain at num_coeff {SHAPE_COEFFS} on {frames.shape} == the JAX package's digests == "
          f"the port's CPU run; the Fourier and approximate-shape tables on {len(first)} frames == the JAX package's "
          f"digest (exact columns) == the port's CPU run (lines within {line_rel:.3g} of the largest); host-clock ms "
          f"a frame {json.dumps(tables_ms)}")

    # the kernels against their plain versions: the main path's inputs, the
    # blobs frame (65536 regions) and the 4001-row disk (one long contour)
    err = {"trace_contours": 0, "fourier_lines": 0.0, "polygon_mean_errors": 0}
    imgs = torch.from_numpy(frames).to(dev)
    labels = region_labels(imgs).contiguous()
    nseg = region_count_bound(labels)
    blobs = region_labels(torch.from_numpy(blobs_frame())[None].to(dev)).contiguous()
    disk = label(torch.from_numpy(np.ascontiguousarray(tall_disk_mask())).to(dev)).contiguous()
    traced = {}
    for name, lab in (("32 scenes", labels), (f"blobs {BLOBS_SIDE}^2", blobs), (f"tall disk {TALL_SIDE}^2", disk)):
        n = region_count_bound(lab)
        got, want = trace_contours(lab, n), trace_contours_plain(lab, n)
        for field, a, b in zip(got._fields, got, want):
            err["trace_contours"] = max(err["trace_contours"], exact(f"trace_contours {name} {field}", a, b))
        traced[name] = (lab, n, got)
        lengths = (got.offsets[1:] - got.offsets[:-1]).cpu()
        print(f"trace_contours {name}: {len(lengths)} contours, {int(lengths.sum())} points, longest "
              f"{int(lengths.max())}: bit-exact against the plain walk")
    cont = traced["32 scenes"][2]
    offsets, frames_of, area2 = cont.offsets.cpu().numpy(), cont.frames.cpu().numpy(), cont.area2.cpu().numpy()
    largest = EXT._largest(frames_of, area2, len(frames))
    main_pts, main_offs = EXT._gather(cont.points, offsets, largest[largest >= 0])
    disk_cont = traced[f"tall disk {TALL_SIDE}^2"][2]
    disk_pts, disk_offs = disk_cont.points, disk_cont.offsets.cpu().tolist()
    line_err = 0.0
    for name, pts, offs in (("32 scenes", main_pts, main_offs), ("tall disk", disk_pts, disk_offs)):
        for k in SHAPE_COEFFS:
            recon, rel = fourier_kernel_vs_plain(name, pts, offs, k)
            err["fourier_lines"] = max(err["fourier_lines"], recon)
            line_err = max(line_err, rel)
    candidates = [EXT.shape_candidates(f, device=dev)[2] for f in first]
    for i, args in enumerate(candidates):
        err["polygon_mean_errors"] = max(err["polygon_mean_errors"], exact(
            f"polygon_mean_errors frame {i}", PG.polygon_mean_errors(*args), PG.polygon_mean_errors_plain(*args)))
    disk_host = disk_pts.cpu().numpy().astype(np.int64)
    disk_pair = SH.farthest_pairs(disk_pts, disk_offs)[0]
    disk_cands = SH.candidate_polygons(disk_host, disk_pair)
    verts, vert_offsets = PG.pack_candidates(disk_cands)
    disk_args = (disk_pts, disk_offs, verts.to(dev), vert_offsets, torch.zeros(len(disk_cands), dtype=torch.int64))
    err["polygon_mean_errors"] = max(err["polygon_mean_errors"], exact(
        "polygon_mean_errors tall disk", PG.polygon_mean_errors(*disk_args), PG.polygon_mean_errors_plain(*disk_args)))
    adv = pack_polygon_cases(polygon_adversarial_cases())
    adv_args = (torch.from_numpy(adv[0]).to(dev), adv[1], torch.from_numpy(adv[2]).to(dev), adv[3], adv[4])
    err["polygon_mean_errors"] = max(err["polygon_mean_errors"], exact(
        "polygon_mean_errors adversarial", PG.polygon_mean_errors(*adv_args), PG.polygon_mean_errors_plain(*adv_args)))
    print(f"kernels: trace_contours bit-exact on the 32 scenes, the blobs and the tall disk; fourier_lines within "
          f"{err['fourier_lines']:.3g} pixels and {line_err:.3g} of the largest line at num_coeff {SHAPE_COEFFS} on "
          f"the 32 scenes' largest contours and the tall disk ({disk_offs[-1]} points); polygon_mean_errors "
          f"bit-exact on {len(first)} frames' candidates, the tall disk's {len(disk_cands)} and "
          f"{len(adv[4])} adversarial polygons (ties, repeated vertices, 1 and 2 vertices, 2^24 and past it)")

    # times at the main paths' shapes: the trace and the lines on the 32-frame
    # chain, the errors on one frame's candidates (a launch a table); each the
    # wrapper's own launch object, its buffers allocated once
    k0 = SHAPE_COEFFS[0]
    args0 = candidates[0]
    times = {
        "trace_contours": paired_ms(TraceLaunch(labels, nseg).run, lambda: trace_contours_plain(labels, nseg),
                                    plain_runs=3),
        "fourier_lines": paired_ms(LinesLaunch(main_pts, main_offs, k0).run,
                                   lambda: fourier_lines_plain(main_pts, main_offs, k0), plain_runs=3),
        "polygon_mean_errors": paired_ms(PG.ErrorsLaunch(*args0).run, lambda: PG.polygon_mean_errors_plain(*args0),
                                         plain_runs=3),
    }
    bounds = {
        "trace_contours": trace_bound(labels, cont),
        "fourier_lines": fourier_bound(main_offs, k0),
        "polygon_mean_errors": polygon_bound(*args0),
    }
    by_input = {"trace_contours": {}, "fourier_lines": {}, "polygon_mean_errors": {}}
    for name, (lab, n, c) in traced.items():
        launch = TraceLaunch(lab, n)
        ms = times["trace_contours"][0] if name == "32 scenes" else time_ms(launch.run)
        launch.run()
        by_input["trace_contours"][name] = {"ms": ms, "bound_ms": trace_bound(lab, c)[0],
                                            "bound_by": trace_bound(lab, c)[1], **launch.stats(),
                                            "split": launch_split(launch.run)}
    for name, pts, offs, k in (("32 scenes, num_coeff 10", main_pts, main_offs, k0),
                               ("32 scenes, num_coeff 512", main_pts, main_offs, 512),
                               ("tall disk, num_coeff 10", disk_pts, disk_offs, 10),
                               ("tall disk, num_coeff 512", disk_pts, disk_offs, 512)):
        launch = LinesLaunch(pts, offs, k)
        by_input["fourier_lines"][name] = {
            "ms": times["fourier_lines"][0] if k == k0 and pts is main_pts else time_ms(launch.run),
            "bound_ms": fourier_bound(offs, k)[0], "bound_by": fourier_bound(offs, k)[1], "routes": launch.counts(),
            "route_macs": route_macs_taken(offs, k), "split": launch_split(launch.run)}
        if pts is main_pts:
            by_input["fourier_lines"][name]["forced_route_ms"] = forced_route_ms(pts, offs, k)
    by_input["polygon_mean_errors"]["frame 0"] = {
        "ms": times["polygon_mean_errors"][0], "bound_ms": bounds["polygon_mean_errors"][0],
        "bound_by": bounds["polygon_mean_errors"][1], "routes": PG.ErrorsLaunch(*args0).counts(),
        "split": launch_split(PG.ErrorsLaunch(*args0).run)}
    disk_bound = polygon_bound(*disk_args)
    by_input["polygon_mean_errors"]["tall disk"] = {
        "ms": time_ms(PG.ErrorsLaunch(*disk_args).run), "bound_ms": disk_bound[0], "bound_by": disk_bound[1],
        "routes": PG.ErrorsLaunch(*disk_args).counts(), "split": launch_split(PG.ErrorsLaunch(*disk_args).run)}
    # the PyTorch yardstick: cuFFT's fft, the kept lines selected, its ifft. A
    # ragged batch of contours has no single library call, so the main path's
    # figure is 3 calls a contour, mostly launches; beside it one contour of
    # the disk's 11312 points at num_coeff 512, a transform pair's own time
    def spectra(pts, offs, k):
        out = []
        for a, b in zip(offs[:-1], offs[1:]):
            z = pts[a:b].to(torch.float64)
            n, kk = b - a, min(k, b - a)
            mask = torch.zeros(n, dtype=torch.complex128, device=dev)
            mask[:kk] = 1
            mask[n - kk:] = 1
            out.append((torch.complex(z[:, 0], z[:, 1]), mask))
        return out

    def library_fourier(pairs):
        return lambda: [torch.fft.ifft(torch.fft.fft(z) * mask) for z, mask in pairs]

    library = {"trace_contours": None, "fourier_lines": time_ms(library_fourier(spectra(main_pts, main_offs, k0))),
               "polygon_mean_errors": None}
    for name, pts, offs, k in (("32 scenes, num_coeff 512", main_pts, main_offs, 512),
                               ("tall disk, num_coeff 10", disk_pts, disk_offs, 10),
                               ("tall disk, num_coeff 512", disk_pts, disk_offs, 512)):
        by_input["fourier_lines"][name]["library_ms"] = time_ms(library_fourier(spectra(pts, offs, k)))
    for k in SHAPE_KERNELS:
        print(f"time {k}: kernel {times[k][0]:.4f} ms, plain {times[k][1]:.4f}, library {library[k]}, "
              f"bound {bounds[k][0]:.4f} ({bounds[k][1]})")
        for name, row in by_input[k].items():
            print(f"  {k} {name}: {json.dumps(row)}")

    # the Fourier chain on the host clock (labels, trace, the largest contours'
    # lines, the paint, the reads back), and its device time by kernel
    chains = {}
    for n in SHAPE_BATCHES:
        for k in SHAPE_COEFFS:
            if n != SHAPE_BATCHES[-1] and k != k0:
                continue
            batch = frames[:n]
            ms = wall_ms(lambda: managers[k].apply(batch), calls=3)
            chains[f"{n} frames, num_coeff {k}"] = {"host_ms": ms, "ms_a_frame": ms / n,
                                                    "mpix_s": n * EXTRACT_SIDE**2 / 1e6 / (ms / 1e3)}
    profile = chain_profile(lambda: managers[k0].apply(frames), {
        "contour_": "trace_contours", "fourier_": "fourier_lines", "cc_": "cc", "histogram256": "histogram256"})
    print_profile("fourier chain (32 frames)", profile)
    print(f"fourier chain host clock: {json.dumps(chains)}")
    del imgs, labels, blobs, disk
    torch.cuda.empty_cache()
    return {"launches": {k: run["launches"][k] for k in SHAPE_KERNELS}, "err": err, "times": times,
            "bounds": bounds, "library": library, "by_input": by_input, "tables_ms": tables_ms, "chains": chains,
            "profile": profile, "line_err": line_err}


def blobs_peak_memory(blobs: np.ndarray) -> dict:
    """Peak device memory of ``region_tables([blobs])`` (the memo
    cleared): bytes allocated at the peak, and above what was allocated
    before the call; printed."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD

    XD.clear_table_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    XD.region_tables([blobs])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    XD.clear_table_cache()
    print(f"peak device memory of region_tables([blobs {BLOBS_SIDE}^2]): {peak} bytes, {peak - before} above "
          f"the {before} allocated before")
    return {"peak_bytes": peak, "above_bytes": peak - before}


def extraction_label_sets(dev, frame, batches, wide, blobs) -> dict:
    """name -> (labels, imgs) of every extraction case: the bench's scene,
    its batches, the 4096^2 scene and the blobs (labels from the Otsu
    path), the tall disk and the convex chains (labels of the masks; imgs
    the masks as BGR frames)."""

    from yamimageprocessor_tpu_torch.ops import extraction_device as XD
    from yamimageprocessor_tpu_torch.ops.labeling import label

    sets = {}
    for name, frames in ((f"scene {EXTRACT_SIDE}^2", [frame]), *((f"batch {n}", b) for n, b in batches.items()),
                         (f"scene {EXTRACT_WIDE_SIDE}^2", [wide]), (f"blobs {BLOBS_SIDE}^2", [blobs])):
        imgs = torch.from_numpy(np.stack(frames)).to(dev)
        sets[name] = (XD.region_labels(imgs), imgs)
    chains, vertices = convex_chain_masks()
    print(f"hull: the convex chains have {vertices} vertices")
    for name, masks in ((f"tall disk {TALL_SIDE}^2", tall_disk_mask()), (f"convex chains {CHAIN_SIDE}^2", chains)):
        m = torch.from_numpy(np.ascontiguousarray(masks)).to(dev)
        sets[name] = (label(m), (m.to(torch.uint8) * 220)[..., None].expand(*m.shape, 3).contiguous())
    return sets


_EXTRACTION_GROUPS = {
    "histogram256": "histogram256",
    "cc_": "cc",
    "region_scan": "region_scan",
    "hull_areas": "hull_areas",
}


# ---------------------------------------------------------------------------
# streaming (BASELINE config 5: bench.py:_extra_gigapixel's slide and tiles)

STREAM_SIDE = 16384  # the flagship slide: 64 tiles of 2048^2, windows of 2052^2 (the fused route)
STREAM_CLAHE_SIDE = 16380  # not a multiple of the tile (the generic route) nor of the grid (4 padded rows and columns)
STREAM_TILE = (2048, 2048)
STREAM_SEG_SIDE = 4096  # the segmentation chain through the dense branch
STREAM_DIGEST_SIDE = 2048
STREAM_DIGEST_TILES = {"512": (512, 512), "500x300": (500, 300)}  # (width, height): exact and non-exact grids
STREAM_BATCHED_BUDGET = 128 << 20  # a source-cache budget below the slide's 269 MB of windows: the batched route
TRANSFER_BYTES = 256 << 20
STREAM_KERNELS = ("stream_grid_histogram", "clahe_stream_blend")


def stream_digest_frames() -> dict:
    """The streaming digests' frames (``scripts/torch_port_digests.py``
    makes the same): gray and BGR uint8, and gray float32 (uint8's range
    and a little beyond, with fractions) and uint16 (levels to 299), which
    only the CLAHE chain streams."""

    side = STREAM_DIGEST_SIDE
    return {
        "gray": np.random.default_rng(21).integers(0, 256, (side, side), dtype=np.uint8),
        "bgr": np.random.default_rng(22).integers(0, 256, (side, side, 3), dtype=np.uint8),
        "float32": (np.random.default_rng(23).random((side, side), dtype=np.float32) * 270 - 5).astype(np.float32),
        "uint16": np.random.default_rng(24).integers(0, 300, (side, side), dtype=np.uint16),
    }


def stream_clahe_steps():
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    return [
        PipelineStep(name="clahe", op_id="preprocessing.clahe", stage=Stage.PREPROCESSING,
                     params={"clip_limit": 40.0, "grid_size": 8}),
        PipelineStep(name="IntensityNormalization", stage=Stage.PREPROCESSING, params={}),
    ]


def write_slide(directory: str, name: str, array: np.ndarray, tile=None):
    """``array`` saved as ``.npy`` and opened as a memmap-backed record."""

    from yamimageprocessor_tpu_torch.io.tiled_image import TiledImageRecord
    from yamimageprocessor_tpu_torch.pipeline.tiled_records import TiledPipelineImage

    path = Path(directory) / f"{name}.npy"
    np.save(path, array)
    record = TiledImageRecord.from_npy(path, metadata={}, memmap=np.load(path, mmap_mode="r"))
    return TiledPipelineImage(record, tile_size=tile or STREAM_TILE)


def host_s(fn):
    """(result, host seconds) of ``fn()``, the card idle before and after."""

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def transfer_rates(dev) -> dict:
    """H2D and D2H GB/s of a 256 MiB buffer, pinned through the port's
    transfer layer (a staging buffer, the copy stream) and pageable (a
    torch copy from or to a numpy array already touched), median of 5."""

    from yamimageprocessor_tpu_torch.parallel import transfer as TR

    n = TRANSFER_BYTES
    host = np.random.default_rng(0).integers(0, 256, n, dtype=np.uint8)
    stage = TR.staging((n,), np.uint8, dev)
    np.copyto(stage.array, host)
    dst = TR.upload(stage, dev)
    pageable = np.empty(n, np.uint8)
    pageable[:] = 1

    def pinned_h2d():
        TR.finish_upload(TR.start_upload(TR.staging((n,), np.uint8, dev), dev, out=dst))

    cases = {
        "h2d_pinned": pinned_h2d,
        "h2d_pageable": lambda: dst.copy_(torch.from_numpy(host)),
        "d2h_pinned": lambda: TR.fetch(dst),
        "d2h_pageable": lambda: torch.from_numpy(pageable).copy_(dst),
    }
    rates = {}
    for name, fn in cases.items():
        host_s(fn)
        times = [host_s(fn)[1] for _ in range(5)]
        rates[name] = n / statistics.median(times) / 1e9
    if not np.array_equal(TR.fetch(dst), host):
        raise AssertionError("transfer: the round trip changed the buffer")
    return rates


def sweep_breakdown(image, dev) -> dict:
    """Where a flagship sweep's time goes, each part on its own (host ms):
    reading the 64 windows from the memmap into a pinned buffer of 8, their
    upload, the chain's kernels on the cached windows (a device-sink sweep,
    device time by an event pair), the read-back of the 64 tiles, and the
    host copy of the tiles into the assembled frame."""

    from yamimageprocessor_tpu_torch.parallel import tiling as TL
    from yamimageprocessor_tpu_torch.parallel import transfer as TR
    from yamimageprocessor_tpu_torch.models.stages import preprocess_steps

    side, (tw, th) = STREAM_SIDE, STREAM_TILE
    halo = 2
    windows = []
    for left, top, right, bottom in TL.iter_tile_boxes(side, side, (tw, th)):
        wtop = min(max(top - halo, 0), side - th - 2 * halo)
        wleft = min(max(left - halo, 0), side - tw - 2 * halo)
        windows.append((wleft, wtop, wleft + tw + 2 * halo, wtop + th + 2 * halo))
    batch = 8
    pinned = torch.empty((batch, th + 2 * halo, tw + 2 * halo), dtype=torch.uint8, pin_memory=True)
    buf = pinned.numpy()
    start = time.perf_counter()
    for i, w in enumerate(windows):
        TL._read_into(image, w, buf[i % batch])
    reads = time.perf_counter() - start
    dev_windows = torch.empty((len(windows),) + tuple(pinned.shape[1:]), dtype=torch.uint8, device=dev)

    def upload_all():
        for i in range(0, len(windows), batch):
            dev_windows[i : i + batch].copy_(pinned, non_blocking=True)

    _, h2d = host_s(upload_all)
    kept = []
    steps = preprocess_steps()
    TL.stream_steps_tiled(steps, image, None, device_sink=lambda b, t: kept.append(t), device=dev)  # warm
    kept.clear()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    begin.record()
    TL.stream_steps_tiled(steps, image, None, device_sink=lambda b, t: kept.append(t), device=dev)
    end.record()
    end.synchronize()
    kernels_ms = begin.elapsed_time(end)
    tiles = [t for part in kept for t in part]

    def fetch_all():
        return [TR.fetch(torch.stack(tiles[i : i + batch])) for i in range(0, len(tiles), batch)]

    fetched, d2h = host_s(fetch_all)
    frame = np.empty((side, side), np.uint8)
    start = time.perf_counter()
    k = 0
    for part in fetched:
        for tile in part:
            top, left = (k // (side // tw)) * th, (k % (side // tw)) * tw
            frame[top : top + th, left : left + tw] = tile
            k += 1
    assembly = time.perf_counter() - start
    return {
        "host_reads_ms": reads * 1e3,
        "h2d_ms": h2d * 1e3,
        "kernels_device_ms": kernels_ms,
        "d2h_ms": d2h * 1e3,
        "assembly_ms": assembly * 1e3,
    }


def stream_blend_least_ops() -> int:
    """Least float32 instructions of a pixel of the stream blend in the
    reference's order, whatever the design: the four weights (separate
    products of a row's and a column's factor, which differ between a
    pixel's two level forms, so none is shared), the product w01 * t01 and
    three FMAs, and the rounding add: 9.  No clip: the sum lies in [0,
    255.5) (``tests/test_torch_stream_schedule.py``:
    ``test_blend_sums_need_no_clip``).  The table read, the level and the
    corners' conversion to floats are the design's and are not counted."""

    return 4 + 1 + 3 + 1


def stream_kernel_checks(image, dev, frame_shape) -> dict:
    """The two stream kernels against their plain versions, bit for bit, on
    the CLAHE slide's windows as the generic route batches them: 7 tiles of
    a middle row, the last row's 7 (the mirror rows), the corner tile (the
    mirror rows and columns); and on the middle row's geometry as float32
    and uint16 tiles (:func:`stream_tile_cases`: values outside 0..255
    included); the tables from the slide's merged histograms.  Then each
    kernel's and plain version's device time on the middle row, and on its
    float32 and uint16 instances, with their bounds."""

    from yamimageprocessor_tpu_torch.ops import clahe as CL
    from yamimageprocessor_tpu_torch.parallel import tiling as TL

    h, w = frame_shape
    grid = (8, 8)
    boxes = list(TL.iter_tile_boxes(w, h, STREAM_TILE))
    per_row = -(-w // STREAM_TILE[0])

    def tiles_of(sel):
        regions = np.stack([image.read_region(boxes[k]) for k in sel])
        return torch.from_numpy(regions).to(dev), [(boxes[k][1], boxes[k][0]) for k in sel]

    hist = torch.zeros((8, 8, 256), dtype=torch.int32, device=dev)
    for row in range(-(-h // STREAM_TILE[1])):
        for sel in (range(row * per_row, row * per_row + per_row - 1), [row * per_row + per_row - 1]):
            t, o = tiles_of(sel)
            hist += CL.grid_hist_stream(t, o, frame_shape, grid)
    luts = CL.clahe_stream_luts(hist, 40.0, frame_shape, grid)
    last = len(boxes) - 1
    cases = {name: tiles_of(sel) for name, sel in (
        ("middle row", range(3 * per_row, 3 * per_row + per_row - 1)),
        ("last row", range(last - per_row + 1, last)),
        ("corner", [last]),
    )}
    made = stream_tile_cases(dev)
    cases.update({name: made[name] for name in ("middle row float32", "middle row uint16")})
    err = {}
    for name, (t, o) in cases.items():
        err[f"hist {name}"] = exact(f"grid_hist_stream {name}", CL.grid_hist_stream(t, o, frame_shape, grid),
                                    CL.grid_hist_stream_plain(t, o, frame_shape, grid))
        err[f"blend {name}"] = exact(f"clahe_stream_blend {name}", CL.clahe_stream_blend(t, luts, o, frame_shape, grid),
                                     CL.clahe_stream_blend_plain(t, luts, o, frame_shape, grid))
    times, bounds = {}, {}
    for name in ("middle row", "middle row float32", "middle row uint16"):
        t, o = cases[name]
        key = "" if name == "middle row" else f" {name.split()[-1]}"
        px = t.numel()
        times[f"stream_grid_histogram{key}"] = paired_ms(lambda: CL.grid_hist_stream(t, o, frame_shape, grid),
                                                         lambda: CL.grid_hist_stream_plain(t, o, frame_shape, grid),
                                                         plain_runs=3)
        times[f"clahe_stream_blend{key}"] = paired_ms(lambda: CL.clahe_stream_blend(t, luts, o, frame_shape, grid),
                                                      lambda: CL.clahe_stream_blend_plain(t, luts, o, frame_shape,
                                                                                          grid),
                                                      runs=RUNS, plain_runs=3)
        bounds[f"stream_grid_histogram{key}"] = bound_ms(px * t.element_size() + 8 * 8 * 256 * 4)
        bounds[f"clahe_stream_blend{key}"] = bound_ms(px * (t.element_size() + 1) + 8 * 8 * 256,
                                                      f32_inst=stream_blend_least_ops() * px)
    return {"err": err, "times": times, "bounds": bounds, "batch": tuple(cases["middle row"][0].shape)}


def phase_stream(dev) -> dict:
    """The streaming runtime on .npy slides opened as memmap records: the
    flagship chain on a 16384^2 slide (cold, warm and device-sink sweeps,
    the batched route, against the port's dense chain), the CLAHE chain on
    16380^2 (its stream kernels against their plain versions), the JAX
    package's streamed digests at 2048^2, the segmentation chain through the
    dense branch at 4096^2, and the transfer rates."""

    from yamimageprocessor_tpu_torch.models.stages import flagship_forward, preprocess_steps, segmentation_forward
    from yamimageprocessor_tpu_torch.models.stages import segmentation_steps
    from yamimageprocessor_tpu_torch.parallel import tiling as TL
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    begin = time.perf_counter()
    px = float(STREAM_SIDE) ** 2
    result = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="yam_stream_") as tmp:
        rng = np.random.default_rng(5)
        slide = rng.integers(0, 256, (STREAM_SIDE, STREAM_SIDE), dtype=np.uint8)
        flag_src = write_slide(tmp, "flagship", slide)
        manager = PipelineManager(preprocess_steps(), device=dev)
        TL.clear_source_stack_cache()
        run, first_s = host_s(lambda: drive("stream flagship", ("sepconv", "histogram256", "lut_apply"),
                                            lambda: manager.apply(flag_src)))
        result["launches"].update(run["launches"])
        streamed = run["out"]
        dense = flagship_forward(torch.from_numpy(slide).to(dev)[None])[0].cpu()
        exact("stream flagship == the port's dense chain", torch.from_numpy(streamed), dense)
        TL.clear_source_stack_cache()
        cold, cold_s = host_s(lambda: manager.apply(flag_src))
        warm, warm_s = host_s(lambda: manager.apply(flag_src))
        exact("stream flagship cold", torch.from_numpy(cold), dense)
        exact("stream flagship warm", torch.from_numpy(warm), dense)
        del cold, warm
        kept = []
        _, sink_s = host_s(lambda: TL.stream_steps_tiled(preprocess_steps(), flag_src, None, device=dev,
                                                         device_sink=lambda b, t: kept.append((b, t))))
        frame = torch.empty((STREAM_SIDE, STREAM_SIDE), dtype=torch.uint8, device=dev)
        for boxes, batch in kept:
            for (left, top, right, bottom), tile in zip(boxes, batch):
                frame[top:bottom, left:right] = tile
        exact("stream flagship device sink", frame.cpu(), dense)
        del kept, frame
        budget = TL._SOURCE_STACK_CACHE.budget
        TL._SOURCE_STACK_CACHE.budget = STREAM_BATCHED_BUDGET
        TL.clear_source_stack_cache()
        try:
            batched, batched_s = host_s(lambda: manager.apply(flag_src))
        finally:
            TL._SOURCE_STACK_CACHE.budget = budget
        exact("stream flagship batched route", torch.from_numpy(batched), dense)
        del batched
        TL.clear_source_stack_cache()
        result["breakdown"] = sweep_breakdown(flag_src, dev)
        TL.clear_source_stack_cache()
        result["gpix_s"] = {
            "first": px / first_s / 1e9,
            "cold": px / cold_s / 1e9,
            "warm": px / warm_s / 1e9,
            "device_sink": px / sink_s / 1e9,
            "batched": px / batched_s / 1e9,
        }
        print(f"stream flagship {STREAM_SIDE}^2 in {STREAM_TILE} tiles == the port's dense chain (first sweep, "
              f"cold, warm, device sink, batched route); GPix/s {json.dumps(result['gpix_s'])}")
        print(f"stream flagship sweep parts (ms): {json.dumps(result['breakdown'])}")
        del slide, streamed, dense

        side = STREAM_CLAHE_SIDE
        clahe_slide = rng.integers(0, 256, (side, side), dtype=np.uint8)
        clahe_src = write_slide(tmp, "clahe", clahe_slide)
        clahe_manager = PipelineManager(stream_clahe_steps(), device=dev)
        run, clahe_s = host_s(lambda: drive("stream clahe", ("stream_grid_histogram", "clahe_stream_blend", "lut_apply"),
                                            lambda: clahe_manager.apply(clahe_src)))
        result["launches"].update(run["launches"])
        out = run["out"]
        if out.shape != (side, side) or out.dtype != np.uint8 or int(out.max()) != 255 or int(out.min()) != 0:
            raise AssertionError(f"stream clahe: {out.shape} {out.dtype} in [{out.min()}, {out.max()}]")
        result["gpix_s"]["clahe"] = float(side) ** 2 / clahe_s / 1e9
        checks = stream_kernel_checks(clahe_src, dev, (side, side))
        result.update(err=checks["err"], times=checks["times"], bounds=checks["bounds"])
        print(f"stream clahe {side}^2: {result['gpix_s']['clahe']:.3f} GPix/s; stream kernels == plain on "
              f"{list(checks['err'])}; timed on {checks['batch']}")
        del clahe_slide, out

        frames = stream_digest_frames()
        chains = {"flagship": preprocess_steps, "clahe": stream_clahe_steps}
        for kind, array in frames.items():
            check_digest(f"stream_{kind}_input", array)
            for tiles, tile in STREAM_DIGEST_TILES.items():
                src = write_slide(tmp, f"digest_{kind}_{tiles}", array, tile)
                for chain, make_steps in chains.items():
                    if kind in ("gray", "bgr") or chain == "clahe":
                        check_digest(f"stream_{chain}_{kind}_{tiles}",
                                     PipelineManager(make_steps(), device=dev).apply(src))
        print(f"stream digests: flagship and clahe chains, gray and BGR {STREAM_DIGEST_SIDE}^2, the clahe chain "
              f"on gray float32 and uint16, tiles {list(STREAM_DIGEST_TILES)} == the JAX package's streamed output")

        scene = dense_scene(STREAM_SEG_SIDE, seed=3)
        seg_src = write_slide(tmp, "segmentation", scene)
        seg_out, seg_s = host_s(lambda: PipelineManager(segmentation_steps(), device=dev).apply(seg_src))
        seg_dense = segmentation_forward(torch.from_numpy(scene).to(dev)[None])[0].cpu()
        exact("stream segmentation (dense branch) == the port's dense chain", torch.from_numpy(seg_out), seg_dense)
        print(f"stream segmentation {STREAM_SEG_SIDE}^2 through the dense branch == the port's dense chain "
              f"({seg_s * 1e3:.1f} ms)")
    result["transfer_gb_s"] = transfer_rates(dev)
    print(f"transfer 256 MiB GB/s: {json.dumps(result['transfer_gb_s'])}")
    print(f"stream phase: {time.perf_counter() - begin:.1f} s")
    return result


def main() -> None:
    if sys.argv[1:2] == ["--times-one"]:
        times_one(sys.argv[2], sys.argv[3])
        return
    if sys.argv[1:2] and sys.argv[1] in TIMES_FLAGS:
        times_in_turns(TIMES_FLAGS[sys.argv[1]], sys.argv[2:])
        return
    if sys.argv[1:2] == ["--edges"]:
        phase_device()
        phase_build()
        edg = phase_edges(torch.device("cuda", 0))
        print(json.dumps({k: edg[k] for k in ("launches", "err", "times", "bounds", "library")}))
        return
    if sys.argv[1:2] == ["--streaming"]:
        phase_device()
        phase_build()
        stm = phase_stream(torch.device("cuda", 0))
        print(json.dumps({k: stm[k] for k in ("launches", "err", "times", "bounds")}))
        return
    begin = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kern = phase_kernels(dev)
    filt = phase_filter_kernels(dev)
    print(f"elapsed after the kernel phases: {time.perf_counter() - begin:.1f} s")
    launches = {}
    for phase in (phase_flagship, phase_segmentation, phase_clahe, phase_denoise, phase_bilateral):
        for name, count in phase(dev).items():
            launches[name] = launches.get(name, 0) + count
        print(f"elapsed after {phase.__name__}: {time.perf_counter() - begin:.1f} s")
    edg = phase_edges(dev)
    for name, count in edg["launches"].items():
        launches[name] = launches.get(name, 0) + count
    print(f"elapsed after phase_edges: {time.perf_counter() - begin:.1f} s")
    ext = phase_extraction(dev)
    print(f"elapsed after phase_extraction: {time.perf_counter() - begin:.1f} s")
    for name, count in ext["launches"].items():
        launches[name] = launches.get(name, 0) + count
    tex = phase_texture(dev)
    launches.update(tex["launches"])
    print(f"elapsed after phase_texture: {time.perf_counter() - begin:.1f} s")
    shp = phase_shape(dev)
    launches.update(shp["launches"])
    print(f"elapsed after phase_shape: {time.perf_counter() - begin:.1f} s")
    stm = phase_stream(dev)
    for name, count in stm["launches"].items():
        launches[name] = launches.get(name, 0) + count
    print(f"elapsed after phase_stream: {time.perf_counter() - begin:.1f} s")
    loaded = sorted(
        k for k in sys.modules
        if k == "jax" or k.startswith("jax.") or k == "yamimageprocessor_tpu" or k.startswith("yamimageprocessor_tpu.")
    )
    if loaded:
        raise AssertionError(f"the port loaded jax or the JAX package: {loaded[:10]}")

    rows = [
        ("sepconv", "yamimageprocessor_tpu_torch/csrc/sepconv.cu", "yamimageprocessor_tpu/ops/sepconv_pallas.py:118",
         "no single call: conv2d takes float input and needs a separate pad and a rounding cast"),
        ("histogram256", "yamimageprocessor_tpu_torch/csrc/lut_hist.cu", "yamimageprocessor_tpu/pallas_kernels.py:585",
         f"torch.bincount on one {HIST_ONE} frame (the Otsu shape); ms: the flagship batch after the Gaussian; "
         "by_input: every main-path input"),
        ("lut_apply", "yamimageprocessor_tpu_torch/csrc/lut_hist.cu", "yamimageprocessor_tpu/pallas_kernels.py:161",
         "no single call: every PyTorch table read needs an int64 copy of the uint8 frames first"),
        ("distance", "yamimageprocessor_tpu_torch/csrc/distance.cu", "yamimageprocessor_tpu/ops/distance_pallas.py:219",
         "none: PyTorch has no distance transform"),
        ("cc", "yamimageprocessor_tpu_torch/csrc/labeling.cu", "yamimageprocessor_tpu/ops/labeling_pallas.py:214",
         "none: PyTorch has no connected-components labeling; a call is 3 CUDA launches (cc_local, cc_border, "
         "cc_compress); case_ms: the other masks"),
        ("flood", "yamimageprocessor_tpu_torch/csrc/watershed.cu", "yamimageprocessor_tpu/ops/watershed_pallas.py:233",
         "none: PyTorch has no watershed"),
        ("tile_histogram", "yamimageprocessor_tpu_torch/csrc/clahe.cu", "yamimageprocessor_tpu/pallas_kernels.py:457",
         "none: no single PyTorch call counts the levels of every tile (bincount needs tile offsets added first)"),
        ("clahe_blend", "yamimageprocessor_tpu_torch/csrc/clahe.cu", "yamimageprocessor_tpu/ops/clahe_pallas.py:137",
         "none: no single PyTorch call blends four table lookups a pixel; shared_bytes: the tables a block "
         "stages on the bench's planes"),
        ("median", "yamimageprocessor_tpu_torch/csrc/median.cu",
         "yamimageprocessor_tpu/ops/filters.py:268 median_j (XLA, not a pallas_call)",
         "unfold(1,5,1).unfold(2,5,1).reshape(...,25).median(-1) on the gray batch padded beforehand; ms: ksize 5 "
         "on the denoise path's (8,2048,2048) gray frames"),
        ("bilateral", "yamimageprocessor_tpu_torch/csrc/bilateral.cu",
         "yamimageprocessor_tpu/ops/filters.py:390 bilateral_j (XLA, not a pallas_call)",
         "none: PyTorch has no bilateral filter; ms: ksize 5 on the (8,2048,2048,3) BGR batch"),
        ("region_scan", "yamimageprocessor_tpu_torch/csrc/extraction.cu",
         "yamimageprocessor_tpu/ops/regionprops.py:196 row_extremes_j, :369 _moment_sums_matmul and :500 "
         "_perimeter_weights_j (XLA, not a pallas_call)",
         "two scatter_reduce_ calls (amin, amax) on the precomputed index, then index_add_ of the precomputed "
         f"(pixels, 9) values, in one event pair; ms: the {ext['main_case']} labels (one cooperative launch: "
         "fill, pass, centring); by_input: the five label sets"),
        ("hull_areas", "yamimageprocessor_tpu_torch/csrc/extraction.cu",
         "yamimageprocessor_tpu/ops/regionprops.py:574 hull_pixel_areas_j (XLA, not a pallas_call)",
         f"none: PyTorch has no convex hull; ms: the {ext['main_case']} labels; by_input: every label set, "
         "with its tallest region's rows"),
        ("annotate", "yamimageprocessor_tpu_torch/csrc/extraction.cu",
         "yamimageprocessor_tpu/ops/extraction_device.py:90 region_annotate_j (XLA, not a pallas_call)",
         f"none: no PyTorch call paints outlines and disks; ms: the {ext['main_case']} BGR frames "
         "(3 CUDA launches: the copy with the keys zeroed where painted, the paint, the colours); by_input: "
         "every label set"),
    ]
    rows += [
        ("glcm_counts", "yamimageprocessor_tpu_torch/csrc/texture.cu",
         "yamimageprocessor_tpu/ops/texture.py:143 glcm_j's scatter-add (XLA, not a pallas_call)",
         "torch.bincount of the (src * 256 + dst) pair index of one 1024^2 frame, formed beforehand; ms: one "
         "frame at (dx, dy) = (1, 0) (haralick_data's default); by_input: a flat frame, distance 64, 8 scenes"),
        ("lbp_codes", "yamimageprocessor_tpu_torch/csrc/texture.cu",
         "yamimageprocessor_tpu/ops/texture.py:70 lbp_j and :40 lbp_np (XLA and numpy, not a pallas_call)",
         "none: PyTorch has no LBP; ms: P 8, R 1 in the chain's float32 arithmetic on the 32 scenes; by_input: "
         "the other (P, R) and the float64 data-path arithmetic"),
        ("filter2d", "yamimageprocessor_tpu_torch/csrc/filter2d.cu",
         "yamimageprocessor_tpu/ops/filters.py:179 filter2d_j and :55 filter2d_np (XLA and numpy, not a pallas_call)",
         "torch.nn.functional.conv2d in float32 with TF32 off on the scenes as float32 (zero padding, not "
         "bit-exact: the yardstick only); ms: ksize 21 (Gabor's default) in XLA's order on the 32 scenes"),
        ("hog_cells", "yamimageprocessor_tpu_torch/csrc/hog.cu",
         "yamimageprocessor_tpu/ops/hogf.py:89-110 hog_features_j's cell histograms (XLA, not a pallas_call)",
         "none: PyTorch has no HOG; ms: 9 bins, 8x8 cells on the 32 scenes; by_input: 32 bins 2x2, a 2048^2 frame"),
    ]
    rows += [
        ("trace_contours", "yamimageprocessor_tpu_torch/csrc/contour.cu",
         "yamimageprocessor_tpu/ops/shape.py:107 trace_external_contours (host numpy and Python, not a pallas_call)",
         "none: PyTorch has no contour tracing; ms: the 32 scenes' labels (7 CUDA launches: the starts' fill, "
         "the seeds with the packed mask, the states, the moves, the links, the cooperative ranking, the points; "
         "and two torch.cumsum scans); by_input: every input with its states, entries, rounds, the ranking's "
         "phase times and the per-launch split"),
        ("fourier_lines", "yamimageprocessor_tpu_torch/csrc/shape.cu",
         "yamimageprocessor_tpu/ops/extraction_device.py:254 fourier_dft_j (XLA, not a pallas_call); CPU golden "
         "ops/shape.py:278 fourier_reconstruct",
         "torch.fft.fft, the kept lines selected, torch.fft.ifft (cuFFT) of each of the 32 scenes' largest "
         "contours in one event pair: a ragged batch has no single library call, so 96 calls, mostly launches "
         "(by_input's disk: one contour's pair); ms: num_coeff 10 on those contours (one launch: a block a "
         "contour); bound: the lesser of the direct sums and an FFT pair's n log2 n; by_input: the routes, "
         "their multiply-adds (route_macs), the per-launch split and, on the 32 contours, each route forced; max_abs_err: the reconstruction's pixels (lines: max_rel_line_err of the "
         "largest line)"),
        ("polygon_mean_errors", "yamimageprocessor_tpu_torch/csrc/shape.cu",
         "yamimageprocessor_tpu/ops/extraction_device.py:339 polygon_mean_errors_j (XLA, not a pallas_call); CPU "
         "golden ops/shape.py:218 point_polygon_distance averaged by np.mean",
         "none: no PyTorch call gives the distance to a polygon's edges; ms: frame 0's 64 contours x 20 "
         "candidates (one launch a table: the block route); bound: a numerator and a compare a (candidate, point, "
         "edge), FP32 within the float32 pass's reach and FP64 elsewhere, one exact FP64 distance a (candidate, "
         "point), the pipes apart; by_input: its plan and measured launches (split), the 4001-row disk's 20 (the "
         "cluster route)"),
    ]
    rows += [
        ("stream_grid_histogram", "yamimageprocessor_tpu_torch/csrc/clahe.cu",
         "yamimageprocessor_tpu/ops/clahe.py:408 clahe_grid_hist_tile_j (XLA segment_sum in the streaming stats "
         "pass, not a pallas_call; the stream instance of pallas_kernels.py:457's tile histograms)",
         "none: no single PyTorch call counts weighted levels by grid cell (index_add_ needs the cell and weight "
         "planes formed first); ms: 7 tiles of 2048^2 of the 16380^2 CLAHE slide's fourth row (also checked on "
         "the last row's mirror rows and the corner tile); by_input: the same geometry as float32 and uint16"),
        ("clahe_stream_blend", "yamimageprocessor_tpu_torch/csrc/clahe.cu",
         "yamimageprocessor_tpu/ops/clahe.py:440 clahe_apply_from_hist_j (XLA 256-pass fori_loop in the streaming "
         "apply pass, not a pallas_call; the stream instance of ops/clahe_pallas.py:137's blend)",
         "none: no single PyTorch call blends four table lookups a pixel; ms: the same 7 tiles; bound: the larger "
         "of the bytes and stream_blend_least_ops' float32 instructions; by_input: float32 and uint16"),
    ]
    rows += [
        ("gradient", "yamimageprocessor_tpu_torch/csrc/edges.cu",
         "yamimageprocessor_tpu/ops/edges.py:89 sobel_j, :125 prewitt_j, :153 laplacian_j (XLA, not a pallas_call)",
         "torch.nn.functional.conv2d in float32 (TF32 off) of Sobel's two 3x3 derivatives on the gray batch as "
         "float32, zero padding, no magnitude: not bit-exact, the yardstick only; ms: Sobel ksize 3 (the default) "
         "on the denoise batch's 8 gray 2048^2 frames; bound: the folded taps' least count (gradient_bounds)"),
        ("canny_candidates", "yamimageprocessor_tpu_torch/csrc/edges.cu",
         "yamimageprocessor_tpu/ops/edges.py:219 canny_j's gradients and suppression (XLA, not a pallas_call)",
         "none: PyTorch has no Canny; ms: aperture 3, thresholds 50/150 on the 8 gray 2048^2 frames; bound: the "
         "folded taps' least count and the suppression's (canny_bounds); the hysteresis runs on the CC kernel "
         "(cc's launches include it)"),
        ("adaptive_threshold", "yamimageprocessor_tpu_torch/csrc/adaptive.cu",
         "yamimageprocessor_tpu/ops/threshold.py:99 adaptive_threshold_j (XLA, not a pallas_call)",
         "none: no single PyTorch call gives the rounded Gaussian mean and the compare; ms: block 11, C 2 on the "
         "8 gray 2048^2 frames"),
        ("region_grow", "yamimageprocessor_tpu_torch/csrc/growing.cu",
         "yamimageprocessor_tpu/ops/growing.py:50 region_growing_j_dyn (XLA while_loop, not a pallas_call)",
         "none: PyTorch has no flood fill; ms: seed (50, 50), tolerance 10 on the 8 gray 2048^2 frames (3 CUDA "
         "launches: the tiles' pieces and perimeter nodes, the seam unions, the paint)"),
    ]
    for name in EDGE_KERNELS:
        for key in ("err", "times", "bounds", "library"):
            kern[key][name] = edg[key][name]
    for name in STREAM_KERNELS:
        kern["err"][name] = max(v for k, v in stm["err"].items() if k.startswith("hist" if "hist" in name else "blend"))
        kern["times"][name] = stm["times"][name]
        kern["bounds"][name] = stm["bounds"][name]
        kern["library"][name] = None
    for name in SHAPE_KERNELS:
        for key in ("err", "times", "bounds", "library"):
            kern[key][name] = shp[key][name]
    for name in TEXTURE_KERNELS:
        for key in ("err", "times", "bounds", "library"):
            kern[key][name] = tex[key][name]
    for name in EXTRACT_KERNELS:
        kern["err"][name] = ext["err"][name]
        kern["times"][name] = ext["timed"]["times"][name]
        kern["bounds"][name] = ext["timed"]["bounds"][name]
        kern["library"][name] = ext["timed"]["library"][name]
    for name in ("median", "bilateral"):
        kern["err"][name] = filt["err"][name]
        kern["times"][name] = filt["times"][name]
        kern["bounds"][name] = filt["bounds"][name]
        kern["library"][name] = filt["library"].get(name)
    entries = []
    for name, source, replaces, library_note in rows:
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": kern["err"][name],
            "ms": kern["times"][name][0],
            "plain_ms": kern["times"][name][1],
            "bound_ms": kern["bounds"][name][0],
            "bound_by": kern["bounds"][name][1],
            "library_ms": kern["library"].get(name),
            "library_note": library_note,
        }
        if name == "sepconv":
            entry.update(kern["sepconv_clahe"])
            entry["ms_19taps"], entry["plain_ms_19taps"] = filt["times"]["sepconv 19"]
            entry["bound_ms_19taps"] = filt["bounds"]["sepconv 19"][0]
        if name in ("median", "bilateral"):
            entry["plain_torch_float32_ms"] = {k: v for k, v in filt["slow"].items() if k.startswith(name)}
            entry["by_ksize"] = filt["by_ksize"][name]
        if name == "median":
            entry["minmax_ops_per_s"] = filt["minmax_rate"]
        if name == "histogram256":
            entry["by_input"] = kern["hist_times"]
            entry["bound_ms_one_frame"] = kern["hist_bound_one_ms"]
            entry["empty_launch_ms"] = kern["empty_launch_ms"]
        if name == "cc":
            entry["case_ms"] = {k[3:]: v for k, v in kern["case_times"].items() if k.startswith("cc ")}
        if name == "clahe_blend":
            entry["shared_bytes"] = kern["blend_shared_bytes"]
        if name in EXTRACT_KERNELS:
            entry["one_frame_ms"] = ext["one_frame"]["times"][name][0]
            entry["one_frame_bound_ms"] = ext["one_frame"]["bounds"][name][0]
        if name in ("hull_areas", "annotate"):
            entry["by_input"] = {case: times[name] for case, times in ext["case_times"].items()}
        if name == "hull_areas":
            entry["blobs_peak_memory"] = ext["peak"]
        if name == "region_scan":
            entry["one_frame_plain_ms"] = ext["one_frame"]["times"][name][1]
            entry["one_frame_library_ms"] = ext["one_frame"]["library"][name]
            entry["by_input"] = ext["scan_times"]
        if name in TEXTURE_KERNELS:
            entry["by_input"] = tex["by_input"][name]
        if name == "glcm_counts":
            entry["design"] = ("one cooperative launch: the output zeroed in it, units of at most 65535 pairs "
                               "(whole window rows) counted as 16-bit halves in a 128 KiB block-private table, "
                               "flushed after a grid barrier by one global atomic a non-zero counter")
            entry["empty_launch_ms"] = kern["empty_launch_ms"]
        if name == "hog_cells":
            entry["design"] = ("a tile of whole cells staged in shared memory as float32 with a 1-pixel halo; "
                               "each pixel's magnitude and bin formed once; a thread a (cell, bin) adds its bin's "
                               "magnitudes in cell_order's order; a warp's outputs consecutive floats")
        if name in SHAPE_KERNELS:
            entry["by_input"] = shp["by_input"][name]
        if name in STREAM_KERNELS:
            entry["by_input"] = {f"middle row {kind}": {"ms": stm["times"][f"{name} {kind}"][0],
                                                        "plain_ms": stm["times"][f"{name} {kind}"][1],
                                                        "bound_ms": stm["bounds"][f"{name} {kind}"][0],
                                                        "bound_by": stm["bounds"][f"{name} {kind}"][1]}
                                 for kind in ("float32", "uint16")}
        if name == "stream_grid_histogram":
            entry["design"] = ("a persistent grid from the occupancy API over the batch's loads, whatever work item "
                               "they lie in; raw counts in a lane-column table, count x weight flushed by one global "
                               "atomic a bin where the cell or weight changes; uint16 and float32 levels outside "
                               "0..255 straight to the output at the reference's wrapped flat index")
        if name == "clahe_stream_blend":
            entry["design"] = ("a persistent grid from the occupancy API over the strips' rows (strips of up to "
                               "1024 columns) in chunks of up to 64; a chunk's pair entries (t00..t11 of a level as float16, 8 bytes) staged from the "
                               "uint8 tables in shared memory; one entry a pixel; a lane 4 columns with the next "
                               "step's loads in flight; no clip (the sum lies in [0, 255.5))")
            entry["least_f32_instructions_a_pixel"] = stream_blend_least_ops()
        if name == "fourier_lines":
            entry["max_rel_line_err"] = shp["line_err"]
            entry["tolerance"] = {"lines": FOURIER_LINE_TOL, "reconstruction": FOURIER_RECON_TOL}
        if name == "flood":
            entry.update(kern["flood_stats"])
            entry["device_ms"] = kern["flood_device_ms"]
            entry["swept_bound_ms"] = kern["flood_swept_bound_ms"]
        entries.append(entry)
    print(f"extraction rates: {json.dumps(ext['rates'])}")
    print(f"texture chains: {json.dumps(tex['chains'])}; tables host ms a frame: {json.dumps(tex['tables_ms'])}")
    print(f"fourier chain: {json.dumps(shp['chains'])}; shape tables host ms a frame: {json.dumps(shp['tables_ms'])}")
    print(f"streaming GPix/s: {json.dumps(stm['gpix_s'])}; sweep parts ms: {json.dumps(stm['breakdown'])}; "
          f"transfer GB/s: {json.dumps(stm['transfer_gb_s'])}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": entries}))
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
