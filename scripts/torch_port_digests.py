#!/usr/bin/env python3
"""SHA-256 digests of the JAX package's outputs on the inputs
``chip_smoke.py`` drives the torch port with, so the port's run on the card
can be held against the reference without importing it.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/torch_port_digests.py

Prints one JSON object: the digests of the inputs (the segmentation
chain's ``bench._dense_scene(2048, seed=3)``; the flagship chain's 8 x
2048^2 frames from ``np.random.default_rng(0)``; the CLAHE chain's BGR
frames from ``np.random.default_rng(0)`` at 64 x 1024^2 x 3, the bench's
shape, and at 4 x 1000^2 x 3, where the blend's fractions are not
dyadic; the Gaussian's 1024^2 gray frame from ``np.random.default_rng(0)``;
the denoise and bilateral chains' 8 x 2048^2 x 3 BGR frames from
``np.random.default_rng(0)``) and of the JAX package's outputs for them
(``segmentation_steps()`` and
the CLAHE chain through its chain compiler, the CLAHE chain batched as
``bench.py:_extra_batched_clahe`` builds it; ``flagship_forward`` under
``jax.jit``; one ``NoiseReduction`` step at ksize 13 and at 19, whose taps
are not dyadic, so the result pins XLA's fused multiply-adds; the denoise
chain, Grayscale -> Median 5 -> Sharpen 1.0 -> Normalize 0..255 -> the
crop preview at (512, 512, 1024, 1024), and the same chain ending in the
crop itself; one Bilateral step at ksize 5; each batched over the 8
frames); and the exact columns (area, bbox, solidity) of the JAX package's
region tables on a CPU (``region_properties_data``'s host path: ``label_np``,
``measure_np``, ``solidity_np``) for the extraction frames (the BGR
``bench._dense_scene(1024)``, its batches of seeds 0-7 and 0-31 as
``bench.py:_extra_extraction`` builds them, ``_dense_scene(4096)``, and a
2048^2 frame of 4x4 blobs on an 8-pixel pitch, 65536 regions), with the
1024^2 frame's annotated image; and the texture chains (LBP, Gabor at
ksize 21 and HOG at their default parameters, each one step batched over
the 32 BGR 1024^2 scenes of seeds 0-31) with the exact columns of the
texture tables' exact inputs on the first 8 of them (the GLCM's pair
counts, the fractal dimension's box counts, LBP's bin counts and Gabor's
mean from the CPU data path); and the Fourier chain (num_coeff 10 and 512,
``fourier_descriptors_extraction`` frame by frame) on the same 32 scenes
with the Fourier and approximate-shape tables of the first 8 (the columns
that the rounded polygons and the chosen polygons give: everything but
the spectral lines).  ``chip_smoke.py`` keeps these as constants.  Takes
about 10 min and a few GB of memory on an 8-core CPU (the approximate
shape's host loop, ~30 s a frame, most of it); ``--texture`` prints only
the texture digests (about 1 min), ``--shape`` only the shape digests
(about 5 min).  ``--stream`` prints only the streaming digests: the JAX
package's ``apply_steps_tiled`` output of the flagship chain and of the
stream CLAHE chain (CLAHE grid 8, clip 40, then normalize) on a 2048^2
gray frame and a 2048^2 x 3 BGR frame from ``np.random.default_rng``
(seeds 21 and 22), and of the stream CLAHE chain on a gray float32 frame
(uint8's range and a little beyond, with fractions; seed 23) and a gray
uint16 frame (levels to 299; seed 24), in 512^2 tiles (an exact grid) and
in 500 x 300 tiles (a non-exact one); about 3 min.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEG_SIDE = 2048
FLAGSHIP_SHAPE = (8, 2048, 2048)
CLAHE_SHAPES = {"clahe": (64, 1024, 1024, 3), "clahe_1000": (4, 1000, 1000, 3)}
GAUSS_SHAPE = (1024, 1024)
GAUSS_KSIZES = (13, 19)
DENOISE_SHAPE = (8, 2048, 2048, 3)
CROP_BOX = {"x_offset": 512, "y_offset": 512, "width": 1024, "height": 1024}


EXTRACT_SIDE = 1024
EXTRACT_BATCHES = (8, 32)
EXTRACT_WIDE_SIDE = 4096
BLOBS_SIDE = 2048


def digest(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def table_digest(tables) -> str:
    """SHA-256 of the exact columns of per-frame region tables, each
    ``(area, bbox, solidity)`` over regions 1..n: int64, int64, float64."""

    h = hashlib.sha256()
    for area, bbox, solidity in tables:
        for column, dtype in ((area, np.int64), (bbox, np.int64), (solidity, np.float64)):
            h.update(np.ascontiguousarray(np.asarray(column)[1:], dtype=dtype).tobytes())
    return h.hexdigest()


def blobs_frame(side: int = BLOBS_SIDE) -> np.ndarray:
    """4x4 blobs of 220 on an 8-pixel pitch, BGR: (side / 8)^2 regions."""

    img = np.zeros((side, side), np.uint8)
    for y in range(2, side, 8):
        img[y : y + 4] = np.where((np.arange(side) % 8 >= 2) & (np.arange(side) % 8 < 6), 220, 0)
    return np.repeat(img[..., None], 3, axis=-1)


def extraction_digests(result: dict) -> None:
    from bench import _dense_scene
    from yamimageprocessor_tpu.ops import extraction as EX
    from yamimageprocessor_tpu.ops import regionprops as RP
    from yamimageprocessor_tpu.ops.labeling import label_np

    def bgr(side, seed=3):
        return np.repeat(_dense_scene(side, seed=seed)[..., None], 3, axis=-1)

    def table(frame):
        labels = label_np(EX._binary(frame) > 0)
        meas = RP.measure_np(labels)
        return meas.area, meas.bbox, RP.solidity_np(labels, meas)

    frame = bgr(EXTRACT_SIDE)
    cases = {"extract_1024": [frame], "extract_4096": [bgr(EXTRACT_WIDE_SIDE)], "extract_blobs": [blobs_frame()]}
    for count in EXTRACT_BATCHES:
        cases[f"extract_batch{count}"] = [bgr(EXTRACT_SIDE, seed=s) for s in range(count)]
    for name, frames in cases.items():
        tables = [table(f) for f in frames]
        result[f"{name}_input"] = digest(np.stack(frames))
        result[f"{name}_table"] = table_digest(tables)
        result[f"{name}_regions"] = [int(len(t[0]) - 1) for t in tables]
    result["extract_annotated_1024"] = digest(EX.region_properties_extraction(frame))


TEXTURE_FRAMES = 32
TEXTURE_TABLE_FRAMES = 8
TEXTURE_CHAINS = ("LBP", "Gabor", "HOG")


def texture_table_digest(frames) -> str:
    """SHA-256 of what the texture tables are computed from, frame by frame,
    as the JAX package's CPU data path gives it: the GLCM's pair counts at
    distance 1, angle 0 (Haralick's default), the fractal dimension's box
    counts, LBP's bin counts (int64) and Gabor's mean (float64: an exact
    level sum over the pixel count).  Only exact integers and one division:
    the float64 formulas after them (``glcm_props``, ``np.polyfit``) may
    round otherwise on another host's numpy and LAPACK."""

    from yamimageprocessor_tpu.ops import color as C
    from yamimageprocessor_tpu.ops import extraction as EX
    from yamimageprocessor_tpu.ops import hogf as H
    from yamimageprocessor_tpu.ops import texture as TX

    h = hashlib.sha256()
    for frame in frames:
        glcm = TX.glcm_np(C.bgr_to_gray_np(frame), 1, 0.0, symmetric=False, normed=False)
        for values, dtype in (
            (glcm, np.int64),
            (H.fractal_box_counts(EX._binary(frame, maxval=1))[1], np.int64),
            (EX.lbp_data(frame)["count"].to_numpy(), np.int64),
            (EX.gabor_data(frame)["mean"].to_numpy(), np.float64),
        ):
            h.update(np.ascontiguousarray(values, dtype=dtype).tobytes())
    return h.hexdigest()


def texture_digests(result: dict) -> None:
    from bench import _dense_scene
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    frames = np.stack(
        [np.repeat(_dense_scene(EXTRACT_SIDE, seed=s)[..., None], 3, axis=-1) for s in range(TEXTURE_FRAMES)]
    )
    result["texture_input"] = digest(frames)
    for name in TEXTURE_CHAINS:
        steps = [PipelineStep(name=name, stage=Stage.ANALYSIS)]
        out = np.asarray(get_compiled_chain(steps, frames.shape, np.uint8, batch=len(frames)).run_final(frames, steps))
        result[f"texture_{name.lower()}_output"] = digest(out)
        result[f"texture_{name.lower()}_output_shape"] = list(out.shape)
    result["texture_tables"] = texture_table_digest(frames[:TEXTURE_TABLE_FRAMES])


SHAPE_COEFFS = (10, 512)
SHAPE_TABLE_FRAMES = 8
SHAPE_THRESHOLD = 1.0
FOURIER_EXACT = ("num_coeff", "area", "perimeter", "circularity")
SHAPE_COLUMNS = (("region_index", np.int64), ("area", np.float64), ("perimeter", np.float64),
                 ("vertices", np.int64))


def shape_table_digest(fourier_tables, shape_tables) -> str:
    """SHA-256 of each frame's Fourier table's exact columns (num_coeff
    int64; area, perimeter, circularity float64) and approximate-shape
    table (region_index, vertices int64; area, perimeter float64; the
    edge_lengths strings), a frame at a time; a table without columns adds
    nothing but the frame's separator.  Takes DataFrames or dicts of
    arrays."""

    h = hashlib.sha256()
    for fourier, shape in zip(fourier_tables, shape_tables):
        h.update(b"|")
        if len(fourier):
            for column in FOURIER_EXACT:
                h.update(np.ascontiguousarray(np.asarray(fourier[column]), dtype=np.int64 if column == "num_coeff" else np.float64).tobytes())
        if len(shape):
            for column, dtype in SHAPE_COLUMNS:
                h.update(np.ascontiguousarray(np.asarray(shape[column]), dtype=dtype).tobytes())
            h.update("\n".join(str(e) for e in np.asarray(shape["edge_lengths"])).encode())
    return h.hexdigest()


def shape_digests(result: dict) -> None:
    from bench import _dense_scene
    from yamimageprocessor_tpu.ops import extraction as EX

    frames = np.stack(
        [np.repeat(_dense_scene(EXTRACT_SIDE, seed=s)[..., None], 3, axis=-1) for s in range(TEXTURE_FRAMES)]
    )
    result["shape_input"] = digest(frames)
    for k in SHAPE_COEFFS:
        out = np.stack([EX.fourier_descriptors_extraction(f, k) for f in frames])
        result[f"shape_fourier{k}_output"] = digest(out)
    first = frames[:SHAPE_TABLE_FRAMES]
    result["shape_tables"] = shape_table_digest(
        [EX.fourier_data(f, SHAPE_COEFFS[0]) for f in first],
        [EX.approximate_shape_data(f, SHAPE_THRESHOLD) for f in first],
    )


def clahe_steps():
    """The CLAHE chain of ``bench.py:_extra_batched_clahe``: Gaussian 5x5
    -> CLAHE (clip 2.0, grid 4) -> the mean of R and G."""

    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    return [
        PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING, params={"method": "Gaussian", "ksize": 5}),
        PipelineStep(
            name="CLAHE",
            op_id="preprocessing.clahe",
            stage=Stage.PREPROCESSING,
            params={"clip_limit": 2.0, "grid_size": 4},
        ),
        PipelineStep(
            name="SelectChannel",
            op_id="preprocessing.select_channel",
            stage=Stage.PREPROCESSING,
            params={"value": "RG"},
        ),
    ]


def denoise_steps(apply_crop: bool):
    """Grayscale -> Median 5 -> Sharpen 1.0 -> Normalize 0..255 -> Crop
    (``apply_crop`` False: the preview overlay; True: the slice)."""

    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    p = Stage.PREPROCESSING
    return [
        PipelineStep(name="Grayscale", stage=p),
        PipelineStep(name="NoiseReduction", stage=p, params={"method": "Median", "ksize": 5}),
        PipelineStep(name="Sharpen", stage=p, params={"strength": 1.0}),
        PipelineStep(name="IntensityNormalization", stage=p, params={"alpha": 0.0, "beta": 255.0}),
        PipelineStep(name="Crop", stage=p, params={**CROP_BOX, "apply_crop": apply_crop}),
    ]


def bilateral_steps():
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    return [PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING,
                         params={"method": "Bilateral", "ksize": 5})]


STREAM_SIDE = 2048
STREAM_TILES = {"512": (512, 512), "500x300": (500, 300)}  # (width, height)


class _Frame:
    """A tiled source over an in-memory frame (regions only, never whole)."""

    def __init__(self, array: np.ndarray) -> None:
        self._array = array
        self.shape = array.shape
        self.dtype = array.dtype

    def read_region(self, box):
        left, top, right, bottom = box
        return np.array(self._array[top:bottom, left:right, ...])


def stream_frames() -> dict:
    """The streaming digests' frames: gray and BGR uint8, gray float32 and
    uint16 (``chip_smoke.py:stream_digest_frames`` makes the same)."""

    side = STREAM_SIDE
    return {
        "gray": np.random.default_rng(21).integers(0, 256, (side, side), dtype=np.uint8),
        "bgr": np.random.default_rng(22).integers(0, 256, (side, side, 3), dtype=np.uint8),
        "float32": (np.random.default_rng(23).random((side, side), dtype=np.float32) * 270 - 5).astype(np.float32),
        "uint16": np.random.default_rng(24).integers(0, 300, (side, side), dtype=np.uint16),
    }


def stream_clahe_steps(step_cls, stage_cls):
    return [
        step_cls(name="clahe", op_id="preprocessing.clahe", stage=stage_cls.PREPROCESSING,
                 params={"clip_limit": 40.0, "grid_size": 8}),
        step_cls(name="IntensityNormalization", stage=stage_cls.PREPROCESSING, params={}),
    ]


def stream_digests(result: dict) -> None:
    from yamimageprocessor_tpu.models.stages import preprocess_steps
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.parallel.tiling import apply_steps_tiled
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    chains = {"flagship": preprocess_steps(), "clahe": stream_clahe_steps(PipelineStep, Stage)}
    for kind, array in stream_frames().items():
        result[f"stream_{kind}_input"] = digest(array)
        for chain, steps in chains.items():
            if kind not in ("gray", "bgr") and chain != "clahe":
                continue  # float32 and uint16 frames: the CLAHE chain only
            for tiles, tile_size in STREAM_TILES.items():
                out = apply_steps_tiled(steps, _Frame(array), tile_size=tile_size)
                result[f"stream_{chain}_{kind}_{tiles}"] = digest(out)


#: the edges phase's steps: each of the seven ops alone at its defaults, and a Gaussian 5 -> Canny chain
EDGE_OPS = {
    "sobel": ("Sobel", "segmentation.sobel", {}),
    "prewitt": ("Prewitt", "segmentation.prewitt", {}),
    "laplacian": ("Laplacian", "segmentation.laplacian", {}),
    "edge": ("Edge", "segmentation.edge", {}),
    "adaptive": ("Adaptive", "segmentation.adaptive", {}),
    "border_removal": ("Border Removal", "segmentation.border_removal", {}),
    "region_growing": ("Region Growing", "segmentation.region_growing", {}),
}


def edge_steps(step_cls, stage_cls):
    """``{name: steps}`` of the edges phase (``chip_smoke.py`` builds the same)."""

    seg = stage_cls.SEGMENTATION
    chains = {name: [step_cls(name=n, op_id=op, stage=seg, params=dict(p))] for name, (n, op, p) in EDGE_OPS.items()}
    chains["gauss_canny"] = [
        step_cls(name="NoiseReduction", stage=stage_cls.PREPROCESSING, params={"method": "Gaussian", "ksize": 5}),
        step_cls(name="Edge", op_id="segmentation.edge", stage=seg, params={}),
    ]
    return chains


def edge_digests(result: dict) -> None:
    """Each edges chain on the denoise batch (8 x 2048^2 x 3 BGR, batched)
    and on the segmentation scene (``_dense_scene(2048, seed=3)``)."""

    from bench import _dense_scene
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    bgr = np.random.default_rng(0).integers(0, 256, DENOISE_SHAPE, dtype=np.uint8)
    scene = _dense_scene(SEG_SIDE, seed=3)
    result["denoise_input"] = digest(bgr)
    result["segmentation_input"] = digest(scene)
    for name, steps in edge_steps(PipelineStep, Stage).items():
        t = time.perf_counter()
        out = get_compiled_chain(steps, bgr.shape, np.uint8, batch=bgr.shape[0]).run_final(bgr, steps)
        result[f"edges_{name}_bgr"] = digest(np.asarray(out))
        out = get_compiled_chain(steps, scene.shape, np.uint8).run_final(scene, steps)
        result[f"edges_{name}_scene"] = digest(np.asarray(out))
        print(f"edges {name}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bench import _dense_scene
    from yamimageprocessor_tpu.models.stages import flagship_forward, segmentation_steps
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    start = time.perf_counter()
    only = {"--texture": texture_digests, "--shape": shape_digests, "--stream": stream_digests, "--edges": edge_digests}
    if len(sys.argv) == 2 and sys.argv[1] in only:
        result = {"backend": jax.default_backend()}
        only[sys.argv[1]](result)
        result["seconds"] = round(time.perf_counter() - start, 1)
        print(json.dumps(result))
        return
    scene = _dense_scene(SEG_SIDE, seed=3)
    chain = get_compiled_chain(segmentation_steps(), scene.shape, scene.dtype)
    seg = np.asarray(chain.run_final(scene))
    frames = np.random.default_rng(0).integers(0, 256, FLAGSHIP_SHAPE, dtype=np.uint8)
    flagship = np.asarray(jax.jit(flagship_forward)(jnp.asarray(frames)))
    result = {
        "backend": jax.default_backend(),
        "segmentation_input": digest(scene),
        "segmentation_output": digest(seg),
        "segmentation_output_shape": list(seg.shape),
        "flagship_input": digest(frames),
        "flagship_output": digest(flagship),
    }
    for name, shape in CLAHE_SHAPES.items():
        bgr = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
        chain = get_compiled_chain(clahe_steps(), shape, np.uint8, batch=shape[0])
        out = np.asarray(chain.run_final(bgr))
        result.update(
            {
                f"{name}_input": digest(bgr),
                f"{name}_output": digest(out),
                f"{name}_output_shape": list(out.shape),
            }
        )
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    gray = np.random.default_rng(0).integers(0, 256, GAUSS_SHAPE, dtype=np.uint8)
    result["gauss_1024_input"] = digest(gray)
    for ksize in GAUSS_KSIZES:
        steps = [PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING, params={"ksize": ksize})]
        out = np.asarray(get_compiled_chain(steps, GAUSS_SHAPE, np.uint8).run_final(gray))
        result[f"gauss{ksize}_1024_output"] = digest(out)
    bgr = np.random.default_rng(0).integers(0, 256, DENOISE_SHAPE, dtype=np.uint8)
    result["denoise_input"] = digest(bgr)
    for name, steps in (
        ("denoise", denoise_steps(False)),
        ("denoise_crop", denoise_steps(True)),
        ("bilateral", bilateral_steps()),
    ):
        out = np.asarray(get_compiled_chain(steps, bgr.shape, np.uint8, batch=bgr.shape[0]).run_final(bgr, steps))
        result[f"{name}_output"] = digest(out)
        result[f"{name}_output_shape"] = list(out.shape)
    extraction_digests(result)
    texture_digests(result)
    shape_digests(result)
    stream_digests(result)
    edge_digests(result)
    result["seconds"] = round(time.perf_counter() - start, 1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
