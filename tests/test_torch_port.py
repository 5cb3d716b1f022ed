"""The port's own copies of the JAX package's host code against the
originals: op records, step-name resolution, parameter splits and halos,
the tap and table constructors, and the step wire format.  The port
imports nothing of the JAX package, so these copies must stay equal.
"""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.ops import _kernels as JK
from yamimageprocessor_tpu.ops.registry import get_impl as jax_impl
from yamimageprocessor_tpu.ops.schema import Stage as JaxStage
from yamimageprocessor_tpu.ops.schema import op_by_identifier as jax_schema
from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.models import stages as S
from yamimageprocessor_tpu_torch.ops import tables as T
from yamimageprocessor_tpu_torch.ops.registry import get_impl
from yamimageprocessor_tpu_torch.ops.schema import ALL_OPS, Stage, op_by_identifier
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep, StepExecutionMetadata

PORTED = sorted(op.identifier for op in ALL_OPS)


def test_the_port_has_the_eleven_ops_of_its_two_chains():
    """The eleven ops of the flagship and segmentation chains, the two the
    CLAHE chain adds, the rest of preprocessing (all ten preprocessing ops
    of the reference), the region-properties extraction, Hu moments,
    histogram statistics, the texture features (LBP, Haralick, Gabor,
    HOG, fractal dimension), the Fourier descriptors and the approximate
    shape, the stencil and reachability ops of segmentation (adaptive
    threshold, Canny edge, Sobel, Prewitt, Laplacian, region growing,
    border removal): 34 of the reference's 41 ids, every extraction id."""

    assert PORTED == sorted(
        [
            "preprocessing.grayscale",
            "preprocessing.normalize",
            "preprocessing.sharpen",
            "preprocessing.crop",
            "preprocessing.noise_reduction",
            "preprocessing.histogram_equalization",
            "preprocessing.brightness_contrast",
            "preprocessing.gamma",
            "preprocessing.clahe",
            "preprocessing.select_channel",
            "segmentation.global_threshold",
            "segmentation.otsu",
            "segmentation.opening",
            "segmentation.closing",
            "segmentation.dilation",
            "segmentation.erosion",
            "segmentation.watershed",
            "segmentation.adaptive",
            "segmentation.edge",
            "segmentation.sobel",
            "segmentation.prewitt",
            "segmentation.laplacian",
            "segmentation.region_growing",
            "segmentation.border_removal",
            "extraction.region_properties",
            "extraction.hu_moments",
            "extraction.histogram",
            "extraction.lbp",
            "extraction.haralick",
            "extraction.gabor",
            "extraction.hog",
            "extraction.fractal",
            "extraction.fourier",
            "extraction.approximate_shape",
        ]
    )


@pytest.mark.parametrize("identifier", PORTED)
def test_records_and_flags_match_jax(identifier):
    ours, ref = op_by_identifier(identifier), jax_schema(identifier)
    assert (ours.identifier, ours.stage.value, ours.method, ours.step_name) == (
        ref.identifier,
        ref.stage.value,
        ref.method,
        ref.step_name,
    )
    impl, jimpl = get_impl(identifier), jax_impl(identifier)
    assert (impl.lut_fn is not None) == (jimpl.lut_fn is not None)
    assert impl.lut_needs_image == jimpl.lut_needs_image
    assert tuple(impl.lut_ndims) == tuple(jimpl.lut_ndims)
    assert (impl.data_fn is not None) == (jimpl.data_fn is not None)
    # the streaming flags and decompositions
    assert (impl.global_stats, impl.reshapes) == (jimpl.global_stats, jimpl.reshapes)
    assert impl.streamable_global == jimpl.streamable_global
    assert (impl.stream_gate is not None) == (jimpl.stream_gate is not None)
    assert (impl.stats_lut_fn is not None) == (jimpl.stats_lut_fn is not None)


@pytest.mark.parametrize("identifier", PORTED)
def test_step_names_resolve_alike(identifier):
    op = op_by_identifier(identifier)
    ours = PipelineStep(name=op.step_name, stage=op.stage)
    ref = JaxStep(name=op.step_name, stage=JaxStage(op.stage.value))
    assert ours.op_id == ref.op_id == identifier


_SPLIT_CASES = [
    ("preprocessing.noise_reduction", {}),
    ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 5}),
    ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 8}),
    ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 13}),
    ("preprocessing.noise_reduction", {"method": "Median", "ksize": 3}),
    ("preprocessing.noise_reduction", {"method": "Median", "ksize": 4}),
    ("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": 1}),
    ("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": 5}),
    ("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": 8}),
    ("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": 31}),
    ("preprocessing.noise_reduction", {"method": "Unknown", "ksize": 3}),
    ("preprocessing.grayscale", {}),
    ("preprocessing.normalize", {}),
    ("preprocessing.normalize", {"alpha": 200, "beta": "7.5"}),
    ("preprocessing.sharpen", {}),
    ("preprocessing.sharpen", {"strength": 1.3}),
    ("preprocessing.crop", {}),
    ("preprocessing.crop", {"x_offset": "5", "y_offset": 7, "width": 300, "height": 2, "apply_crop": 0}),
    ("preprocessing.histogram_equalization", {}),
    ("preprocessing.brightness_contrast", {}),
    ("preprocessing.brightness_contrast", {"alpha": 1.2, "beta": 4.0}),
    ("preprocessing.gamma", {"value": 0.7}),
    ("preprocessing.gamma", {"value": 2.2}),
    ("preprocessing.clahe", {}),
    ("preprocessing.clahe", {"clip_limit": 2.0, "grid_size": 4}),
    ("preprocessing.clahe", {"clip_limit": 0, "grid_size": "64"}),
    ("preprocessing.select_channel", {}),
    ("preprocessing.select_channel", {"value": "RG"}),
    ("segmentation.global_threshold", {}),
    ("segmentation.global_threshold", {"threshold": 90}),
    ("segmentation.otsu", {}),
    ("segmentation.watershed", {}),
    ("segmentation.watershed", {"kernel_size": 5, "opening_iterations": 1, "dilation_iterations": 2,
                                "distance_threshold_factor": 0.5}),
    ("segmentation.opening", {"kernel_shape": "Rectangular", "kernel_size": 3, "iterations": 2}),
    ("segmentation.closing", {"kernel_shape": "Elliptical", "kernel_size": 5, "iterations": 1}),
    ("segmentation.dilation", {}),
    ("segmentation.erosion", {"kernel_shape": "Cross", "kernel_size": 7, "iterations": 0}),
    ("segmentation.adaptive", {}),
    ("segmentation.adaptive", {"block_size": 10, "C": -2.5}),
    ("segmentation.adaptive", {"block_size": "255", "C": 100}),
    ("segmentation.edge", {}),
    ("segmentation.edge", {"low_threshold": 300.7, "high_threshold": "20", "aperture_size": 7}),
    ("segmentation.sobel", {}),
    ("segmentation.sobel", {"ksize": 31}),
    ("segmentation.prewitt", {}),
    ("segmentation.laplacian", {"ksize": 1}),
    ("segmentation.laplacian", {"ksize": 19}),
    ("segmentation.region_growing", {}),
    ("segmentation.region_growing", {"seed": (-3, 900), "tolerance": 0}),
    ("segmentation.border_removal", {}),
    ("segmentation.border_removal", {"border_distance": 400}),
    ("extraction.region_properties", {}),
    ("extraction.hu_moments", {}),
    ("extraction.histogram", {}),
    ("extraction.lbp", {}),
    ("extraction.lbp", {"P": "16", "R": 2.5}),
    ("extraction.lbp", {"P": 24, "R": "8"}),
    ("extraction.haralick", {"distance": 3, "angle": 0.7}),
    ("extraction.gabor", {}),
    ("extraction.gabor", {"ksize": "5", "sigma": 2, "theta": 0.7, "lambd": 4.5, "gamma": 1.25, "psi": -0.3}),
    ("extraction.gabor", {"ksize": 101, "sigma": 30.0}),
    ("extraction.hog", {}),
    ("extraction.hog", {"orientations": "12", "pixels_per_cell": [4, 4], "cells_per_block": (2, 2)}),
    ("extraction.fractal", {"min_box_size": 4}),
    ("extraction.fourier", {}),
    ("extraction.fourier", {"num_coeff": "512"}),
    ("extraction.approximate_shape", {}),
    ("extraction.approximate_shape", {"error_threshold": 5.0}),
]


@pytest.mark.parametrize("identifier, params", _SPLIT_CASES)
def test_splits_and_halos_match_jax(identifier, params):
    static, dyn = get_impl(identifier).split(params)
    jstatic, jdyn = jax_impl(identifier).split_params(params, (40, 60))
    assert static == jstatic
    assert sorted(dyn) == sorted(jdyn)
    for key in dyn:
        ours, ref = np.asarray(dyn[key]), np.asarray(jdyn[key])
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        assert (ours == ref).all()
    assert get_impl(identifier).halo_for(params) == jax_impl(identifier).halo_for(params)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 11, 13, 19, 31])
def test_gaussian_tables_match_jax(ksize):
    assert T.gaussian_sigma_for_ksize(ksize) == JK.gaussian_sigma_for_ksize(ksize)
    for sigma in (0.5, 3.0, ksize / 2):
        for depth_is_8u in (True, False):
            assert T.gaussian_ksize_for_sigma(sigma, depth_is_8u) == JK.gaussian_ksize_for_sigma(sigma, depth_is_8u)
    for sigma in (0.0, 1.5):
        ours, ref = T.gaussian_taps(ksize, sigma), JK.gaussian_taps(ksize, sigma)
        assert ours.dtype == ref.dtype and (ours == ref).all()


def test_sobel_halo_covers_the_ksize_1_derivative():
    """The one halo that is not the JAX package's: Sobel at ksize 1 has a
    3-tap derivative, so the port's halo is 1 where the reference's
    ``ksize // 2`` is 0 (its tiles would miss their neighbours' columns)."""

    assert get_impl("segmentation.sobel").halo_for({"ksize": 1}) == 1
    assert jax_impl("segmentation.sobel").halo_for({"ksize": 1}) == 0


@pytest.mark.parametrize("ksize", range(1, 32, 2))
def test_derivative_and_laplacian_tables_match_jax(ksize):
    for order in (0, 1, 2):
        ours, ref = T.deriv_taps(order, ksize), JK.deriv_taps(order, ksize)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape and (ours == ref).all()
    ours, ref = T.laplacian_kernel(ksize), JK.laplacian_kernel(ksize)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape and (ours == ref).all()


@pytest.mark.parametrize("ksize", [1, 2, 3, 5, 9, 21, 31])
def test_bilateral_tables_and_window_match_jax(ksize):
    from yamimageprocessor_tpu.ops.preprocess import dyn_offsets_for

    from yamimageprocessor_tpu_torch.ops.bilateral import window_offsets

    for sigma in (75.0, 10.0):
        (ours, mask), (ref, ref_mask) = T.bilateral_space_weights(ksize, sigma), JK.bilateral_space_weights(ksize, sigma)
        assert ours.dtype == ref.dtype and (ours == ref).all() and (mask == ref_mask).all()
    for channels in (1, 3):
        ours, ref = T.bilateral_color_weights(75.0, channels), JK.bilateral_color_weights(75.0, channels)
        assert ours.dtype == ref.dtype and (ours == ref).all()
    assert window_offsets(ksize) == tuple((int(j), int(i)) for j, i in dyn_offsets_for(ksize))


@pytest.mark.parametrize("ksize, sigma, theta, lambd, gamma, psi", [
    (21, 5.0, 0.0, 10.0, 0.5, 0.0), (3, 1.0, 0.3, 2.0, 1.0, 0.5), (101, 40.0, 6.2832, 100.0, 10.0, -6.2832),
    (0, 2.0, 1.2, 5.0, 0.7, 0.1), (5, 0.1, 3.1, 0.1, 0.01, 1.0),
])
def test_gabor_kernel_matches_jax(ksize, sigma, theta, lambd, gamma, psi):
    ours, ref = T.gabor_kernel(ksize, sigma, theta, lambd, gamma, psi), JK.gabor_kernel(ksize, sigma, theta, lambd, gamma, psi)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape and ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("p, r", [(8, 1.0), (16, 2.0), (24, 8.0), (4, 0.5), (12, 1.5), (7, 3.3), (24, 1.0)])
def test_lbp_offsets_match_jax(p, r):
    from yamimageprocessor_tpu.ops.texture import _lbp_offsets

    from yamimageprocessor_tpu_torch.ops.texture import lbp_offsets

    ours, ref = lbp_offsets(p, r), _lbp_offsets(p, r)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("side", [2, 3, 8, 16, 64])
def test_hog_stamps_match_jax(side):
    from yamimageprocessor_tpu.ops.hogf import _stamp_masks

    from yamimageprocessor_tpu_torch.ops.hogf import stamp_masks

    for orientations in (1, 9, 32):
        ours, ref = stamp_masks((side, side), orientations), _stamp_masks((side, side), orientations)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("identifier", ["extraction.lbp", "extraction.gabor", "extraction.hog"])
def test_texture_displays_are_uint8_gray(identifier):
    """LBP, Gabor and HOG turn an ``(H, W[, C])`` item of any dtype into a
    uint8 ``(H, W)`` display, as the reference's device functions do."""

    impl = get_impl(identifier)
    for item, dtype in (((40, 60), np.uint8), ((40, 60, 3), np.uint8), ((40, 60, 4), np.float32), ((9, 7), np.uint16)):
        assert impl.out_item(item, np.dtype(dtype), **impl.split({})[0]) == (item[:2], np.dtype(np.uint8))


def test_text_annotated_texture_ops_refuse_a_chain():
    """Haralick, the fractal dimension and the approximate shape annotate
    with host text in the reference: the port has their tables only, and a
    chain naming them raises (as for Hu moments and histogram
    statistics)."""

    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

    for identifier, name in (("extraction.haralick", "Haralick"), ("extraction.fractal", "Fractal"),
                             ("extraction.approximate_shape", "Approximate Shape")):
        impl = get_impl(identifier)
        assert impl.device_fn is None and impl.data_fn is not None
        step = PipelineStep(name=name, stage=Stage.ANALYSIS)
        assert step.op_id == identifier
        with pytest.raises(NotImplementedError, match="data_fn"):
            PipelineManager([step], device="cpu").apply(np.zeros((8, 8, 3), np.uint8))


def test_gamma_tables_and_structuring_elements_match_jax():
    for value in (0.1, 0.45, 1.0, 2.2, 10.0):
        assert (T.gamma_lut(value) == JK.gamma_lut(value)).all()
    for shape in ("Rectangular", "Elliptical", "Cross", "unknown"):
        for size in (1, 2, 3, 4, 5, 7, 9):
            ours, ref = T.structuring_element(shape, size), JK.structuring_element(shape, size)
            assert ours.dtype == ref.dtype and (ours == ref).all()


@pytest.mark.parametrize("h, w, grid", [(96, 120, (8, 8)), (1001, 1001, (7, 7)), (8, 4, (4, 4)), (1024, 1024, (64, 64))])
def test_clahe_interp_weights_match_jax(h, w, grid):
    from yamimageprocessor_tpu.ops.clahe import _interp_weights

    from yamimageprocessor_tpu_torch.ops.clahe import interp_weights

    for ours, ref in zip(interp_weights(h, w, grid), _interp_weights(h, w, grid)):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize(
    "make_steps", [S.preprocess_steps, S.segmentation_steps, S.full_pipeline_steps], ids=["pre", "seg", "full"]
)
def test_stage_chains_match_jax_and_round_trip(make_steps):
    from yamimageprocessor_tpu.models import stages as JS

    ours = make_steps()
    ref = getattr(JS, make_steps.__name__)()
    assert [s.to_dict() for s in ours] == [s.to_dict() for s in ref]
    loaded = [PipelineStep.from_dict(s.to_dict()) for s in ref]
    assert [s.to_dict() for s in loaded] == [s.to_dict() for s in ref]


def test_step_execution_metadata_round_trips():
    step = PipelineStep(
        name="Gamma",
        stage=Stage.PREPROCESSING,
        params={"value": 2.0},
        execution=StepExecutionMetadata(supports_inplace=True),
        supports_tiled_input=True,
    )
    ref = JaxStep.from_dict(step.to_dict())
    assert ref.to_dict() == step.to_dict()
    assert PipelineStep.from_dict(ref.to_dict()).to_dict() == step.to_dict()
    assert step.clone().to_dict() == step.to_dict()


def test_unknown_ops_and_host_steps():
    with pytest.raises(NotImplementedError):
        op_by_identifier("segmentation.kmeans")
    with pytest.raises(NotImplementedError):
        _ = PipelineStep(name="K-Means", op_id="segmentation.kmeans").impl
    host = PipelineStep(name="Invert", function=lambda img: 255 - img)
    assert host.impl is None and not host.is_device_capable()
    assert (host.apply(np.zeros((2, 2), np.uint8)) == 255).all()
    with pytest.raises(NotImplementedError):
        PipelineStep(name="Otsu", stage=Stage.SEGMENTATION).apply(np.zeros((2, 2), np.uint8))


def _host_frames():
    rng = np.random.default_rng(11)
    mask = np.zeros((23, 31), np.uint8)
    mask[4:15, 6:20] = 255
    mask[17:21, 2:29] = 255
    return {
        "noise": rng.integers(0, 256, (37, 45), dtype=np.uint8),
        "mask": mask,
        "flat": np.full((17, 19), 90, np.uint8),
        "empty": np.zeros((9, 12), np.uint8),
        "float": (rng.standard_normal((26, 30)) * 50 + 100).astype(np.float32),
    }


@pytest.mark.parametrize("kind", ["noise", "mask", "flat", "float"])
def test_hog_gradients_np_match_jax(kind):
    from yamimageprocessor_tpu.ops.hogf import _gradients_np

    from yamimageprocessor_tpu_torch.ops.hogf import gradients_np

    img = _host_frames()[kind].astype(np.float64)
    for ours, ref in zip(gradients_np(img), _gradients_np(img)):
        assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("kind", ["noise", "mask", "flat", "float"])
@pytest.mark.parametrize("params", [(9, (8, 8), (3, 3)), (7, (4, 4), (2, 2)), (12, (6, 5), (1, 1)), (9, (8, 8), (9, 9))])
def test_hog_features_np_match_jax(kind, params):
    from yamimageprocessor_tpu.ops.hogf import hog_features_np as ref_features

    from yamimageprocessor_tpu_torch.ops.hogf import hog_features_np

    gray = _host_frames()[kind]
    for ours, ref in zip(hog_features_np(gray, *params), ref_features(gray, *params)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape and ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("kind", ["noise", "mask", "flat", "empty", "float"])
def test_moments_and_hu_moments_match_jax(kind):
    from yamimageprocessor_tpu.ops import shape as SH

    from yamimageprocessor_tpu_torch.ops.extraction import hu_moments, moments_np

    img = _host_frames()[kind]
    ours, ref = moments_np(img), SH.moments_np(img)
    assert list(ours) == list(ref)
    assert np.array(list(ours.values())).tobytes() == np.array(list(ref.values())).tobytes()
    assert hu_moments(ours).tobytes() == SH.hu_moments(ref).tobytes()


# ---------------------------------------------------------------------------
# the streaming runtime's host code


@pytest.mark.parametrize("width, height, tile", [(100, 50, (32, 32)), (64, 64, (64, 64)), (7, 5, (2, 3)), (9, 4, None)])
def test_tile_boxes_match_jax(width, height, tile):
    from yamimageprocessor_tpu.parallel import tiling as JT

    from yamimageprocessor_tpu_torch.parallel import tiling as TT

    assert list(TT.iter_tile_boxes(width, height, tile)) == list(JT.iter_tile_boxes(width, height, tile))
    for box in TT.iter_tile_boxes(width, height, tile):
        for halo in (0, 1, 9):
            assert TT._expand_box(box, halo, width, height) == JT._expand_box(box, halo, width, height)


def test_grid_gates_match_jax():
    from yamimageprocessor_tpu.parallel import tiling as JT

    from yamimageprocessor_tpu_torch.parallel import tiling as TT

    for width, height in [(128, 96), (123, 90), (64, 64), (16384, 16384), (16380, 16380), (40, 40)]:
        for tw, th in [(32, 32), (2048, 2048), (64, 47), (40, 40), (0, 8)]:
            for halo in (0, 2, 11, 30):
                assert TT._exact_grid(width, height, tw, th, halo) == JT._exact_grid(width, height, tw, th, halo)


@pytest.mark.parametrize(
    "make_steps", [S.preprocess_steps, S.segmentation_steps, S.full_pipeline_steps], ids=["flagship", "segmentation", "full"]
)
def test_chain_routing_matches_jax(make_steps):
    from yamimageprocessor_tpu.parallel import tiling as JT

    from yamimageprocessor_tpu_torch.parallel import tiling as TT

    ours = make_steps()
    ref = [JaxStep.from_dict(s.to_dict()) for s in ours]
    crop = {"name": "Crop", "stage": "preprocessing", "params": {"width": 8, "height": 8}}
    clahe = {"name": "clahe", "stage": "preprocessing", "params": {"grid_size": 8}}
    for extra in ([], [crop], [clahe]):
        o = ours + [PipelineStep.from_dict(e) for e in extra]
        r = ref + [JaxStep.from_dict(e) for e in extra]
        assert TT.chain_halo(o) == JT.chain_halo(r)
        assert TT.chain_tileable(o) == JT.chain_tileable(r)
        for shape in [(96, 128), (10, 10), (2048, 2048, 3)]:
            assert TT.chain_streamable(o, shape) == JT.chain_streamable(r, shape)
        for tile in [(32, 32), (7, 9), None]:
            assert TT._uniform_candidate(o, None, tile, 128, 96) == JT._uniform_candidate(r, None, tile, 128, 96)


@pytest.mark.parametrize("shape", [(4, 5), (4, 5, 3), (4, 5, 4), (2, 3, 2)])
def test_rgb_to_bgr_matches_jax(shape):
    from yamimageprocessor_tpu.io.tiled_image import rgb_to_bgr as ref

    from yamimageprocessor_tpu_torch.io.tiled_image import rgb_to_bgr

    array = np.arange(int(np.prod(shape)), dtype=np.uint8).reshape(shape)
    assert np.array_equal(rgb_to_bgr(array), ref(array))


def test_clahe_stream_gate_matches_jax():
    from yamimageprocessor_tpu.ops.clahe import clahe_stream_gate as ref

    from yamimageprocessor_tpu_torch.ops.clahe import clahe_stream_gate

    for h in (8, 10, 17, 94, 123, 1000, 16380, 16384):
        for w in (8, 9, 33, 128, 16380):
            for grid in (2, 3, 8, 13, 64):
                assert clahe_stream_gate(grid, (h, w)) == ref(grid, (h, w))
