"""The port's region table above the JAX package's first capacity tier.

The JAX package's device bundle compiles a one-hot of width 512 or 1024
for such frames, slow on a CPU, and past 1024 regions it falls back to its
host path.  So these frames are held against the JAX package's CPU data
path (``region_properties_data``: ``measure_np`` + ``solidity_np``), at
625 regions (``tests/test_extraction_device.py:484-498``'s frame) and at
1089, with the tolerances of ``tests/test_torch_extraction.py``; at 1089
the JAX package's ``region_tables_device`` reports the frame saturated
(its host fallback), and the port's table is that host table.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.ops import extraction as EX
from yamimageprocessor_tpu.ops import extraction_device as XD
from yamimageprocessor_tpu.ops import regionprops as JRP
from yamimageprocessor_tpu.ops.labeling import label_np
from yamimageprocessor_tpu_torch.ops import extraction_device as TXD
from yamimageprocessor_tpu_torch.ops.extraction import region_properties_data

torch.set_num_threads(1)


def blobs(count: int, pitch: int, side: int = 200) -> np.ndarray:
    """``count x count`` 4x4 blobs on a ``pitch``-pixel grid, BGR."""

    img = np.zeros((side, side), np.uint8)
    for i in range(count):
        for j in range(count):
            img[2 + i * pitch : 6 + i * pitch, 2 + j * pitch : 6 + j * pitch] = 220
    return np.repeat(img[..., None], 3, axis=-1)


CASES = {"625": (25, 8, 625), "1089": (33, 6, 1089)}


@pytest.mark.parametrize("case", list(CASES))
def test_wide_table_matches_the_jax_cpu_data_path(case):
    count, pitch, regions = CASES[case]
    bgr = blobs(count, pitch)
    TXD.clear_table_cache()
    table = TXD.region_table(bgr, device="cpu")
    labels = label_np(EX._binary(bgr) > 0)
    meas = JRP.measure_np(labels)
    solidity = JRP.solidity_np(labels, meas)
    got = table["meas"]
    assert got.count == meas.count == regions
    np.testing.assert_array_equal(got.area[1:], meas.area[1:])
    np.testing.assert_array_equal(got.bbox[1:], meas.bbox[1:])
    np.testing.assert_array_equal(table["solidity"][1:], solidity[1:])
    np.testing.assert_array_equal(got.centroid_r[1:], meas.centroid_r[1:])
    np.testing.assert_array_equal(got.centroid_c[1:], meas.centroid_c[1:])
    np.testing.assert_allclose(got.perimeter[1:], meas.perimeter[1:], rtol=1e-12)
    np.testing.assert_allclose(got.eccentricity()[1:], meas.eccentricity()[1:], rtol=1e-9, atol=1e-6)
    data = region_properties_data(bgr, device="cpu")
    want = EX.region_properties_data(bgr)
    for col in ("region_index", "area", "solidity", "extent"):
        np.testing.assert_array_equal(data[col], want[col].to_numpy())
    np.testing.assert_allclose(data["perimeter"], want["perimeter"].to_numpy(), rtol=1e-12)


def test_past_1024_regions_the_jax_package_takes_its_host_table():
    bgr = blobs(33, 6)
    XD.clear_gray_operand_cache()
    (jax_table,) = XD.region_tables_device([bgr])
    assert jax_table.get("saturated") and jax_table["max_label"] == 1089
    TXD.clear_table_cache()
    (table,) = TXD.region_tables([bgr, blobs(25, 8)], device="cpu")[:1]
    assert table["meas"].count == 1089
