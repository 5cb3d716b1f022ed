"""The region-properties extraction on a torch device (the port of part of
``yamimageprocessor_tpu/ops/extraction_device.py``).

The path: gray -> Otsu -> binary (:func:`binary`, ``binary_j``: the
histogram256 kernel) -> compact raster-first labels (the CC kernel) ->
per-region row extremes, bboxes, moment and perimeter sums (one label
pass, :func:`.regionprops.region_scan`) and hull pixel areas (kernel C)
-> either the annotated image (:func:`region_properties_device_fn`,
kernel D) or the per-region table (:func:`region_tables`, finished in
float64 on the host).

The reference's static capacity ladder (64/512/1024 regions), its
saturation re-run, its host relabel past 1024 regions, its hull chain cap
and coordinate limit and its one-hot matmuls exist because XLA needs
static shapes; none is ported.  Every per-region buffer is sized from the
label maxima, read once a call, so the table is the same at any region
count.  Every sum is an exact integer (int64), so the table's area, bbox,
hull area and solidity are exact, and its float columns are formed once,
in float64, from exact integers.  Nothing falls back to the host: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops import regionprops as RP
from yamimageprocessor_tpu_torch.ops.annotate import _as_color, draw_disk, rect_border
from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
from yamimageprocessor_tpu_torch.ops.labeling import label
from yamimageprocessor_tpu_torch.ops.threshold import binary as threshold_binary
from yamimageprocessor_tpu_torch.ops.threshold import otsu_threshold

#: columns of the per-region pack a table is finished from
_BOX = slice(0, 4)  # minr, minc, maxr, maxc (inclusive)
_SUMS = slice(4, 4 + RP.SUMS)
_HULL = 4 + RP.SUMS
#: columns of an annotation box (csrc/extraction.cu: BOX)
ANNOTATION_BOX = 7
_GREEN = (0, 255, 0)
_RED = (0, 0, 255)


def binary(imgs: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """Otsu binarization of a batch ``(B, H, W)`` of gray or ``(B, H, W, C)``
    of BGR items (``binary_j``): uint8 ``(B, H, W)``."""

    gray = bgr_to_gray(imgs)
    return threshold_binary(gray, otsu_threshold(gray), maxval=maxval)


def region_labels(imgs: torch.Tensor) -> torch.Tensor:
    """Compact raster-first int32 labels of the Otsu foreground."""

    return label(binary(imgs) > 0)


def region_count_bound(labels: torch.Tensor) -> int:
    """``nseg``: one more than the largest label of the batch (one read
    back from the device)."""

    return int(labels.amax()) + 1 if labels.numel() else 1


def measure(labels: torch.Tensor, nseg: int):
    """(bbox, sums, (mn, mx)) of every region of ``labels``: the
    ``(N, nseg, 4)`` int32 inclusive ``minr, minc, maxr, maxc``, the
    ``(N, nseg, 9)`` int64 moment and perimeter sums, and the row extremes
    the hull areas are computed from, all from one pass over the labels
    (:func:`.regionprops.region_scan`)."""

    box, sums, mn, mx = RP.region_scan(labels, nseg)
    return box, sums, (mn, mx)


def labeled_measurements(imgs: torch.Tensor):
    """(labels, bbox, sums, (mn, mx)): the front half shared by the
    annotation and the table (``_labeled_measurements``)."""

    labels = region_labels(imgs)
    return (labels, *measure(labels, region_count_bound(labels)))


# ---------------------------------------------------------------------------
# annotation (kernel D)


def annotation_boxes(box: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """``(N, nseg, 7)`` int32 rows ``valid, minr, minc, maxr + 1, maxc + 1,
    floor(centroid_r), floor(centroid_c)``, zero where a region has no
    pixel.  The centroid's floor is an exact integer division, as the
    reference's host path casts its float64 centroid."""

    area = sums[..., RP.AREA]
    valid = area > 0
    two_area = 2 * area.clamp_min(1)
    sr2 = (box[..., 0] + box[..., 2]).to(torch.int64)
    sc2 = (box[..., 1] + box[..., 3]).to(torch.int64)
    cen_r = torch.div(sr2 * area + sums[..., RP.SUM_A], two_area, rounding_mode="floor")
    cen_c = torch.div(sc2 * area + sums[..., RP.SUM_B], two_area, rounding_mode="floor")
    rows = torch.stack(
        [valid.to(torch.int64), box[..., 0], box[..., 1], box[..., 2] + 1, box[..., 3] + 1, cen_r, cen_c], dim=-1
    )
    return torch.where(valid[..., None], rows, 0).to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _colour_pair(channels: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``(2, *pixel)`` green and red pixels of ``channels``-channel items
    (0: 2-D) in ``dtype`` on ``device``: BGR (0, 255, 0) and (0, 0, 255), 85
    for both on a 2-D item.  Made once on the host (the card has few
    uint16 kernels) and kept, so a call copies nothing to the card."""

    return torch.stack([_as_color(channels, c).to(dtype) for c in (_GREEN, _RED)]).to(device)


def _colours(imgs: torch.Tensor) -> torch.Tensor:
    return _colour_pair(0 if imgs.ndim == 3 else imgs.shape[-1], imgs.dtype, imgs.device)


def region_annotate_plain(imgs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`region_annotate`: the outline and disk pixels
    of every region (:func:`.annotate.rect_border`, :func:`.annotate.draw_disk`)
    scattered as paint keys with ``amax``, then the colours."""

    n, h, w = imgs.shape[:3]
    nseg = boxes.shape[1]
    flat = boxes.reshape(-1, ANNOTATION_BOX).to(torch.int64)
    g = torch.nonzero(flat[:, 0] != 0).reshape(-1)
    g = g[g % nseg != 0]
    frame, lab, b = g // nseg, g % nseg, flat[g]
    k1, p1 = rect_border(b[:, 2], b[:, 1], b[:, 4], b[:, 3], h, w)
    k2, p2 = draw_disk(b[:, 6], b[:, 5], 3, h, w)
    keys = torch.zeros(n * h * w, dtype=torch.int64, device=imgs.device)
    at = torch.cat([frame[k1] * (h * w) + p1, frame[k2] * (h * w) + p2])
    keys.scatter_reduce_(0, at, torch.cat([2 * lab[k1], 2 * lab[k2] + 1]), "amax")
    keys = keys.reshape(n, h, w)
    # uint16 through int32: the card has no uint16 where
    work = imgs.to(torch.int32) if imgs.dtype == torch.uint16 else imgs
    green, red = _colours(imgs).to(work.dtype)
    if imgs.ndim == 4:
        keys = keys[..., None]
    return torch.where(keys == 0, work, torch.where(keys % 2 == 1, red, green)).to(imgs.dtype)


def region_annotate(imgs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Each region's two nested bbox outlines in green and its radius-3
    centroid disk in red (gray 85 for both on a 2-D item), painted over a
    batch ``(N, H, W)`` or ``(N, H, W, 3)`` of items of any dtype in the
    reference's order (``region_annotate_j``); ``boxes`` from
    :func:`annotation_boxes`.

    On the card (kernel D, for ``region_annotate_j``,
    ``yamimageprocessor_tpu/ops/extraction_device.py:90``) the bound is the
    image read and written once.  Three launches: the image's bytes copied
    with 16-byte loads and stores and, in the same launch, the int32 key
    plane (``torch.empty``: nothing is cleared between calls) zeroed only
    at the pixels the paint touches; the paint, the largest key by
    ``atomicMax`` (the reference's last painter); the colour pass, a pixel
    written where the plane holds the walker's own key.  No launch reads or
    writes the plane elsewhere."""

    if not _build.on_card("region_annotate", imgs):
        return region_annotate_plain(imgs, boxes)
    if imgs.ndim not in (3, 4) or (imgs.ndim == 4 and imgs.shape[-1] != 3) or not imgs.is_contiguous():
        raise ValueError(f"region_annotate takes contiguous (N, H, W) or (N, H, W, 3), got {tuple(imgs.shape)}")
    n, h, w = imgs.shape[:3]
    nseg = boxes.shape[1]
    if boxes.shape != (n, nseg, ANNOTATION_BOX) or boxes.dtype != torch.int32 or not boxes.is_contiguous():
        raise ValueError(f"region_annotate: boxes must be contiguous ({n}, nseg, {ANNOTATION_BOX}) int32")
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    keys = torch.empty((n, h, w), dtype=torch.int32, device=imgs.device)
    colours = _colours(imgs)
    pixel_bytes = colours[0].numel() * colours.element_size()
    _build.launch(
        "yam_annotate", imgs.device, imgs.data_ptr(), boxes.data_ptr(), keys.data_ptr(), out.data_ptr(),
        colours.data_ptr(), n, h, w, pixel_bytes, nseg,
    )
    region_annotate.launches += 1
    return out


region_annotate.launches = 0


def check_paintable(name: str, imgs: torch.Tensor, painted=lambda: True) -> None:
    """The painting chains paint gray or BGR items: items of any other
    channel count raise ``ValueError`` where ``painted()`` says something
    is painted, as the reference's paint does (its colour of 3 values does
    not broadcast over the pixels)."""

    if imgs.ndim == 4 and imgs.shape[-1] != 3 and painted():
        raise ValueError(f"{name} paints gray or BGR items, got {imgs.shape[-1]} channels")


def region_properties_device_fn(imgs: torch.Tensor, dyn) -> torch.Tensor:
    """Batch of images -> annotated images, on the images' device."""

    _, box, sums, _ = labeled_measurements(imgs)
    boxes = annotation_boxes(box, sums)
    if imgs.ndim == 4 and imgs.shape[-1] != 3:  # items left unchanged where nothing is painted
        check_paintable("extraction.region_properties", imgs, lambda: bool(boxes[..., 0].any()))
        return imgs.clone(memory_format=torch.contiguous_format)
    return region_annotate(imgs.contiguous(), boxes)


# ---------------------------------------------------------------------------
# the per-region table


def region_pack(labels: torch.Tensor, nseg: int) -> torch.Tensor:
    """The device half of the table: ``(N, nseg, 14)`` int64 rows of the
    inclusive bbox, the 9 sums of :func:`.regionprops.region_scan` and the
    hull pixel area, for labels whose largest is below ``nseg``."""

    box, sums, (mn, mx) = measure(labels, nseg)
    hull = RP.hull_pixel_areas(mn, mx, box[..., 0].contiguous(), box[..., 2].contiguous(), labels.shape[2])
    return torch.cat([box.to(torch.int64), sums, hull[..., None]], dim=-1)


def _finalize_region_table(pack: np.ndarray, count: int) -> Dict:
    """``{"meas": RegionMeasurements, "solidity": ...}`` of one frame from
    its ``(count + 1, 14)`` int64 pack (region 0 is zeros)."""

    pack = pack.copy()
    pack[0] = 0
    box, sums, hull = pack[:, _BOX], pack[:, _SUMS], pack[:, _HULL]
    area_i = sums[:, RP.AREA]
    area = area_i.astype(np.float64)
    safe = np.maximum(area, 1.0)
    sa, sb = sums[:, RP.SUM_A].astype(np.float64), sums[:, RP.SUM_B].astype(np.float64)
    # a and b are twice the offsets from the bbox centre: Sum r = (sr2 * area
    # + Sum a) / 2, exact integers, so the centroid is one rounding
    cen_r = ((box[:, 0] + box[:, 2]) * area_i + sums[:, RP.SUM_A]).astype(np.float64) / (2.0 * safe)
    cen_c = ((box[:, 1] + box[:, 3]) * area_i + sums[:, RP.SUM_B]).astype(np.float64) / (2.0 * safe)
    bbox = np.stack([box[:, 0], box[:, 1], box[:, 2] + 1, box[:, 3] + 1], axis=1).astype(np.int64)
    bbox[0] = 0
    weights = np.asarray(RP.PERIMETER_WEIGHTS)
    meas = RP.RegionMeasurements(
        count=count,
        area=area,
        centroid_r=np.where(area > 0, cen_r, 0.0),
        centroid_c=np.where(area > 0, cen_c, 0.0),
        bbox=bbox,
        # central moments by the shift identity: Sum d^2 - (Sum d)^2 / area,
        # d = a / 2 about the bbox centre
        mu20=(sums[:, RP.SUM_AA] - sa * sa / safe) / 4.0,
        mu02=(sums[:, RP.SUM_BB] - sb * sb / safe) / 4.0,
        mu11=(sums[:, RP.SUM_AB] - sa * sb / safe) / 4.0,
        perimeter=sums[:, RP.N1] * weights[0] + sums[:, RP.N2] * weights[1] + sums[:, RP.N3] * weights[2],
    )
    solidity = np.zeros(count + 1, dtype=np.float64)
    solidity[1:] = area[1:] / np.maximum(hull[1:].astype(np.float64), 1.0)
    return {"meas": meas, "solidity": solidity}


class _TableCache:
    """Finished region tables keyed by source content token (the
    reference's result-cache short-circuit): an unchanged source
    re-extracts without touching the device.  At most :attr:`CAP`
    entries, least recently used dropped first; treat entries as
    immutable."""

    CAP = 256

    def __init__(self) -> None:
        self._entries: "OrderedDict[object, Dict]" = OrderedDict()

    def get(self, token):
        entry = self._entries.get(token)
        if entry is not None:
            self._entries.move_to_end(token)
        return entry

    def put(self, token, table: Dict) -> None:
        self._entries[token] = table
        self._entries.move_to_end(token)
        while len(self._entries) > self.CAP:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


_TABLE_CACHE = _TableCache()

# Above this size a plain array is not hashed for the memo: hashing would
# cost more than the extraction it could skip.
_HASH_TOKEN_MAX_BYTES = 32 * 1024 * 1024

# content fingerprint: two independent multiply-sum accumulators over
# tiled random odd uint64 coefficients, combined across 1-MiB chunks as a
# polynomial in a per-accumulator odd constant; a 128-bit
# non-cryptographic token
_FP_BLOCK = 1 << 17  # uint64 lanes: a 1 MiB period
_FP_MULT1 = np.uint64(0x9E3779B97F4A7C15)
_FP_MULT2 = np.uint64(0xC2B2AE3D27D4EB4F)
_FP_VECS: Optional[tuple] = None


def _fp_vectors() -> tuple:
    global _FP_VECS
    if _FP_VECS is None:
        rng = np.random.default_rng(0x59414D5F545055)
        _FP_VECS = (
            rng.integers(1, 1 << 62, _FP_BLOCK, dtype=np.uint64) << 1 | 1,
            rng.integers(1, 1 << 62, _FP_BLOCK, dtype=np.uint64) << 1 | 1,
        )
    return _FP_VECS


def _content_fingerprint(arr: np.ndarray) -> tuple:
    flat = arr.view(np.uint8).reshape(-1)
    pad = (-flat.size) % 8
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    x = flat.view(np.uint64)
    a, b = _fp_vectors()
    h1 = np.uint64(0)
    h2 = np.uint64(0)
    with np.errstate(over="ignore"):
        for off in range(0, x.size, _FP_BLOCK):
            chunk = x[off : off + _FP_BLOCK]
            k = chunk.size
            h1 = h1 * _FP_MULT1 + (chunk * a[:k]).sum(dtype=np.uint64)
            h2 = h2 * _FP_MULT2 + (chunk * b[:k]).sum(dtype=np.uint64)
    return int(h1), int(h2), flat.size


def _frame_token(frame) -> object | None:
    """Content token of a source frame: the record's own cache token when
    it has one, else a 128-bit fingerprint of the pixel bytes; None (not
    memoized) for a plain array above :data:`_HASH_TOKEN_MAX_BYTES`."""

    fn = getattr(frame, "cache_token", None)
    if callable(fn):
        try:
            token = fn()
            hash(token)
            return ("record", token)
        except Exception:  # noqa: BLE001 - a broken token means hashing the bytes
            pass
    if getattr(frame, "nbytes", 0) > _HASH_TOKEN_MAX_BYTES:
        return None
    arr = np.ascontiguousarray(frame)
    return ("fp128", _content_fingerprint(arr), arr.shape, arr.dtype.str)


def region_tables(frames: Sequence, *, device="cuda") -> List[Dict]:
    """Per-region tables of a list of frames (gray ``(H, W)`` or BGR
    ``(H, W, C)``): ``{"meas": RegionMeasurements, "solidity": (n+1,)}``
    each, region 0 unused.  Frames of one shape and dtype go up as one
    batch; the label maxima of every batch come back in one read, size
    every per-region buffer, and the packed results of every batch come
    back in a second.  A frame whose content token is memoized is not
    computed again."""

    dev = torch.device(device)
    tokens = [_frame_token(f) for f in frames]
    tables: List[Optional[Dict]] = [None if t is None else _TABLE_CACHE.get(t) for t in tokens]
    groups: Dict[tuple, List[int]] = {}
    for i, frame in enumerate(frames):
        if tables[i] is None:
            arr = np.asarray(frame)
            groups.setdefault((arr.shape, arr.dtype.str), []).append(i)
    if not groups:
        return tables
    batches = []
    for members in groups.values():
        x = torch.from_numpy(np.stack([np.asarray(frames[i]) for i in members])).to(dev)
        batches.append((members, region_labels(x)))
    maxima = torch.cat(
        [lab.amax(dim=(1, 2)) if lab.numel() else lab.new_zeros(lab.shape[0]) for _, lab in batches]
    ).cpu()
    counts: Dict[int, int] = {}
    packs, shapes = [], []
    start = 0
    for members, labels in batches:
        group_max = maxima[start : start + len(members)]
        start += len(members)
        counts.update({i: int(c) for i, c in zip(members, group_max)})
        nseg = int(group_max.max()) + 1
        if nseg == 1:
            continue
        packs.append(region_pack(labels, nseg).reshape(-1))
        shapes.append((members, nseg))
    flat = torch.cat(packs).cpu().numpy() if packs else np.zeros(0, np.int64)
    start = 0
    for members, nseg in shapes:
        block = flat[start : start + len(members) * nseg * (_HULL + 1)].reshape(len(members), nseg, _HULL + 1)
        start += block.size
        for k, i in enumerate(members):
            tables[i] = _finalize_region_table(block[k, : counts[i] + 1], counts[i])
    for i in counts:
        if tables[i] is None:  # a batch without regions
            tables[i] = _finalize_region_table(np.zeros((1, _HULL + 1), np.int64), 0)
        if tokens[i] is not None:
            _TABLE_CACHE.put(tokens[i], tables[i])
    return tables


def region_table(img, *, device="cuda") -> Dict:
    """:func:`region_tables` of one frame."""

    return region_tables([img], device=device)[0]


def clear_table_cache() -> None:
    """Drop every memoized table."""

    _TABLE_CACHE.clear()


__all__ = [
    "ANNOTATION_BOX",
    "annotation_boxes",
    "binary",
    "clear_table_cache",
    "labeled_measurements",
    "measure",
    "region_annotate",
    "region_annotate_plain",
    "region_count_bound",
    "region_labels",
    "region_pack",
    "check_paintable",
    "region_properties_device_fn",
    "region_table",
    "region_tables",
]
