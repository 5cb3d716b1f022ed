"""8-connected component labeling: the CUDA kernel ``csrc/labeling.cu``
and its plain version.

Port of ``yamimageprocessor_tpu/ops/labeling.py`` (``label_j``,
``_renumber`` / ``_rank_spread``, ``label_seeds_j``) and of the Pallas
solver ``ops/labeling_pallas.py:cc_pallas`` behind them on a TPU.

:func:`cc_min_index` gives every foreground pixel the minimum flat index
(within its frame) of its 8-connected component, and background
:data:`SENTINEL`.  That fixed point is unique, so the kernel's union-find,
the plain version's propagation and the reference's block solver agree
bit for bit whatever their schedules.  :func:`label` renumbers it
compactly in raster order of first occurrence (``cumsum`` of the roots,
then a gather; integers, exact in any order), int32 throughout.

:func:`label_seeds` gives watershed markers: ``min index + 2`` on the
foreground and 1 elsewhere, the reference's TPU form
(``labeling.py:270-274``).  Its CPU form is ``label + 1``; the two differ
by an injective relabeling, and the flood's painted output depends only on
which labels are distinct, so either gives the same watershed output.  The
``+ 2`` form needs no renumbering.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from yamimageprocessor_tpu_torch import _build

SENTINEL = 1 << 30
#: the kernel's tile (``csrc/labeling.cu``: TILE_ROWS, TILE_COLS), checked there
TILE_ROWS, TILE_COLS = 32, 64


def _frame_index(shape, device) -> torch.Tensor:
    h, w = shape[-2], shape[-1]
    return torch.arange(h * w, dtype=torch.int32, device=device).reshape(h, w)


def cc_min_index_plain(fg: torch.Tensor) -> torch.Tensor:
    """Plain version: neighbour-min over the 8 neighbours plus pointer
    jumping (``lab = lab[lab]``, which stays inside the component), until
    nothing changes."""

    fg = fg != 0
    n, h, w = fg.shape
    lab = torch.where(fg, _frame_index(fg.shape, fg.device), SENTINEL)
    while True:
        p = F.pad(lab, (1, 1, 1, 1), value=SENTINEL)
        m = lab
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                m = torch.minimum(m, p[:, dy : dy + h, dx : dx + w])
        m = torch.where(fg, m, SENTINEL)
        flat = m.reshape(n, -1)
        jumped = torch.gather(flat, 1, torch.where(flat == SENTINEL, 0, flat).long())
        m = torch.where(fg, torch.minimum(m, jumped.reshape(n, h, w)), SENTINEL)
        if torch.equal(m, lab):
            return lab
        lab = m


def cc_min_index(fg: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 masks (!= 0 is foreground) -> ``(N, H, W)``
    int32: the minimum flat index of each pixel's component, background
    :data:`SENTINEL`."""

    if not _build.on_card("cc_min_index", fg):
        return cc_min_index_plain(fg)
    if fg.dtype != torch.uint8 or fg.ndim != 3 or not fg.is_contiguous():
        raise ValueError(f"cc_min_index takes contiguous (N, H, W) uint8, got {tuple(fg.shape)} {fg.dtype}")
    n, h, w = fg.shape
    if h * w >= SENTINEL:
        raise ValueError(f"cc_min_index takes frames below {SENTINEL} pixels, got {h}x{w}")
    lab = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    if fg.numel() == 0:
        return lab
    # a flag a tile: which tiles the border merges relinked
    dirty = torch.empty(n * -(-h // TILE_ROWS) * -(-w // TILE_COLS), dtype=torch.uint8, device=fg.device)
    _build.launch(
        "yam_cc_min_index", fg.device, fg.data_ptr(), lab.data_ptr(), dirty.data_ptr(), n, h, w, TILE_ROWS, TILE_COLS
    )
    cc_min_index.launches += 1
    return lab


cc_min_index.launches = 0


def _as_mask(fg: torch.Tensor) -> torch.Tensor:
    """A uint8 0/1 copy of a boolean mask (the kernel reads bytes)."""

    return fg.to(torch.uint8).contiguous()


def renumber(lab: torch.Tensor) -> torch.Tensor:
    """Compact raster-first labels (1, 2, ... in order of first
    occurrence, 0 for background) from a min-index field, int32."""

    n = lab.shape[0]
    flat = lab.reshape(n, -1)
    fg = flat != SENTINEL
    is_root = fg & (flat == _frame_index(lab.shape, lab.device).reshape(1, -1))
    rank = torch.cumsum(is_root.to(torch.int32), dim=1, dtype=torch.int32)
    out = torch.gather(rank, 1, torch.where(fg, flat, 0).long())
    return torch.where(fg, out, 0).reshape(lab.shape)


def label(fg: torch.Tensor) -> torch.Tensor:
    """Compact raster-first int32 labels of ``(N, H, W)`` boolean masks."""

    return renumber(cc_min_index(_as_mask(fg)))


def label_seeds(fg: torch.Tensor) -> torch.Tensor:
    """Distinct positive seed labels of ``(N, H, W)`` boolean masks:
    ``min index + 2`` on the foreground, 1 elsewhere (int32)."""

    lab = cc_min_index(_as_mask(fg))
    return torch.where(fg, lab + 2, 1).to(torch.int32)


__all__ = [
    "SENTINEL",
    "TILE_COLS",
    "TILE_ROWS",
    "cc_min_index",
    "cc_min_index_plain",
    "label",
    "label_seeds",
    "renumber",
]
