"""Outer contours of every labelled region of a batch (the port of
``yamimageprocessor_tpu/ops/shape.py:107`` ``trace_external_contours``,
which walks each region on the host in Python).

:func:`trace_contours` takes the ``(B, H, W)`` int32 compact raster-first
labels of :func:`.extraction_device.region_labels` (the reference labels
the same mask with ``label_np``, whose numbering is the same) and returns
every region's boundary, in label order, which is the reference's list
order:

- ``points``: ``(P, 2)`` int32 ``(x, y)``, the contours one after another;
- ``offsets``: ``(R + 1,)`` int64, contour ``r`` is
  ``points[offsets[r]:offsets[r + 1]]``;
- ``frames``: ``(R,)`` int64, the frame of each contour;
- ``area2``: ``(R,)`` int64, each contour's doubled shoelace area, exact,
  which is ``2 * contour_area`` of the reference's points bit for bit
  (every float64 product and sum of ``contour_area`` is an exact integer).

On the card it is the pointer-jumping trace of ``csrc/contour.cu``; on
the CPU its plain version, :func:`trace_contours_plain`, a lock-step walk in
plain torch: at each step every region still walking reads its 8
neighbours, takes the first of its own clockwise after the backtrack
direction, applies Jacob's stop and the ``8 * (pixels + 1)`` step bound,
so the walk costs O(longest contour) torch operations, not a Python loop
a pixel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from yamimageprocessor_tpu_torch import _build

#: Moore directions 0..7 clockwise from up: (dy, dx)
MOORE = ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1))
_INT32_MAX = 2**31 - 1


class Contours(NamedTuple):
    points: torch.Tensor  # (P, 2) int32 (x, y)
    offsets: torch.Tensor  # (R + 1,) int64
    frames: torch.Tensor  # (R,) int64
    area2: torch.Tensor  # (R,) int64


def _seeds(labels: torch.Tensor, nseg: int):
    """(start, pixels): every ``(frame, label)`` slot's raster-first flat
    pixel index (``_INT32_MAX`` where the frame lacks the label) and its
    pixel count, int64 ``(n * nseg,)``."""

    n, h, w = labels.shape
    flat = labels.reshape(n, -1).to(torch.int64)
    fg = flat > 0
    slot = (torch.arange(n, device=labels.device)[:, None] * nseg + flat)[fg]
    pos = torch.arange(h * w, device=labels.device).expand(n, -1)[fg]
    start = torch.full((n * nseg,), _INT32_MAX, dtype=torch.int64, device=labels.device)
    start.scatter_reduce_(0, slot, pos, "amin")
    pixels = torch.zeros(n * nseg, dtype=torch.int64, device=labels.device)
    pixels.index_add_(0, slot, torch.ones_like(slot))
    return start, pixels


def _first_direction(padded: torch.Tensor, frame, region, y, x, prev):
    """The first direction of ``region``'s pixels clockwise after ``prev``
    around ``(y, x)`` (frame coordinates; ``padded`` has a border of 0),
    -1 where there is none."""

    order = (prev[:, None] + 1 + torch.arange(8, device=y.device)) % 8
    dy = torch.tensor([d[0] for d in MOORE], device=y.device)[order]
    dx = torch.tensor([d[1] for d in MOORE], device=y.device)[order]
    hits = padded[frame[:, None], y[:, None] + 1 + dy, x[:, None] + 1 + dx] == region[:, None]
    k = (hits.to(torch.int32).cumsum(1) == 0).sum(1)  # leading misses
    return torch.where(k < 8, order.gather(1, k.clamp(max=7)[:, None])[:, 0], -1)


def _step(d: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    dy = torch.tensor([m[0] for m in MOORE], device=d.device)
    dx = torch.tensor([m[1] for m in MOORE], device=d.device)
    dd = d.clamp(min=0)
    return y + dy[dd], x + dx[dd]


def _assemble(owner, ys, xs, frames: torch.Tensor) -> Contours:
    """Points emitted as ``(owner, y, x)`` in step order -> the contours of
    regions ``0..len(frames) - 1`` in region order, with their offsets and
    doubled areas."""

    r, device = len(frames), frames.device
    order = torch.sort(owner, stable=True).indices
    owner, ys, xs = owner[order], ys[order], xs[order]
    counts = torch.bincount(owner, minlength=r)
    offsets = torch.zeros(r + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(counts, 0)
    at = torch.arange(len(owner), device=device)
    nxt = torch.where(at + 1 < offsets[owner + 1], at + 1, offsets[owner])
    term = xs * ys[nxt] - ys * xs[nxt]
    area2 = torch.zeros(r, dtype=torch.int64, device=device).index_add_(0, owner, term).abs()
    area2 = torch.where(counts < 3, 0, area2)
    points = torch.stack([xs, ys], dim=1).to(torch.int32)
    return Contours(points, offsets, frames, area2)


def trace_contours_plain(labels: torch.Tensor, nseg: int) -> Contours:
    """Plain version of :func:`trace_contours`: all regions walked in lock
    step with torch operations."""

    n, h, w = labels.shape
    dev = labels.device
    start, pixels = _seeds(labels, nseg)
    slots = torch.nonzero(start < _INT32_MAX).reshape(-1)
    frame, region = slots // nseg, slots % nseg
    sy, sx = start[slots] // w, start[slots] % w
    padded = torch.nn.functional.pad(labels.to(torch.int64), (1, 1, 1, 1))
    ids = torch.arange(len(slots), device=dev)
    owners, ys, xs = [ids], [sy], [sx]
    d = _first_direction(padded, frame, region, sy, sx, torch.full_like(sy, 6))
    live = d >= 0  # an isolated pixel is one point
    fy, fx = _step(d, sy, sx)
    a = torch.nonzero(live).reshape(-1)  # the regions still walking
    cy, cx, prev = fy[a], fx[a], (d[a] + 4) % 8
    steps = torch.zeros_like(a)
    max_steps = 8 * (pixels[slots][a] + 1)
    while len(a):
        at_start = (cy == sy[a]) & (cx == sx[a])
        d = _first_direction(padded, frame[a], region[a], cy, cx, prev)
        ny, nx = _step(d, cy, cx)
        none = d < 0
        back = at_start & ~none & (ny == fy[a]) & (nx == fx[a])  # Jacob's stop
        emit = ~at_start | (~none & ~back)
        owners.append(a[emit])
        ys.append(cy[emit])
        xs.append(cx[emit])
        steps = steps + 1
        go = ~none & ~back & (steps < max_steps)
        a, cy, cx, prev, steps, max_steps = a[go], ny[go], nx[go], (d[go] + 4) % 8, steps[go], max_steps[go]
    return _assemble(torch.cat(owners), torch.cat(ys), torch.cat(xs), frame)


class TraceLaunch:
    """The trace's buffers and launches on the card (``csrc/contour.cu``),
    shared by :func:`trace_contours` and by timers, so that both run the
    same device work.  Building it validates the labels, allocates, runs
    :meth:`states` and sizes the state arrays from their total (the one
    read back before the points), and the points for at most every state's
    pixel and every region's isolated one; :meth:`rank` ranks, :meth:`write`
    writes the points; :meth:`run`, a call's device work into the same
    buffers, is the three in turn.  :meth:`contours` reads which regions
    have points and how many there are, once the work is done."""

    def __init__(self, labels: torch.Tensor, nseg: int):
        if labels.ndim != 3 or labels.dtype != torch.int32 or not labels.is_contiguous():
            raise ValueError(
                f"trace_contours takes contiguous (N, H, W) int32 labels, got {labels.dtype} {tuple(labels.shape)}")
        n, h, w = labels.shape
        dev = labels.device
        wpr = (w + 31) // 32
        self.labels, self.nseg = labels, nseg
        self.start = torch.empty((n, nseg), dtype=torch.int32, device=dev)
        self.mask = torch.empty((n, h, wpr), dtype=torch.int32, device=dev)
        self.keep = torch.empty((n * h * wpr, 32), dtype=torch.uint8, device=dev)
        self.nbr = torch.empty((n * h * wpr, 32), dtype=torch.uint8, device=dev)
        self.wordcount = torch.empty(n * h * wpr, dtype=torch.int32, device=dev)
        self.wordbase = torch.empty(n * h * wpr, dtype=torch.int32, device=dev)
        self.active = torch.empty(n * h * wpr, dtype=torch.int32, device=dev)
        # the kernels clear ctrl (the seeds' first launch) and counts and acc
        # (the ranking) themselves
        self.counts = torch.empty((n, nseg), dtype=torch.int32, device=dev)
        self.acc = torch.empty(n * nseg, dtype=torch.int64, device=dev)
        self.area2 = torch.empty(n * nseg, dtype=torch.int64, device=dev)
        self.offsets = torch.zeros(n * nseg + 1, dtype=torch.int64, device=dev)
        self.ctrl = torch.empty(11, dtype=torch.int32, device=dev)
        if not self.launching:
            self.counts.zero_()
        self.states()
        self.total = int(self.wordbase[-1]) if self.launching else 0
        s = max(self.total, 1)
        self.next0, self.region, self.src, self.entry_flag, self.tgt, self.dist, self.entries, self.ranks = (
            torch.empty(s, dtype=torch.int32, device=dev) for _ in range(8))
        self.dir = torch.empty(s, dtype=torch.uint8, device=dev)
        self.succ = torch.empty(s, dtype=torch.uint8, device=dev)
        self.e0 = torch.empty((s, 2), dtype=torch.int32, device=dev)
        self.e1 = torch.empty((s, 2), dtype=torch.int32, device=dev)
        self.points = torch.empty((self.total + n * nseg if self.launching else 0, 2), dtype=torch.int32,
                                  device=dev)

    @property
    def launching(self) -> bool:
        return self.labels.numel() > 0

    def states(self) -> None:
        """Each region's start, the packed foreground, each boundary
        pixel's kept states, and the scan of the words' state counts."""

        n, h, w = self.labels.shape
        if self.launching:
            _build.launch(
                "yam_contour_seed", self.labels.device, self.labels.data_ptr(), self.start.data_ptr(),
                self.mask.data_ptr(), self.keep.data_ptr(), self.nbr.data_ptr(), self.wordcount.data_ptr(),
                self.active.data_ptr(), self.ctrl.data_ptr(), n, h, w, self.nseg,
            )
            torch.cumsum(self.wordcount, 0, dtype=torch.int32, out=self.wordbase)

    def rank(self) -> None:
        """The links, the ranking (counts and doubled areas) and the scan
        of the counts into the offsets."""

        n, h, w = self.labels.shape
        if self.launching:
            _build.launch(
                "yam_contour_rank", self.labels.device, self.labels.data_ptr(), self.start.data_ptr(),
                self.mask.data_ptr(), self.keep.data_ptr(), self.nbr.data_ptr(), self.wordcount.data_ptr(), self.wordbase.data_ptr(),
                self.active.data_ptr(), self.next0.data_ptr(), self.succ.data_ptr(), self.src.data_ptr(),
                self.dir.data_ptr(),
                self.entry_flag.data_ptr(), self.tgt.data_ptr(), self.dist.data_ptr(), self.entries.data_ptr(),
                self.e0.data_ptr(), self.e1.data_ptr(), self.ranks.data_ptr(), self.region.data_ptr(),
                self.counts.data_ptr(), self.acc.data_ptr(), self.area2.data_ptr(), self.ctrl.data_ptr(),
                self.total, rank_blocks(self.labels.device), n, h, w, self.nseg,
            )
            torch.cumsum(self.counts.reshape(-1), 0, dtype=torch.int64, out=self.offsets[1:])

    def write(self) -> None:
        """Each outer state's pixel at its place in its region's walk."""

        n, h, w = self.labels.shape
        if self.launching:
            _build.launch(
                "yam_contour_write", self.labels.device, self.ranks.data_ptr(), self.region.data_ptr(),
                self.src.data_ptr(), self.start.data_ptr(), self.counts.data_ptr(), self.offsets.data_ptr(),
                self.points.data_ptr(), self.total, n, w, self.nseg,
            )

    def run(self) -> None:
        self.states()
        self.rank()
        self.write()

    def stats(self) -> dict:
        """The last run's state count, entries (states another chunk's
        pointers end at), the most ranking rounds a chunk took in shared
        memory, the entries' rounds, and the ranking's phases' ends in ms
        from its start (the chunks, the entries, the ranks and sums, the
        areas; the card's global timer, a read back)."""

        ctrl = self.ctrl.tolist()
        return {"states": self.total, "entries": ctrl[0], "chunk_rounds": ctrl[1], "entry_rounds": ctrl[2],
                "rank_phase_ends_ms": [t / 1e6 for t in ctrl[6:10]]}

    def contours(self) -> Contours:
        slots = torch.nonzero(self.counts.reshape(-1) > 0).reshape(-1)
        return Contours(self.points[: int(self.offsets[-1])], torch.cat([self.offsets[slots], self.offsets[-1:]]),
                        slots // self.nseg, self.area2[slots])


_RANK_BLOCKS = {}


def rank_blocks(device) -> int:
    """Blocks of the ranking's cooperative launch: as many as the card
    holds at once (the occupancy API), once a device."""

    key = torch.device(device).index
    if key not in _RANK_BLOCKS:
        import ctypes

        blocks = ctypes.c_int(0)
        _build.call("yam_contour_rank_blocks", device, ctypes.byref(blocks))
        _RANK_BLOCKS[key] = blocks.value
    return _RANK_BLOCKS[key]


def trace_contours(labels: torch.Tensor, nseg: int) -> Contours:
    """Every region's outer 8-connected boundary in Moore order (Jacob's
    stop), regions in label order; ``nseg`` is one more than the largest
    label of the batch.

    On the card (``csrc/contour.cu``, for the host walk of
    ``yamimageprocessor_tpu/ops/shape.py:107``; :class:`TraceLaunch`): the
    walk as a cycle of moves, every move's successor formed at once and the
    cycle ranked by pointer jumping.  The seeds (each region's raster-first
    pixel by atomicMin a row run, the foreground packed as bits); each
    boundary pixel's kept states (a move out of it, named by the direction
    it came from, kept where the pixels it comes from and goes to are
    boundary pixels and its search passes a direction that is not the
    region's: the outer walk takes no other), as bit planes a 32-pixel
    word; after a scan of the states' counts and one read of their total,
    each state's move and successor, then one cooperative launch that ranks
    chunks of states in shared memory, then the chunks' entries across the
    grid, and gives each region's point count and doubled area; after the
    scan of the counts, each outer state writes its pixel into points sized
    beforehand for every state and every region's isolated pixel, whose
    total is read once the work is done.  The bound is the label map's
    bytes.
    """

    if not _build.on_card("trace_contours", labels):
        return trace_contours_plain(labels, nseg)
    trace = TraceLaunch(labels, nseg)
    trace.rank()
    trace.write()
    if trace.launching:
        trace_contours.launches += 1
    return trace.contours()


trace_contours.launches = 0


__all__ = ["Contours", "MOORE", "TraceLaunch", "rank_blocks", "trace_contours", "trace_contours_plain"]
