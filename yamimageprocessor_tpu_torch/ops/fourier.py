"""The kept spectral lines of a contour and its truncated reconstruction
(the port of ``fourier_dft_j``, ``yamimageprocessor_tpu/ops/
extraction_device.py:254``, and of the CPU golden ``fourier_reconstruct``,
``ops/shape.py:278``, which is ``np.fft.fft`` and ``ifft`` in float64).

For a contour ``z_j = x_j + i y_j`` of ``n`` points and ``k = min(num_coeff,
n)``, the ``2k`` lines ``m`` in ``[0..k-1, n-k..n-1]`` of ``c_m = sum_j z_j
e^{-2 pi i m j / n}`` (the table keeps both copies of a line in both halves,
as the golden ``concat`` does) and ``recon_j = (1/n) sum_m kept_m e^{+2 pi i
m j / n}`` over the distinct kept lines (the golden ``kept`` array
overwrites, it never adds).  Everything is float64; each angle comes from
the exact integer ``r = (m j) mod n`` as a twiddle ``e^{2 pi i r / n}`` of a
table, reduced by quarter turns, so a power-of-two or quarter-turn angle is
exact and small symmetric contours reconstruct exactly, as pocketfft does.

Tolerance against numpy's FFT (the sums run in another order and the
twiddles round differently): the lines within ``1e-10 * max(1, max|c|)``,
the reconstruction within ``1e-8``; the reference's own accelerator route
is a float32 DFT held to ``2e-4`` and 0.02 pixel.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from yamimageprocessor_tpu_torch import _build

#: the schema's largest num_coeff, and so the most kept lines a contour has
MAX_COEFF = 512


def line_counts(lengths: Sequence[int], num_coeff: int) -> List[int]:
    """``k = min(num_coeff, n)`` of each contour."""

    return [min(int(num_coeff), int(n)) for n in lengths]


def twiddles(n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of ``2 pi r / n`` for ``r < n``, float64: ``4r = q n +
    s`` with ``|s| <= n / 2``, the angle ``(s / n) (pi / 2)`` rotated by ``q``
    quarter turns (exact where ``s`` is 0)."""

    r = torch.arange(n, dtype=torch.int64, device=device)
    q, s = torch.div(4 * r, n, rounding_mode="floor"), (4 * r) % n
    up = 2 * s > n
    q, s = (q + up.to(torch.int64)) % 4, torch.where(up, s - n, s)
    theta = (s.to(torch.float64) / n) * (math.pi / 2)
    c, sn = torch.cos(theta), torch.sin(theta)
    cos = torch.stack([c, -sn, -c, sn])[q, r]
    sin = torch.stack([sn, c, -sn, -c])[q, r]
    return cos, sin


def fourier_lines_plain(points: torch.Tensor, offsets: Sequence[int], num_coeff: int):
    """Plain version of :func:`fourier_lines`: the same sums as float64
    matrix products, a contour at a time."""

    offsets = [int(o) for o in offsets]
    lengths = [b - a for a, b in zip(offsets[:-1], offsets[1:])]
    ks = line_counts(lengths, num_coeff)
    dev = points.device
    coeffs, recon = [], torch.empty((offsets[-1], 2), dtype=torch.float64, device=dev)
    for o, n, k in zip(offsets, lengths, ks):
        z = points[o : o + n].to(torch.float64)
        t = torch.arange(k, device=dev)
        m = torch.cat([t, n - k + t])
        r = (m[:, None] * torch.arange(n, device=dev)[None, :]) % n
        cos, sin = twiddles(n, dev)
        c, s = cos[r], sin[r]
        re = c @ z[:, 0] + s @ z[:, 1]
        im = c @ z[:, 1] - s @ z[:, 0]
        keep = torch.cat([torch.ones(k, dtype=torch.bool, device=dev), t >= 2 * k - n])  # a line once
        kr, ki = torch.where(keep, re, 0.0), torch.where(keep, im, 0.0)
        recon[o : o + n, 0] = (c.T @ kr - s.T @ ki) / n
        recon[o : o + n, 1] = (s.T @ kr + c.T @ ki) / n
        coeffs.append(torch.stack([re, im], dim=1))
    out = torch.cat(coeffs) if coeffs else torch.zeros((0, 2), dtype=torch.float64, device=dev)
    return out, _line_offsets(ks), recon


def _line_offsets(ks: Sequence[int]) -> List[int]:
    out = [0]
    for k in ks:
        out.append(out[-1] + 2 * k)
    return out


#: ints a contour's plan holds on the card: the route (1 FFT), the stage
#: count and up to 32 radices (``csrc/shape.cu``'s ``PLAN``)
PLAN = 34
#: threads of a chunk of a long contour (``csrc/shape.cu``'s ``LONG_THREADS``)
LONG_THREADS = 128
#: a long contour's stage radix at most (``csrc/shape.cu``'s
#: ``MAX_LONG_RADIX``: its shared memory); :func:`route` keeps the FFT's
#: radices below ``2 * MAX_COEFF``
MAX_LONG_RADIX = 1024
#: what a Stockham stage's pass over its n outputs costs besides its
#: multiply-adds (the output's index arithmetic, a barrier), in
#: multiply-adds an output: on an H100 the 32 main-path contours (at most
#: 288 points, num_coeff 10) run faster on the direct sums' 20
#: multiply-adds an output than on the FFT's 16 to 20 in about 5 stages
#: each way (``chip_smoke.py``'s shape phase times each route forced)
STAGE_COST = 4


def radices(n: int) -> List[int]:
    """The FFT route's stages for ``n`` points, in the kernel's order: the
    factors 2 paired into 4s (one 2 left where the count is odd), then the
    odd primes rising; empty for ``n <= 1``."""

    out, m = [], int(n)
    if m <= 1:
        return out
    while m % 4 == 0:
        out.append(4)
        m //= 4
    if m % 2 == 0:
        out.append(2)
        m //= 2
    p = 3
    while p * p <= m:
        while m % p == 0:
            out.append(p)
            m //= p
        p += 2
    if m > 1:
        out.append(m)
    return out


#: a long contour's stage radix at most: its small factors are grouped up to
#: this product (a stage through L2 is a launch of a few microseconds,
#: worth more multiply-adds than a grouped radix adds)
LONG_RADIX = 128


def long_radices(n: int) -> List[int]:
    """The stages of a contour too long for a block: :func:`radices` (rising
    but the 4s first) grouped in order while their product stays within
    :data:`LONG_RADIX`; a factor above it is a stage of its own."""

    out = []
    for p in radices(n):
        if out and out[-1] * p <= LONG_RADIX:
            out[-1] *= p
        else:
            out.append(p)
    return out


def route_macs(n: int, num_coeff: int) -> Tuple[int, int]:
    """(FFT, direct): the complex multiply-adds each way of a contour of
    ``n`` points: ``n * sum(radices)`` (a stage of radix R is n sums of R
    terms), and the direct sums' ``2k n``."""

    return int(n) * sum(radices(n)), 2 * min(int(num_coeff), int(n)) * int(n)


def route_costs(n: int, num_coeff: int) -> Tuple[int, int]:
    """(FFT, direct): each route's cost a way in multiply-adds, the FFT's
    stages each charged :data:`STAGE_COST` an output besides."""

    fft, direct = route_macs(n, num_coeff)
    return fft + STAGE_COST * int(n) * len(radices(n)), direct


def route(n: int, num_coeff: int) -> str:
    """``"fft"`` where its cost is below the direct sums', else
    ``"direct"``."""

    fft, direct = route_costs(n, num_coeff)
    return "fft" if fft < direct else "direct"


def block_bytes(n: int, num_coeff: int, fft: bool) -> int:
    """The shared memory a contour's block needs: the table and two
    buffers of complex doubles (FFT), or the table, the points and the
    ``2k`` lines (direct)."""

    return 48 * int(n) if fft else 24 * int(n) + 32 * min(int(num_coeff), int(n))


_SHARED_LIMIT = {}


def shared_limit(device) -> int:
    """The dynamic shared memory a block may opt into on ``device``, once a
    device."""

    key = torch.device(device).index
    if key not in _SHARED_LIMIT:
        import ctypes

        out = ctypes.c_int(0)
        _build.call("yam_fourier_shared_limit", device, ctypes.byref(out))
        _SHARED_LIMIT[key] = out.value
    return _SHARED_LIMIT[key]


def plan(lengths: Sequence[int], num_coeff: int, limit: int) -> dict:
    """Each contour's route and layout: ``routes`` (``"fft"`` or
    ``"direct"``), ``block`` (the contours whose route fits ``limit``
    bytes of shared memory, one block each; an FFT's stages
    :func:`radices`), ``long_fft`` (stages :func:`long_radices`) and
    ``long_direct`` (the rest, through L2), ``shared`` (the block
    launch's dynamic shared memory), ``stages`` (the most stages of a long
    FFT contour) and ``rows``, each contour's ``PLAN`` ints."""

    routes = [route(n, num_coeff) for n in lengths]
    block, long_fft, long_direct, shared, stages, rows = [], [], [], 0, 0, []
    for f, (n, r) in enumerate(zip(lengths, routes)):
        fits = block_bytes(n, num_coeff, r == "fft") <= limit
        rad = [] if r == "direct" else radices(n) if fits else long_radices(n)
        rows.append([int(r == "fft"), len(rad), *rad] + [0] * (PLAN - 2 - len(rad)))
        if n == 0:
            continue
        if fits:
            block.append(f)
            shared = max(shared, block_bytes(n, num_coeff, r == "fft"))
        elif r == "fft":
            long_fft.append(f)
            stages = max(stages, len(rad))
            assert max(rad) <= MAX_LONG_RADIX, (n, rad)
        else:
            long_direct.append(f)
    return {"routes": routes, "block": block, "long_fft": long_fft, "long_direct": long_direct, "shared": shared,
            "stages": stages, "rows": rows}


class LinesLaunch:
    """The lines' buffers and launch on the card (``csrc/shape.cu``),
    shared by :func:`fourier_lines` and by timers, so that both run the
    same device work: building it validates the arguments, plans each
    contour's route and layout (:func:`plan`) and allocates; :meth:`run`
    is a call's device work, one C call, into the same buffers."""

    def __init__(self, points: torch.Tensor, offsets: Sequence[int], num_coeff: int):
        if not 1 <= int(num_coeff) <= MAX_COEFF:
            raise ValueError(f"num_coeff must lie in 1..{MAX_COEFF}, got {num_coeff}")
        if points.dtype != torch.int32 or points.ndim != 2 or not points.is_contiguous():
            raise ValueError("fourier_lines takes contiguous (P, 2) int32 points")
        offsets = [int(o) for o in offsets]
        if offsets[0] != 0 or offsets[-1] != points.shape[0] or any(b < a for a, b in zip(offsets[:-1], offsets[1:])):
            raise ValueError(f"fourier_lines: offsets must rise from 0 to the {points.shape[0]} points")
        lengths = [b - a for a, b in zip(offsets[:-1], offsets[1:])]
        self.ks = line_counts(lengths, num_coeff)
        self.line_offsets = _line_offsets(self.ks)
        self.points, self.num_coeff = points, int(num_coeff)
        dev = points.device
        self.plan = plan(lengths, num_coeff, shared_limit(dev) if self.launching else 0)
        longs = self.plan["long_fft"] + self.plan["long_direct"]
        self.long_n = max((lengths[f] for f in longs), default=0)
        chunks = -(-self.long_n // LONG_THREADS)
        p = offsets[-1]
        self.coeffs = torch.empty((self.line_offsets[-1], 2), dtype=torch.float64, device=dev)
        self.recon = torch.empty((p, 2), dtype=torch.float64, device=dev)
        self.table = torch.empty((p if longs else 1, 2), dtype=torch.float64, device=dev)
        self.work = torch.empty((2 * p if self.plan["long_fft"] else 1, 2), dtype=torch.float64, device=dev)
        self.partial = torch.empty((max(1, len(self.plan["long_direct"]) * chunks * 2 * self.num_coeff), 2),
                                   dtype=torch.float64, device=dev)
        self.offsets = torch.tensor(offsets, dtype=torch.int64).to(dev)
        self.lines = torch.tensor(self.line_offsets, dtype=torch.int64).to(dev)
        self.rows = torch.tensor(self.plan["rows"] or [[0] * PLAN], dtype=torch.int32).to(dev)
        self.block_ids = torch.tensor(self.plan["block"] or [0], dtype=torch.int32).to(dev)
        self.long_ids = torch.tensor(longs or [0], dtype=torch.int32).to(dev)

    @property
    def launching(self) -> bool:
        return len(self.ks) > 0 and self.points.shape[0] > 0

    def counts(self) -> dict:
        """How many contours take each route and layout."""

        routes = self.plan["routes"]
        return {"fft": routes.count("fft"), "direct": routes.count("direct"), "block": len(self.plan["block"]),
                "long_fft": len(self.plan["long_fft"]), "long_direct": len(self.plan["long_direct"]),
                "long_stages": self.plan["stages"]}

    def run(self) -> None:
        if self.launching:
            _build.launch(
                "yam_fourier_lines", self.points.device, self.points.data_ptr(), self.offsets.data_ptr(),
                self.lines.data_ptr(), self.rows.data_ptr(), self.block_ids.data_ptr(), len(self.plan["block"]),
                self.plan["shared"], self.long_ids.data_ptr(), len(self.plan["long_fft"]),
                len(self.plan["long_direct"]), self.long_n, self.plan["stages"], self.table.data_ptr(),
                self.work.data_ptr(), self.partial.data_ptr(), self.coeffs.data_ptr(), self.recon.data_ptr(),
                self.points.shape[0], self.num_coeff,
            )


def fourier_lines(points: torch.Tensor, offsets: Sequence[int], num_coeff: int):
    """``(coeffs, line_offsets, recon)`` of the contours
    ``points[offsets[f]:offsets[f + 1]]`` (int32 ``(x, y)``): ``coeffs``
    ``(sum 2k, 2)`` float64 ``(re, im)``, contour ``f``'s ``2k`` lines at
    ``line_offsets[f]``; ``recon`` ``(P, 2)`` float64, the reconstruction
    beside each point.

    On the card (``csrc/shape.cu``, for ``fourier_dft_j``,
    ``yamimageprocessor_tpu/ops/extraction_device.py:254``;
    :class:`LinesLaunch`): each contour takes the cheaper of two routes
    (:func:`route`), the direct sums (``2k n`` complex multiply-adds each
    way) or a mixed-radix Stockham FFT over its prime factors (``n
    sum(p_i)``, and a pass over the ``n`` outputs a stage: the forward forms
    all ``n`` lines, the inverse runs over the masked spectrum).  A contour whose route fits a block's shared memory
    takes one block of one launch (the twiddle table, the forward, the mask
    and the inverse in shared memory); a longer one goes through L2 in
    launches over (contour, chunk): the table, then a launch a stage (FFT)
    or the chunks' partial sums and the reconstruction (direct)."""

    if not 1 <= int(num_coeff) <= MAX_COEFF:
        raise ValueError(f"num_coeff must lie in 1..{MAX_COEFF}, got {num_coeff}")
    if not _build.on_card("fourier_lines", points):
        return fourier_lines_plain(points, offsets, num_coeff)
    lines = LinesLaunch(points, offsets, num_coeff)
    lines.run()
    if lines.launching:
        fourier_lines.launches += 1
    return lines.coeffs, lines.line_offsets, lines.recon


fourier_lines.launches = 0


__all__ = [
    "LONG_RADIX", "LONG_THREADS", "LinesLaunch", "MAX_COEFF", "MAX_LONG_RADIX", "PLAN", "STAGE_COST", "block_bytes",
    "fourier_lines", "fourier_lines_plain", "line_counts", "long_radices", "plan", "radices", "route", "route_costs",
    "route_macs", "shared_limit", "twiddles",
]
