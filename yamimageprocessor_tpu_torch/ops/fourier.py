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


class LinesLaunch:
    """The lines' buffers and launch on the card (kernel 2 of
    ``csrc/shape.cu``), shared by :func:`fourier_lines` and by timers, so
    that both run the same device work: building it validates the
    arguments and allocates; :meth:`run` is a call's device work, one C
    call of three launches, into the same buffers."""

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
        self.points, self.num_coeff, self.longest = points, int(num_coeff), max(lengths, default=0)
        dev = points.device
        self.coeffs = torch.empty((self.line_offsets[-1], 2), dtype=torch.float64, device=dev)
        self.recon = torch.empty((offsets[-1], 2), dtype=torch.float64, device=dev)
        self.table = torch.empty((offsets[-1], 2), dtype=torch.float64, device=dev)
        self.offsets = torch.tensor(offsets, dtype=torch.int64).to(dev)
        self.lines = torch.tensor(self.line_offsets, dtype=torch.int64).to(dev)

    @property
    def launching(self) -> bool:
        return len(self.ks) > 0 and self.points.shape[0] > 0

    def run(self) -> None:
        if self.launching:
            _build.launch(
                "yam_fourier_lines", self.points.device, self.points.data_ptr(), self.offsets.data_ptr(),
                self.lines.data_ptr(), self.table.data_ptr(), self.coeffs.data_ptr(), self.recon.data_ptr(),
                len(self.ks), self.num_coeff, self.longest,
            )


def fourier_lines(points: torch.Tensor, offsets: Sequence[int], num_coeff: int):
    """``(coeffs, line_offsets, recon)`` of the contours
    ``points[offsets[f]:offsets[f + 1]]`` (int32 ``(x, y)``): ``coeffs``
    ``(sum 2k, 2)`` float64 ``(re, im)``, contour ``f``'s ``2k`` lines at
    ``line_offsets[f]``; ``recon`` ``(P, 2)`` float64, the reconstruction
    beside each point.

    On the card (kernel 2 of ``csrc/shape.cu``, for ``fourier_dft_j``,
    ``yamimageprocessor_tpu/ops/extraction_device.py:254``;
    :class:`LinesLaunch`): three launches over (contour, chunk), so a long
    contour spreads over the card: the twiddle table (``sincospi(2r /
    n)``), a warp a line over the points, a thread a point reconstructed
    from the kept lines staged in shared memory.  Only the ``2k`` lines of
    the ``n`` are formed, as direct sums: ``2 x 2k x n`` complex
    multiply-adds in FP64 and the ``n`` sincospi, more work than an FFT
    pair (``2 x (n / 2) log2 n`` butterflies) once ``2k`` passes
    ``log2 n``."""

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


__all__ = ["LinesLaunch", "MAX_COEFF", "fourier_lines", "fourier_lines_plain", "line_counts", "twiddles"]
