"""Host-side constructors of filter taps, tables and structuring elements
(the port's copy of part of ``yamimageprocessor_tpu/ops/_kernels.py``).

They run in numpy on the host, in float64 where the reference does, and
feed the device as small dynamic inputs, so a parameter change is a new
value and not new code.  Semantics are OpenCV's (``getGaussianKernel``,
the reference's gamma table, ``getStructuringElement``, the circular
window and colour table of ``bilateralFilter``, ``getDerivKernels`` and
the dense ``Laplacian`` aperture).
"""
from __future__ import annotations

import numpy as np

# Fixed small-aperture Gaussian taps OpenCV uses when sigma <= 0 and
# ksize <= 9 (cv2::getGaussianKernel small_gaussian_tab).
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
    9: np.array([4, 13, 30, 51, 60, 51, 30, 13, 4], dtype=np.float64) / 256.0,
}


def gaussian_sigma_for_ksize(ksize: int) -> float:
    """Default sigma when 0 is requested (cv2.GaussianBlur contract)."""

    return 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8


def gaussian_taps(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """1-D normalized Gaussian taps matching ``cv2.getGaussianKernel``."""

    if ksize <= 0 and sigma > 0:
        ksize = int(round(sigma * 6 + 1)) | 1
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].copy()
    sigma_x = sigma if sigma > 0 else gaussian_sigma_for_ksize(ksize)
    scale = -0.5 / (sigma_x * sigma_x)
    centre = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - centre
    taps = np.exp(scale * x * x)
    return taps / taps.sum()


def gaussian_ksize_for_sigma(sigma: float, depth_is_8u: bool = True) -> int:
    """Automatic aperture when ksize is 0 (cv2.createGaussianFilter)."""

    factor = 3 if depth_is_8u else 4
    return int(round(sigma * factor * 2 + 1)) | 1


def gamma_lut(gamma: float) -> np.ndarray:
    """256-entry gamma table: float64 pow, then truncation to uint8."""

    inv_gamma = 1.0 / float(gamma)
    table = (np.arange(256, dtype=np.float64) / 255.0) ** inv_gamma * 255.0
    return table.astype(np.uint8)


def structuring_element(shape: str, ksize: int) -> np.ndarray:
    """Binary structuring element matching ``cv2.getStructuringElement``
    for the rectangular, elliptical and cross shapes; any other name is a
    full box."""

    name = shape.lower()
    rows = cols = int(ksize)
    if name == "cross":
        el = np.zeros((rows, cols), dtype=np.uint8)
        el[rows // 2, :] = 1
        el[:, cols // 2] = 1
        return el
    if name == "elliptical":
        el = np.zeros((rows, cols), dtype=np.uint8)
        r, c = rows // 2, cols // 2
        inv_r2 = 1.0 / (r * r) if r else 0.0
        for i in range(rows):
            dy = i - r
            if abs(dy) <= r:
                dx = int(np.clip(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)), 0, None))
                j1 = max(c - dx, 0)
                j2 = min(c + dx + 1, cols)
                el[i, j1:j2] = 1
        return el
    return np.ones((rows, cols), dtype=np.uint8)


def bilateral_space_weights(ksize: int, sigma_space: float):
    """(weights, mask) over cv2.bilateralFilter's circular window: radius
    ``max(ksize // 2, 1)``, offsets farther than the radius masked out."""

    radius = max(int(ksize) // 2, 1)
    coeff = -0.5 / (sigma_space * sigma_space)
    dy, dx = np.mgrid[-radius : radius + 1, -radius : radius + 1].astype(np.float64)
    dist = np.sqrt(dx * dx + dy * dy)
    mask = dist <= radius
    weights = np.exp(coeff * (dist * dist)) * mask
    return weights, mask


def bilateral_color_weights(sigma_color: float, channels: int) -> np.ndarray:
    """Colour weights ``exp(-k^2 / (2 sigma^2))`` for every ``k`` a sum of
    ``channels`` absolute differences can take, ``0 .. 256 * channels - 1``."""

    coeff = -0.5 / (sigma_color * sigma_color)
    k = np.arange(256 * channels, dtype=np.float64)
    return np.exp(coeff * k * k)


def deriv_taps(order: int, ksize: int) -> np.ndarray:
    """1-D Sobel derivative taps matching ``cv2.getDerivKernels`` (float64,
    integer-valued): ksize 1 is a 3-tap derivative beside a 1-tap smooth."""

    if ksize == 1:
        if order == 0:
            return np.array([1.0])
        if order == 1:
            return np.array([-1.0, 0.0, 1.0])
        return np.array([1.0, -2.0, 1.0])
    ker = np.zeros(ksize + 1, dtype=np.float64)
    ker[0] = 1.0
    for _ in range(ksize - order - 1):
        old = ker[0]
        for j in range(1, ksize + 1):
            new = ker[j] + ker[j - 1]
            ker[j - 1] = old
            old = new
    for _ in range(order):
        old = -ker[0]
        for j in range(1, ksize + 1):
            new = ker[j - 1] - ker[j]
            ker[j - 1] = old
            old = new
    return ker[:ksize].copy()


def laplacian_kernel(ksize: int) -> np.ndarray:
    """Dense Laplacian aperture (cv2.Laplacian): the sum of the two second
    derivatives, ``outer(smooth, d2) + outer(d2, smooth)``; the 3x3 cross
    at ksize 1."""

    if ksize == 1:
        return np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])
    kx2 = deriv_taps(2, ksize)
    smooth = deriv_taps(0, ksize)
    return np.outer(smooth, kx2) + np.outer(kx2, smooth)


def gabor_kernel(ksize: int, sigma: float, theta: float, lambd: float, gamma: float, psi: float) -> np.ndarray:
    """Real Gabor kernel matching ``cv2.getGaborKernel`` (CV_32F): float64
    math, both axes flipped as cv2 stores ``kernel.at(ymax - y, xmax - x)``,
    then float32."""

    sigma_x = sigma
    sigma_y = sigma / gamma
    c, s = np.cos(theta), np.sin(theta)
    if ksize > 0:
        xmax = ymax = ksize // 2
    else:
        xmax = int(np.ceil(max(abs(3 * sigma_x * c), abs(3 * sigma_y * s))))
        ymax = int(np.ceil(max(abs(3 * sigma_x * s), abs(3 * sigma_y * c))))
    y, x = np.mgrid[-ymax : ymax + 1, -xmax : xmax + 1].astype(np.float64)
    xr = x * c + y * s
    yr = -x * s + y * c
    ex = -0.5 / (sigma_x * sigma_x)
    ey = -0.5 / (sigma_y * sigma_y)
    cscale = 2.0 * np.pi / lambd
    kernel = np.exp(ex * xr * xr + ey * yr * yr) * np.cos(cscale * xr + psi)
    return kernel[::-1, ::-1].astype(np.float32)


__all__ = [
    "bilateral_color_weights",
    "deriv_taps",
    "gabor_kernel",
    "bilateral_space_weights",
    "gamma_lut",
    "gaussian_ksize_for_sigma",
    "gaussian_sigma_for_ksize",
    "gaussian_taps",
    "laplacian_kernel",
    "structuring_element",
]
