"""A numpy model of the Fourier lines' routes on the card
(``csrc/shape.cu``), in the kernel's order, held against ``np.fft.fft`` and
``np.fft.ifft`` (the reference's golden, ``yamimageprocessor_tpu/ops/
shape.py:278``) within the lines' stated tolerances: ``1e-10 * max(1,
max|c|)`` for the lines, ``1e-8`` pixel for the reconstruction, and equal
rounded reconstructions.

The FFT route is a mixed-radix Stockham transform over ``n``'s prime
factors (``ops/fourier.py:radices``: the 2s paired into 4s, then the odd
primes rising): a stage of radix ``R`` after stages of product ``Ns`` writes
output ``o`` as the sum over ``r`` of ``in[j + r n / R]`` times the table's
twiddle ``w^{-+ r e mod n}``, ``e = (j % Ns) n / (Ns R) + q n / R``, the
terms added in ``r`` order; the forward forms all ``n`` lines and keeps
``2k``, the inverse runs over the masked spectrum and divides by ``n``.  A contour too long for a
block's shared memory takes :func:`long_radices` (its small factors
grouped) and each stage first multiplies each input by the stage's twiddle,
then sums it times the R-th roots (on the card each sum is split over a few
lanes and added by shuffles: another order, within the tolerance).  The
direct route sums the ``2k`` lines and the ``n`` points.  Both read their
twiddles from ``ops/fourier.py:twiddles``.

Every ``n`` from 1 to 300, ``n = 11312`` (the 4001-row disk's contour),
the prime 4099, at num_coeff 1, 10 and 512; ``route`` against a count of
each route's multiply-adds (and the FFT's passes over its outputs) made by
running the models; the plan's layout (one block where the route fits
shared memory, else through L2 with the small factors grouped, each stage
a launch of butterflies).  Numpy
and the port's CPU code only.
"""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu_torch.ops import fourier as FO

LINE_TOL = 1e-10
RECON_TOL = 1e-8
#: an H100's opt-in shared memory a block (bytes)
H100_SHARED = 232448


def _table(n: int) -> np.ndarray:
    cos, sin = FO.twiddles(n)
    return cos.numpy() + 1j * sin.numpy()


def fft_model(z: np.ndarray, inverse: bool, table: np.ndarray, counter: list, stages=None,
              butterflies: bool = False) -> np.ndarray:
    """The kernel's Stockham stages (without the inverse's 1/n), by
    default ``radices(n)``; counts each stage's multiply-adds into
    counter[0] and its pass over the outputs into counter[1].  A block's
    stage (``butterflies`` False) reads one table twiddle a term, ``r e mod
    n``; a long contour's (True) first multiplies each input by the stage's
    twiddle ``r (j % Ns) n / (Ns R)``, then sums it times the R-th roots
    ``(q r mod R) n / R``."""

    n = len(z)
    src = z.astype(np.complex128)
    w = table if inverse else np.conj(table)
    ns = 1
    o = np.arange(n)
    for radix in FO.radices(n) if stages is None else stages:
        nr = n // radix
        jm, q = o % ns, (o // ns) % radix
        j = (o // (ns * radix)) * ns + jm
        e = jm * (n // (ns * radix)) + q * nr
        acc = np.zeros(n, np.complex128)
        idx = np.zeros(n, np.int64)
        for r in range(radix):
            if butterflies:
                acc = acc + (src[j + r * nr] * w[r * jm * (n // (ns * radix))]) * w[(q * r % radix) * nr]
            else:
                acc = acc + src[j + r * nr] * w[idx]
                idx = (idx + e) % n
        counter[0] += n * radix
        counter[1] += n
        src = acc
        ns *= radix
    return src


def lines_model(z: np.ndarray, num_coeff: int, which: str, counter: list):
    """(the 2k lines, the reconstruction) by one route, as the kernel forms
    them; counts the complex multiply-adds of one way into counter."""

    n = len(z)
    k = min(num_coeff, n)
    table = _table(n)
    m = np.concatenate([np.arange(k), n - k + np.arange(k)])
    keep = (np.arange(n) < k) | (np.arange(n) >= n - k)
    if which == "fft":
        spectrum = fft_model(z, False, table, counter)
        masked = np.where(keep, spectrum, 0)
        return spectrum[m], fft_model(masked, True, table, [0, 0]) / n
    lines = np.array([np.dot(z, np.conj(table[(mm * np.arange(n)) % n])) for mm in m])
    counter[0] += 2 * k * n
    twice = (np.arange(2 * k) >= k) & (np.arange(2 * k) - k < 2 * k - n)  # a line in both halves once
    kept = np.where(twice, 0, lines)
    recon = np.array([np.dot(kept, table[(m * j) % n]) for j in range(n)]) / n
    return lines, recon


def _golden(z: np.ndarray, num_coeff: int):
    coeffs = np.fft.fft(z)
    n = len(coeffs)
    k = min(num_coeff, n)
    kept = np.zeros(n, complex)
    kept[:k] = coeffs[:k]
    kept[-k:] = coeffs[-k:]
    return np.concatenate([coeffs[:k], coeffs[-k:]]), np.fft.ifft(kept)


def _contour(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    xy = rng.integers(0, 4096, (n, 2))
    return xy[:, 0] + 1j * xy[:, 1]


def _check(z: np.ndarray, num_coeff: int, which: str) -> None:
    lines, recon = lines_model(z, num_coeff, which, [0, 0])
    want_lines, want_recon = _golden(z, num_coeff)
    assert np.abs(lines - want_lines).max() <= LINE_TOL * max(1.0, np.abs(want_lines).max())
    got = np.stack([recon.real, recon.imag], 1)
    want = np.stack([want_recon.real, want_recon.imag], 1)
    assert np.abs(got - want).max() <= RECON_TOL
    assert np.array_equal(np.rint(got), np.rint(want))


@pytest.mark.parametrize("num_coeff", [1, 10, 512])
def test_fft_route_matches_numpy_for_every_n_to_300(num_coeff):
    for n in range(1, 301):
        _check(_contour(n), num_coeff, "fft")


@pytest.mark.parametrize("num_coeff", [1, 10, 512])
def test_chosen_route_matches_numpy_for_every_n_to_300(num_coeff):
    for n in range(1, 301):
        _check(_contour(n), num_coeff, FO.route(n, num_coeff))


@pytest.mark.parametrize("num_coeff", [1, 10, 512])
@pytest.mark.parametrize("n", [11312, 4099])
def test_long_contours_match_numpy(n, num_coeff):
    z = _contour(n)
    _check(z, num_coeff, FO.route(n, num_coeff))
    if n == 11312:
        _check(z, num_coeff, "fft")


@pytest.mark.parametrize("n", [11312, 9000, 4843, 6144, 10007])
def test_long_contours_grouped_stages_match_numpy(n):
    """A long contour's stages, its small factors grouped up to LONG_RADIX."""

    stages = FO.long_radices(n)
    assert int(np.prod(stages)) == n and all(r <= FO.LONG_RADIX or r in FO.radices(n) for r in stages)
    assert max(stages) <= FO.MAX_LONG_RADIX or FO.route(n, 512) == "direct"
    z = _contour(n)
    table = _table(n)
    got = fft_model(z, False, table, [0, 0], stages, butterflies=True)
    want = np.fft.fft(z)
    assert np.abs(got - want).max() <= LINE_TOL * max(1.0, np.abs(want).max())
    back = fft_model(want, True, table, [0, 0], stages, butterflies=True) / n
    assert np.abs(back - z).max() <= RECON_TOL
    assert FO.long_radices(11312) == [112, 101]


def test_radices_multiply_to_n_with_the_2s_paired():
    for n in range(1, 5000):
        r = FO.radices(n)
        assert int(np.prod(r)) == n and r.count(2) <= 1 and r == [4] * r.count(4) + [2] * r.count(2) + sorted(
            p for p in r if p % 2)
    assert FO.radices(11312) == [4, 4, 7, 101] and FO.radices(4099) == [4099]


@pytest.mark.parametrize("num_coeff", [1, 10, 512])
def test_route_takes_the_cheaper_count(num_coeff):
    """The models' own counts: multiply-adds each way, and the FFT's passes
    over the outputs at STAGE_COST each."""

    for n in list(range(1, 200)) + [288, 1024, 4099, 11312]:
        counts = {}
        for which in ("fft", "direct"):
            counter = [0, 0]
            lines_model(_contour(n), num_coeff, which, counter)
            counts[which] = counter
        assert (counts["fft"][0], counts["direct"][0]) == FO.route_macs(n, num_coeff)
        cost = counts["fft"][0] + FO.STAGE_COST * counts["fft"][1]
        assert (cost, counts["direct"][0]) == FO.route_costs(n, num_coeff)
        assert FO.route(n, num_coeff) == ("fft" if cost < counts["direct"][0] else "direct")
    assert FO.route(11312, 512) == "fft" and FO.route(11312, 10) == "direct" and FO.route(4099, 512) == "direct"
    assert FO.route(288, 10) == "direct" and FO.route(288, 512) == "fft"


def test_square_reconstructs_exactly_on_both_routes():
    """A 2x2 square at k = 1 reconstructs to exact quarters on either
    route: every twiddle is a quarter turn."""

    z = np.array([0, 1, 1 + 1j, 1j])
    _, want = _golden(z, 1)
    for which in ("fft", "direct"):
        _, got = lines_model(z, 1, which, [0, 0])
        assert got.tobytes() == want.tobytes()


def test_plan_puts_what_fits_in_one_block_and_the_rest_through_l2():
    lengths = [288, 1, 4842, 4843, 11312, 9000, 9697, 0]  # 9697 is prime
    p = FO.plan(lengths, 512, H100_SHARED)
    assert p["routes"][:7] == ["fft"] * 6 + ["direct"]
    assert p["block"] == [0, 1, 2] and p["long_fft"] == [3, 4, 5] and p["long_direct"] == [6]
    assert p["shared"] == 48 * 4842 <= H100_SHARED
    assert p["stages"] == max(len(FO.long_radices(n)) for n in lengths[3:6])
    p = FO.plan(lengths, 10, H100_SHARED)
    assert p["routes"][4] == "direct" and 4 in p["long_direct"]
    assert all(FO.block_bytes(lengths[f], 10, p["routes"][f] == "fft") <= H100_SHARED for f in p["block"])
    for f, row in enumerate(p["rows"]):
        rad = [] if p["routes"][f] == "direct" else FO.radices(lengths[f]) if f in p["block"] else \
            FO.long_radices(lengths[f])
        assert len(row) == FO.PLAN and row[:2 + len(rad)] == [int(p["routes"][f] == "fft"), len(rad), *rad]
