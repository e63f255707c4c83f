"""HEALPix grid math in numpy (the port's copy of ``heal_swin_tpu/ops/healpix.py``).

Host-side precompute only: pixel centres, nested/ring conversions and the 4-pixel
bilinear interpolation weights, in int64 / float64, with healpy's conventions (rings
1..4*nside-1 from the north pole; ``nest`` interleaves the (x, y) bits inside each of
the 12 base pixels).  The JAX package switches to a prebuilt C++ library at 2048
pixels and more; that library belongs to the JAX package, so the port always runs
the vectorized numpy path, the one the JAX package runs below that size.
"""

from __future__ import annotations

import numpy as np

# Offsets of the 12 base-pixel centers in the (ring, phi) frame (HEALPix primer)
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(round(np.sqrt(npix / 12.0)))
    if nside2npix(nside) != npix:
        raise ValueError(f"{npix} is not a valid HEALPix npix")
    return nside


def isnsideok(nside: int) -> bool:
    return isinstance(nside, (int, np.integer)) and nside >= 1 and (nside & (nside - 1)) == 0


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread the lower 32 bits of v so bit i lands at position 2*i."""
    v = v.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def _compress_bits(v: np.ndarray) -> np.ndarray:
    """Inverse of _spread_bits: collect even-position bits."""
    v = v.astype(np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v


def nest2xyf(nside: int, pix):
    """Nested pixel index -> (x, y, face)."""
    pix = np.asarray(pix, dtype=np.int64)
    npface = nside * nside
    face = pix // npface
    p = (pix % npface).astype(np.uint64)
    x = _compress_bits(p).astype(np.int64)
    y = _compress_bits(p >> np.uint64(1)).astype(np.int64)
    return x, y, face


def xyf2nest(nside: int, x, y, face):
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    face = np.asarray(face, dtype=np.int64)
    within = (_spread_bits(x) | (_spread_bits(y) << np.uint64(1))).astype(np.int64)
    return face * (nside * nside) + within


def _isqrt(v: np.ndarray) -> np.ndarray:
    """Exact integer sqrt for int64 inputs (float sqrt + correction)."""
    v = np.asarray(v, dtype=np.int64)
    r = np.floor(np.sqrt(v.astype(np.float64) + 0.5)).astype(np.int64)
    r = np.where(r * r > v, r - 1, r)
    r = np.where((r + 1) * (r + 1) <= v, r + 1, r)
    return r


def xyf2ring(nside: int, x, y, face):
    """(x, y, face) -> ring pixel index."""
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    face = np.asarray(face, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    jr = _JRLL[face] * nside - x - y - 1  # ring number, 1 .. 4*nside-1
    north = jr < nside
    south = jr > 3 * nside

    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    kshift = np.where(north | south, 0, (jr - nside) & 1)
    n_before = np.where(
        north,
        2 * nr * (nr - 1),
        np.where(south, npix - 2 * (nr + 1) * nr, ncap + (jr - nside) * 4 * nside),
    )

    jp = (_JPLL[face] * nr + x - y + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def ring2xyf(nside: int, pix):
    """Ring pixel index -> (x, y, face)."""
    pix = np.asarray(pix, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    iring = np.empty_like(pix)
    iphi = np.empty_like(pix)
    kshift = np.empty_like(pix)
    nr = np.empty_like(pix)
    face = np.empty_like(pix)

    north = pix < ncap
    south = pix >= npix - ncap
    eq = ~north & ~south

    if np.any(north):
        p = pix[north]
        ir = (1 + _isqrt(1 + 2 * p)) >> 1
        ip = p + 1 - 2 * ir * (ir - 1)
        iring[north] = ir
        iphi[north] = ip
        kshift[north] = 0
        nr[north] = ir
        face[north] = (ip - 1) // ir

    if np.any(eq):
        p = pix[eq] - ncap
        ir = p // (4 * nside) + nside
        ip = p % (4 * nside) + 1
        ks = (ir + nside) & 1
        ire = ir - nside + 1
        irm = 2 * nside + 2 - ire
        ifm = (ip - ire // 2 + nside - 1) // nside
        ifp = (ip - irm // 2 + nside - 1) // nside
        f = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))
        iring[eq] = ir
        iphi[eq] = ip
        kshift[eq] = ks
        nr[eq] = nside
        face[eq] = f

    if np.any(south):
        p = npix - pix[south]
        ir = (1 + _isqrt(2 * p - 1)) >> 1
        ip = 4 * ir + 1 - (p - 2 * ir * (ir - 1))
        iring[south] = 4 * nside - ir
        iphi[south] = ip
        kshift[south] = 0
        nr[south] = ir
        face[south] = 8 + (ip - 1) // ir

    irt = iring - _JRLL[face] * nside + 1
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    x = (ipt - irt) >> 1
    y = (-ipt - irt) >> 1
    return x, y, face


def nest2ring(nside: int, pix):
    assert isnsideok(nside), "nest scheme requires power-of-two nside"
    x, y, f = nest2xyf(nside, pix)
    return xyf2ring(nside, x, y, f)


def ring2nest(nside: int, pix):
    assert isnsideok(nside), "nest scheme requires power-of-two nside"
    x, y, f = ring2xyf(nside, pix)
    return xyf2nest(nside, x, y, f)


def _xyf2loc(nside: int, x, y, face):
    """(x, y, face) -> (z, phi) of pixel center."""
    npix = nside2npix(nside)
    jr = _JRLL[face] * nside - x - y - 1
    north = jr < nside
    south = jr > 3 * nside

    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    fact2 = 4.0 / npix
    z_cap = 1.0 - nr.astype(np.float64) ** 2 * fact2
    z = np.where(
        north,
        z_cap,
        np.where(south, -z_cap, (2 * nside - jr).astype(np.float64) * (2.0 / (3.0 * nside))),
    )
    kshift = np.where(north | south, 0, (jr - nside) & 1)

    jp = (_JPLL[face] * nr + x - y + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    phi = (jp - (kshift + 1) * 0.5) * (np.pi / 2.0) / nr
    return z, phi


def pix2ang(nside: int, pix, nest: bool = False, lonlat: bool = False):
    """Pixel index -> (theta, phi) of pixel center (colatitude, longitude)."""
    pix = np.asarray(pix, dtype=np.int64)
    x, y, f = nest2xyf(nside, pix) if nest else ring2xyf(nside, pix)
    z, phi = _xyf2loc(nside, x, y, f)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    if lonlat:
        return np.degrees(phi), 90.0 - np.degrees(theta)
    return theta, phi


def pix2vec(nside: int, pix, nest: bool = False):
    """Pixel index -> unit vector (x, y, z), each shaped like ``pix``."""
    theta, phi = pix2ang(nside, pix, nest=nest)
    st = np.sin(theta)
    return st * np.cos(phi), st * np.sin(phi), np.cos(theta)


def _loc2xyf(nside: int, z, phi):
    """(z, phi) -> (x, y, face) of the containing pixel."""
    z = np.asarray(z, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) * (2.0 / np.pi)  # in [0, 4)

    x = np.empty(z.shape, dtype=np.int64)
    y = np.empty(z.shape, dtype=np.int64)
    face = np.empty(z.shape, dtype=np.int64)

    eq = za <= 2.0 / 3.0
    if np.any(eq):
        tte, ze = tt[eq], z[eq]
        temp1 = nside * (0.5 + tte)
        temp2 = nside * (ze * 0.75)
        jp = np.floor(temp1 - temp2).astype(np.int64)  # ascending edge index
        jm = np.floor(temp1 + temp2).astype(np.int64)  # descending edge index
        ifp = jp >> int(np.log2(nside))
        ifm = jm >> int(np.log2(nside))
        f = np.where(ifp == ifm, (ifp & 3) + 4, np.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
        face[eq] = f
        x[eq] = jm & (nside - 1)
        y[eq] = nside - (jp & (nside - 1)) - 1

    pol = ~eq
    if np.any(pol):
        ttp, zp, zap = tt[pol], z[pol], za[pol]
        ntt = np.minimum(ttp.astype(np.int64), 3)
        tp = ttp - ntt
        tmp = nside * np.sqrt(3.0 * (1.0 - zap))
        jp = (tp * tmp).astype(np.int64)
        jm = ((1.0 - tp) * tmp).astype(np.int64)
        jp = np.minimum(jp, nside - 1)
        jm = np.minimum(jm, nside - 1)
        north = zp >= 0
        face[pol] = np.where(north, ntt, ntt + 8)
        x[pol] = np.where(north, nside - jm - 1, jp)
        y[pol] = np.where(north, nside - jp - 1, jm)

    return x, y, face


def ang2pix(nside: int, theta, phi, nest: bool = False):
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    x, y, f = _loc2xyf(nside, np.cos(theta), phi)
    return xyf2nest(nside, x, y, f) if nest else xyf2ring(nside, x, y, f)


def _ring_info(nside: int, ring):
    """Ring number (1..4*nside-1) -> (startpix, ringpix, theta, shifted)."""
    ring = np.asarray(ring, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    northring = np.where(ring > 2 * nside, 4 * nside - ring, ring)

    cap = northring < nside
    tmp = northring.astype(np.float64) ** 2 * (4.0 / npix)
    costheta = 1.0 - tmp
    sintheta = np.sqrt(np.maximum(tmp * (2.0 - tmp), 0.0))
    theta_cap = np.arctan2(sintheta, costheta)
    startpix_cap = 2 * northring * (northring - 1)
    ringpix_cap = 4 * northring

    z_eq = (2 * nside - northring).astype(np.float64) * (2.0 / (3.0 * nside))
    theta_eq = np.arccos(np.clip(z_eq, -1.0, 1.0))
    startpix_eq = ncap + (northring - nside) * 4 * nside
    ringpix_eq = np.full_like(northring, 4 * nside)
    shifted_eq = ((northring - nside) & 1) == 0

    theta = np.where(cap, theta_cap, theta_eq)
    startpix = np.where(cap, startpix_cap, startpix_eq)
    ringpix = np.where(cap, ringpix_cap, ringpix_eq)
    shifted = np.where(cap, True, shifted_eq)

    southern = ring != northring
    theta = np.where(southern, np.pi - theta, theta)
    startpix = np.where(southern, npix - startpix - ringpix, startpix)
    return startpix, ringpix, theta, shifted


def _ring_above(nside: int, z):
    """Largest ring number whose center colatitude is <= the point's (0 if above ring 1)."""
    z = np.asarray(z, dtype=np.float64)
    az = np.abs(z)
    eq_ring = (nside * (2.0 - 1.5 * z)).astype(np.int64)
    cap_ring = (nside * np.sqrt(3.0 * (1.0 - az))).astype(np.int64)
    return np.where(az <= 2.0 / 3.0, eq_ring, np.where(z > 0, cap_ring, 4 * nside - cap_ring - 1))


def _ring_phi_interp(nside: int, ring, phi):
    """Within-ring linear interpolation: two neighbor pixels (ring scheme) + weight."""
    startpix, ringpix, _, shifted = _ring_info(nside, ring)
    dphi = 2.0 * np.pi / ringpix
    tmp = phi / dphi - 0.5 * shifted
    i1 = np.floor(tmp).astype(np.int64)
    w = tmp - i1  # weight of the second pixel
    i2 = i1 + 1
    i1 = np.mod(i1, ringpix)
    i2 = np.mod(i2, ringpix)
    return startpix + i1, startpix + i2, w


def get_interp_weights(nside: int, theta, phi, nest: bool = False):
    """4 neighbor pixels + bilinear weights for each (theta, phi): (pix, wgt), both
    (4, *theta.shape), healpy's ``get_interp_weights`` semantics."""
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    npix = nside2npix(nside)
    z = np.cos(theta)

    ir1 = _ring_above(nside, z)
    ir2 = ir1 + 1

    pix = np.zeros((4,) + theta.shape, dtype=np.int64)
    wgt = np.zeros((4,) + theta.shape, dtype=np.float64)
    theta1 = np.zeros_like(theta)
    theta2 = np.zeros_like(theta)

    has1 = ir1 > 0
    if np.any(has1):
        p1, p2, w = _ring_phi_interp(nside, np.where(has1, ir1, 1), phi)
        _, _, th, _ = _ring_info(nside, np.where(has1, ir1, 1))
        pix[0] = np.where(has1, p1, 0)
        pix[1] = np.where(has1, p2, 0)
        wgt[0] = np.where(has1, 1.0 - w, 0.0)
        wgt[1] = np.where(has1, w, 0.0)
        theta1 = np.where(has1, th, 0.0)

    has2 = ir2 < 4 * nside
    if np.any(has2):
        p1, p2, w = _ring_phi_interp(nside, np.where(has2, ir2, 1), phi)
        _, _, th, _ = _ring_info(nside, np.where(has2, ir2, 1))
        pix[2] = np.where(has2, p1, 0)
        pix[3] = np.where(has2, p2, 0)
        wgt[2] = np.where(has2, 1.0 - w, 0.0)
        wgt[3] = np.where(has2, w, 0.0)
        theta2 = np.where(has2, th, np.pi)

    # north polar correction: point above ring 1
    north_pole = ~has1
    if np.any(north_pole):
        wtheta = np.where(theta2 > 0, theta / np.where(theta2 > 0, theta2, 1.0), 0.0)
        fac = (1.0 - wtheta) * 0.25
        wgt[2] = np.where(north_pole, wgt[2] * wtheta + fac, wgt[2])
        wgt[3] = np.where(north_pole, wgt[3] * wtheta + fac, wgt[3])
        wgt[0] = np.where(north_pole, fac, wgt[0])
        wgt[1] = np.where(north_pole, fac, wgt[1])
        pix[0] = np.where(north_pole, (pix[2] + 2) % 4, pix[0])
        pix[1] = np.where(north_pole, (pix[3] + 2) % 4, pix[1])

    # south polar correction: point below the last ring
    south_pole = ~has2
    if np.any(south_pole):
        denom = np.where(np.pi - theta1 > 0, np.pi - theta1, 1.0)
        wtheta = (theta - theta1) / denom
        fac = wtheta * 0.25
        wgt[0] = np.where(south_pole, wgt[0] * (1.0 - wtheta) + fac, wgt[0])
        wgt[1] = np.where(south_pole, wgt[1] * (1.0 - wtheta) + fac, wgt[1])
        wgt[2] = np.where(south_pole, fac, wgt[2])
        wgt[3] = np.where(south_pole, fac, wgt[3])
        pix[2] = np.where(south_pole, ((pix[0] + 2) & 3) + npix - 4, pix[2])
        pix[3] = np.where(south_pole, ((pix[1] + 2) & 3) + npix - 4, pix[3])

    # the standard case: interpolate between the two rings
    normal = has1 & has2
    if np.any(normal):
        denom = np.where(theta2 - theta1 != 0, theta2 - theta1, 1.0)
        wtheta = (theta - theta1) / denom
        wgt[0] = np.where(normal, wgt[0] * (1.0 - wtheta), wgt[0])
        wgt[1] = np.where(normal, wgt[1] * (1.0 - wtheta), wgt[1])
        wgt[2] = np.where(normal, wgt[2] * wtheta, wgt[2])
        wgt[3] = np.where(normal, wgt[3] * wtheta, wgt[3])

    if nest:
        pix = ring2nest(nside, pix)
    return pix, wgt


def get_interp_val(m, theta, phi, nest: bool = False):
    """Bilinear-interpolated map value(s) at (theta, phi); m indexed along last axis."""
    m = np.asarray(m)
    nside = npix2nside(m.shape[-1])
    pix, wgt = get_interp_weights(nside, theta, phi, nest=nest)
    return np.sum(m[..., pix] * wgt, axis=-len(pix.shape))
