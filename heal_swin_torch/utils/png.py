"""A PNG codec on ``zlib`` and numpy, so that the port reads and writes WoodScape images
without PIL or OpenCV.

``decode`` reads non-interlaced PNGs of 8-bit gray, gray + alpha, RGB, RGBA and palette
images (palette indices also at 1, 2 and 4 bits), undoing all five row filters, and
returns the raw samples: (H, W) for gray and palette (the indices), (H, W, C) for the
rest, with the palette beside them.  ``encode`` writes 8-bit gray, RGB, RGBA and palette
images with one row filter for every row.

Undoing the filters: None, Sub and Up rows need no loop over a row (None rows are copied
all at once, a Sub row is a ``cumsum`` in uint8 over its pixels, an Up row one add), so
an image whose rows all use them takes one numpy pass per Sub or Up row.  Average and Paeth depend on the pixel to the left as well as the
row above, so an image with such rows is undone as one wavefront over the whole image:
pixel (r, x) needs (r, x - 1), (r - 1, x) and (r - 1, x - 1), so every pixel on one
anti-diagonal x + r = t can be computed together from diagonals t - 1 and t - 2.  The
image is skewed so that each diagonal is a column, and the H + W - 1 steps each work on
one column of at most min(H, W) pixels, whatever filter each row uses.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


class Png(NamedTuple):
    """A decoded PNG: the samples ((H, W) or (H, W, C) uint8), the colour type and, for
    palette images, the palette ((N, 3) uint8; else None)."""

    samples: np.ndarray
    color_type: int
    palette: Optional[np.ndarray]


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends without an IEND chunk")


def _unfilter_rows(F: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Undo None / Sub / Up rows: F (H, stride) filtered bytes -> (H, stride)."""
    out = F.copy()  # None rows are their bytes
    prev = np.zeros(F.shape[1], np.uint8)
    for r in np.flatnonzero(ft):
        if ft[r] == 1:
            out[r] = np.cumsum(F[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            np.add(F[r], out[r - 1] if r else prev, out=out[r])  # uint8: wraps mod 256
    return out


def _unfilter_wavefront(F: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Undo rows of any filter by anti-diagonals (see the module's docstring).  F: (H,
    stride) filtered bytes, stride = W * bpp -> (H, stride).  The skewed array S has a
    zero row for the row above the image and S[r + 1, x + r + 1] = pixel (r, x); entries
    never written are the zeros that the filters take outside the image."""
    H, stride = F.shape
    W = stride // bpp
    T = W + H - 1
    rows = np.arange(1, H + 1)[:, None]
    cols = np.arange(W)[None, :] + rows
    Fs = np.zeros((H + 1, T + 1, bpp), np.int16)
    Fs[rows, cols] = F.reshape(H, W, bpp)
    S = np.zeros((H + 1, T + 1, bpp), np.int16)
    masks = [(ft == k).astype(np.int16)[:, None] for k in range(1, 5)]
    for j in range(1, T + 1):
        lo, hi = max(1, j - W + 1), min(H, j)
        a = S[lo:hi + 1, j - 1]
        b = S[lo - 1:hi, j - 1]
        c = S[lo - 1:hi, j - 2]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        m_sub, m_up, m_avg, m_paeth = (m[lo - 1:hi] for m in masks)
        pred = m_sub * a + m_up * b + m_avg * ((a + b) >> 1) + m_paeth * paeth
        S[lo:hi + 1, j] = (Fs[lo:hi + 1, j] + pred) & 255
    return S[rows, cols].astype(np.uint8).reshape(H, stride)


def decode(data: bytes) -> Png:
    """PNG bytes -> ``Png``.  Raises NotImplementedError for interlaced images, 16-bit
    samples and sub-byte samples other than palette indices."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    W, H, depth, color_type, _, _, interlace = header
    if interlace:
        raise NotImplementedError("interlaced PNGs are not supported")
    if color_type not in CHANNELS:
        raise ValueError(f"PNG colour type {color_type} unknown")
    if depth != 8 and not (color_type == 3 and depth in (1, 2, 4)):
        raise NotImplementedError(
            f"{depth}-bit samples of colour type {color_type}: the codec reads 8-bit "
            "samples, and palette indices of 1, 2 and 4 bits")
    ch = CHANNELS[color_type]
    stride = (W * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < H * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, {H * (stride + 1)} needed")
    rows = raw[:H * (stride + 1)].reshape(H, stride + 1)
    ft, F = rows[:, 0], rows[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ft.max())} unknown")
    bpp = max(1, ch * depth // 8)
    if (ft >= 3).any():
        out = _unfilter_wavefront(F, ft, bpp)
    else:
        out = _unfilter_rows(F, ft, bpp)
    if depth < 8:
        bits = np.unpackbits(out, axis=1).reshape(H, stride * 8 // depth, depth)[:, :W]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (bits * weights).sum(axis=-1).astype(np.uint8)
    samples = out.reshape(H, W) if ch == 1 else out.reshape(H, W, ch)
    return Png(samples, color_type, palette)


def read(path) -> Png:
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter(img: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """(H, stride) uint8 -> (H, stride) filtered with row filter ``kind``."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def encode(samples: np.ndarray, palette: Optional[np.ndarray] = None,
           filter_type: int = 0) -> bytes:
    """uint8 samples -> PNG bytes, every row with ``filter_type`` (0-4: None, Sub, Up,
    Average, Paeth), compressed at zlib's default level.  (H, W): gray, or palette indices
    with ``palette`` ((N, 3) uint8, N <= 256); (H, W, 2 / 3 / 4): gray + alpha, RGB,
    RGBA."""
    samples = np.ascontiguousarray(samples)
    if samples.dtype != np.uint8:
        raise ValueError(f"PNG samples must be uint8, not {samples.dtype}")
    if filter_type not in range(5):
        raise ValueError(f"PNG row filter {filter_type} unknown")
    H, W = samples.shape[:2]
    ch = 1 if samples.ndim == 2 else samples.shape[2]
    if palette is not None:
        if ch != 1:
            raise ValueError("palette images take (H, W) indices")
        color_type = 3
    else:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = _filter(samples.reshape(H, W * ch), filter_type, ch)
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8), rows], axis=1)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8).tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(raw.tobytes())), _chunk(b"IEND", b"")]
    return b"".join(out)


def write(path, samples: np.ndarray, palette: Optional[np.ndarray] = None,
          filter_type: int = 0):
    with open(path, "wb") as f:
        f.write(encode(samples, palette, filter_type))
