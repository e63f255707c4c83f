"""The port's PNG codec (``heal_swin_torch/utils/png.py``) and readers
(``heal_swin_torch/utils/image.py``) against PIL, bit-equal.

- Every colour type the codec writes (gray, gray + alpha, RGB, RGBA, palette) with each
  of the five row filters: the port's decode of the port's encode, and PIL's decode of
  it, equal the source samples.
- PIL's own files (its adaptive filters; palettes of 1, 2, 4 and 8 bits): the port's raw
  samples equal PIL's raw array (``read_mask``'s semantics: palette indices), and
  ``read_image`` equals PIL's ``convert("RGB")`` and the JAX package's ``read_image``.
- A mixed-filter image takes the wavefront (Average / Paeth rows among None / Sub / Up
  rows); 16-bit and interlaced files raise NotImplementedError.
"""

import io

import numpy as np
import pytest
from PIL import Image

from heal_swin_torch.utils import image as TI
from heal_swin_torch.utils import png
from heal_swin_tpu.utils import image as JI

SHAPES = {"L": (13, 17), "LA": (13, 17, 2), "RGB": (13, 17, 3), "RGBA": (13, 17, 4),
          "P": (13, 17)}


def _samples(mode, seed=0, shape=None):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 256, shape or SHAPES[mode]).astype(np.uint8)
    if mode == "P":
        s %= 7
    s[:, :4] = s[:, :1]  # flat runs, so that every filter meets equal neighbours
    return s


def _palette(n=7):
    return np.random.RandomState(9).randint(0, 256, (n, 3)).astype(np.uint8)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_encode_decode_against_pil(mode, filter_type):
    s = _samples(mode, filter_type)
    pal = _palette() if mode == "P" else None
    data = png.encode(s, palette=pal, filter_type=filter_type)
    got = png.decode(data)
    np.testing.assert_array_equal(got.samples, s)
    pil = Image.open(io.BytesIO(data))
    assert pil.mode == mode
    np.testing.assert_array_equal(np.asarray(pil), s)
    if mode == "P":
        np.testing.assert_array_equal(got.palette, pal)


@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_pil_files_read_as_pil(tmp_path, mode):
    s = _samples(mode, 3, shape=(40, 33) + SHAPES[mode][2:])
    img = Image.fromarray(s, mode)
    if mode == "P":
        img.putpalette(_palette().reshape(-1).tolist())
    path = tmp_path / "x.png"
    img.save(path)
    np.testing.assert_array_equal(TI.read_mask(path), np.asarray(Image.open(path)))
    rgb = TI.read_image(path)
    np.testing.assert_array_equal(rgb, np.asarray(Image.open(path).convert("RGB"))
                                  .transpose(2, 0, 1))
    np.testing.assert_array_equal(rgb, JI.read_image(path))
    if mode in ("L", "P"):
        np.testing.assert_array_equal(TI.read_mask(path), JI.read_mask(path))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_masks_of_every_bit_depth(tmp_path, bits):
    """Label PNGs as palette images: the indices are the class ids (``read_mask``)."""
    n = 2 ** bits if bits < 8 else 11
    idx = (np.arange(9 * 21).reshape(9, 21) * 7 % n).astype(np.uint8)
    img = Image.fromarray(idx, "P")
    img.putpalette(np.random.RandomState(bits).randint(0, 256, 3 * n).tolist())
    path = tmp_path / "m.png"
    img.save(path, bits=bits)
    assert path.read_bytes()[24] == bits  # IHDR's bit depth
    np.testing.assert_array_equal(TI.read_mask(path), idx)
    np.testing.assert_array_equal(TI.read_mask(path), JI.read_mask(path))
    np.testing.assert_array_equal(TI.read_image(path), JI.read_image(path))


def test_mixed_filters_take_the_wavefront():
    """Rows of all five filters in one image, written by hand: the decode equals the
    source (the wavefront undoes None / Sub / Up rows beside Average / Paeth ones)."""
    import zlib

    s = _samples("RGB", 5, shape=(10, 12, 3))
    rows = [png._filter(s.reshape(10, 36), f, 3) for f in range(5)]
    ft = np.array([[r % 5] for r in range(10)], np.uint8)
    body = np.concatenate([ft, np.stack([rows[r % 5][r] for r in range(10)])], axis=1)
    data = png.encode(s)  # the header and chunks; the image data replaced below
    head = data[:data.index(b"IDAT") - 4]
    out = head + png._chunk(b"IDAT", zlib.compress(body.tobytes())) + png._chunk(b"IEND", b"")
    np.testing.assert_array_equal(png.decode(out).samples, s)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(out))), s)


def test_unsupported_files_raise(tmp_path):
    path = tmp_path / "d16.png"
    Image.fromarray(np.arange(20, dtype=np.uint16).reshape(4, 5) * 3000).save(path)
    with pytest.raises(NotImplementedError, match="16-bit"):
        TI.read_mask(path)
    data = bytearray(png.encode(_samples("L")))
    data[28] = 1  # IHDR's interlace byte
    with pytest.raises(NotImplementedError, match="interlaced"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")
