"""The port's image readers and writers against the JAX package's.

Each file is written by the test from numpy data made from a seed: TGA
types 2, 3 and 10 (24- and 32-bit, both origin bits, an image id field),
binary PPM (with a header comment) and Radiance HDR (new RLE, old RLE and
flat). Both packages must read the very same arrays, and write the same
PPM and PNG bytes.
"""
import struct

import numpy as np
import pytest

from raytracer_tpu.io import imageio as jio
from raytracer_tpu_torch.io import imageio as tio


def _tga_bytes(img: np.ndarray, img_type: int, top: bool,
               image_id: bytes = b'') -> bytes:
    """(H, W, C) uint8 rows in file order, channels as stored (BGR(A) or
    gray) -> a TGA file; type 10 run-length-encodes each row."""
    h, w, c = img.shape
    desc = (0x20 if top else 0) | (8 if c == 4 else 0)
    header = struct.pack('<BBB5sHHHHBB', len(image_id), 0, img_type,
                         b'\0' * 5, 0, 0, w, h, 8 * c, desc)
    if img_type != 10:
        return header + image_id + img.tobytes()
    out = bytearray()
    for row in img:
        x = 0
        while x < w:
            n = 1
            while x + n < w and n < 128 and (row[x + n] == row[x]).all():
                n += 1
            if n > 1:                           # a run packet
                out += bytes([0x80 | (n - 1)]) + row[x].tobytes()
            else:                               # raw packet up to 128
                n = 1
                while x + n < w and n < 128 and \
                        not (row[x + n] == row[x + n - 1]).all():
                    n += 1
                out += bytes([n - 1]) + row[x:x + n].tobytes()
            x += n
    return header + image_id + bytes(out)


def _pixels(rs, h, w, c):
    """Random bytes with runs of repeated pixels (for the RLE packets)."""
    img = rs.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[:, 3:9] = img[:, 3:4]
    return img


TGA_CASES = [(t, c, top) for t, cs in ((2, (3, 4)), (3, (1,)), (10, (3, 4)))
             for c in cs for top in (False, True)]


@pytest.mark.parametrize('img_type,channels,top', TGA_CASES)
def test_tga_equal(tmp_path, img_type, channels, top):
    rs = np.random.default_rng(100 + img_type * 10 + channels + top)
    path = str(tmp_path / 'img.tga')
    with open(path, 'wb') as f:
        f.write(_tga_bytes(_pixels(rs, 7, 13, channels), img_type, top,
                           image_id=b'id' if top else b''))
    got, kind = tio.load_tga(path)
    want, kind_j = jio.load_tga(path)
    assert kind == kind_j and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.load_image(path)[0], want)


def test_ppm_read_and_write_equal(tmp_path):
    rs = np.random.default_rng(7)
    img = rs.integers(0, 256, (5, 9, 3), dtype=np.uint8)
    got_p, want_p = str(tmp_path / 'port.ppm'), str(tmp_path / 'jax.ppm')
    tio.write_ppm(got_p, img)
    jio.write_ppm(want_p, img)
    assert open(got_p, 'rb').read() == open(want_p, 'rb').read()
    # a header with a comment and another maxval
    path = str(tmp_path / 'comment.ppm')
    with open(path, 'wb') as f:
        f.write(b'P6\n# a comment\n9 5\n200\n' + np.minimum(img, 200)
                .tobytes())
    for p in (got_p, path):
        got, want = tio.load_image(p), jio.load_image(p)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    # written bottom row first: read back flipped
    np.testing.assert_array_equal(tio.load_ppm(got_p)[0][::-1],
                                  img.astype(np.float32) / 255.0)


def test_png_bytes_equal(tmp_path):
    rs = np.random.default_rng(8)
    img = rs.integers(0, 256, (6, 11, 3), dtype=np.uint8)
    got_p, want_p = str(tmp_path / 'port.png'), str(tmp_path / 'jax.png')
    tio.write_png(got_p, img)
    jio.write_png(want_p, img)
    data = open(got_p, 'rb').read()
    assert data == open(want_p, 'rb').read()
    assert data.startswith(b'\x89PNG\r\n\x1a\n')


def _hdr_bytes(rgbe: np.ndarray, mode: str) -> bytes:
    """(H, W, 4) uint8 RGBE pixels -> a Radiance file, its scanlines
    new-RLE, old-RLE or flat."""
    h, w, _ = rgbe.shape
    head = b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n' + \
        b'-Y %d +X %d\n' % (h, w)
    out = bytearray()
    for row in rgbe:
        if mode == 'flat':
            out += row.tobytes()
        elif mode == 'old':
            # each run of a repeated pixel as the pixel, then a
            # (1, 1, 1, n) repeat marker
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 200 and (row[x + n] == row[x]).all():
                    n += 1
                out += row[x].tobytes()
                if n > 1:
                    out += bytes([1, 1, 1, n - 1])
                x += n
        else:
            out += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                ch = row[:, c]
                x = 0
                while x < w:
                    n = 1
                    while x + n < w and n < 127 and ch[x + n] == ch[x]:
                        n += 1
                    if n > 2:                   # a run
                        out += bytes([128 | n, ch[x]])
                    else:                       # a literal
                        n = min(2, w - x)
                        out += bytes([n]) + ch[x:x + n].tobytes()
                    x += n
    return head + bytes(out)


@pytest.mark.parametrize('mode', ['new', 'old', 'flat'])
def test_hdr_equal(tmp_path, mode):
    rs = np.random.default_rng({'new': 1, 'old': 2, 'flat': 3}[mode])
    h, w = 4, 19
    rgbe = rs.integers(2, 256, (h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rs.integers(120, 140, (h, w))
    rgbe[:, 4:11] = rgbe[:, 4:5]              # runs
    rgbe[1, 2, 3] = 0                         # a zero exponent: black
    path = str(tmp_path / f'{mode}.hdr')
    with open(path, 'wb') as f:
        f.write(_hdr_bytes(rgbe, mode))
    got, kind = tio.load_hdr(path)
    want, kind_j = jio.load_hdr(path)
    assert kind == kind_j == tio.HDR and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.load_image(path)[0], want)
    assert float(got.max()) > 0 and (got[1, 2] == 0).all()


def test_gamma_table_equal():
    np.testing.assert_array_equal(tio._G2L, jio._G2L)
    with pytest.raises(ValueError, match='unsupported'):
        tio.load_image('image.bmp')
