"""Image format loaders and writers (host-side numpy), copied from
raytracer_tpu/io/imageio.py: the same readers, writers and arrays, so
a file reads to the same numbers in both packages.

Mirrors the reference RawImage loader stack:
  - TGA types 2/3 (+RLE type 10 for robustness), BGR->RGB swap, vertical flip,
    gamma->linear via the 16-bit LUT on color channels, linear alpha
    (reference: src/RawImage.cpp:89-188)
  - binary PPM P6 read (reference: src/RawImage.cpp:33-88) and write
    (reference: src/Image.cpp:132-154)
  - Radiance .hdr RGBE decode, new-RLE + old-RLE + flat
    (reference: src/hdrloader.cpp:29-191)

Loaded images are float32 row-major with row 0 at the *top* of the image —
the reference's post-flip memory order (its texture lookup then flips v,
src/Texture.cpp:53-54). Rendered framebuffers instead use row 0 = bottom
scanline (camera v grows upward, src/Camera.cpp:150); write_ppm flips them to
file order like Image::writePPM (src/Image.cpp:148-151).
"""
from __future__ import annotations

import os
import struct as pystruct

import numpy as np

# image type tags (reference: src/RawImage.h)
GRAYSCALE, RGB, RGBA, HDR = 0, 1, 2, 3

_GAMMA = 2.2
# 8-bit gamma -> 15-bit linear LUT (reference: src/Image.cpp:24-27)
_G2L = (np.floor(np.power(np.arange(256, dtype=np.float64) / 255.0, _GAMMA)
                 * 32768.0 + 0.5) / 32768.0).astype(np.float32)


def load_tga(path: str) -> tuple[np.ndarray, int]:
    """Load a TGA file -> (H, W, C) float32 linear, bottom row first.

    Color channels pass through the reference's gamma->linear LUT
    (src/RawImage.cpp:154-157); a 4th channel stays linear /255
    (src/RawImage.cpp:158-163).
    """
    with open(path, 'rb') as f:
        header = f.read(18)
        id_len, cmap_type, img_type = header[0], header[1], header[2]
        width, height = pystruct.unpack('<HH', header[12:16])
        depth = header[16]
        descriptor = header[17]
        f.read(id_len)
        mode = depth // 8
        total = width * height * mode
        if img_type in (2, 3):
            raw = np.frombuffer(f.read(total), np.uint8)
        elif img_type == 10:  # RLE true-color (not in reference; robustness)
            data = f.read()
            out = np.empty(total, np.uint8)
            di = 0
            oi = 0
            while oi < total:
                hdr = data[di]; di += 1
                n = (hdr & 0x7F) + 1
                if hdr & 0x80:
                    px = data[di:di + mode]; di += mode
                    out[oi:oi + n * mode] = np.tile(np.frombuffer(px, np.uint8), n)
                else:
                    cnt = n * mode
                    out[oi:oi + cnt] = np.frombuffer(data[di:di + cnt], np.uint8)
                    di += cnt
                oi += n * mode
            raw = out
        else:
            raise ValueError(f'unsupported TGA type {img_type} in {path}')

    img = raw.reshape(height, width, mode)
    # The reference flips rows unconditionally (src/RawImage.cpp:145-152),
    # turning bottom-left-origin files (all shipped textures) into
    # top-row-first memory. We flip only bottom-origin files (descriptor bit
    # 0x20 clear) so the result is always top-row-first.
    if not (descriptor & 0x20):
        img = img[::-1]

    fimg = _G2L[img].astype(np.float32)
    if mode == 4:
        fimg[..., 3] = img[..., 3].astype(np.float32) / 255.0
    if mode >= 3:  # BGR(A) -> RGB(A) (src/RawImage.cpp:176-187)
        fimg = fimg[..., [2, 1, 0] + ([3] if mode == 4 else [])]
    itype = {1: GRAYSCALE, 3: RGB, 4: RGBA}[mode]
    return np.ascontiguousarray(fimg), itype


def load_ppm(path: str) -> tuple[np.ndarray, int]:
    """Binary P6 PPM -> (H, W, 3) float32 in [0,1] (src/RawImage.cpp:33-88)."""
    with open(path, 'rb') as f:
        data = f.read()
    # parse header tokens, skipping comments
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b'#':
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    i += 1  # single whitespace after maxval
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    assert magic == b'P6', f'not a binary PPM: {path}'
    raw = np.frombuffer(data[i:i + w * h * 3], np.uint8)
    img = raw.reshape(h, w, 3).astype(np.float32) / float(maxval)
    return img, RGB


def write_ppm(path: str, pixels_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8, flipping vertically like the reference writer
    (src/Image.cpp:137-153: row 0 of the framebuffer is the bottom scanline)."""
    h, w, _ = pixels_u8.shape
    with open(path, 'wb') as f:
        f.write(b'P6\n%d %d\n255\n' % (w, h))
        f.write(np.ascontiguousarray(pixels_u8[::-1]).tobytes())


def write_png(path: str, pixels_u8: np.ndarray) -> None:
    """Minimal zlib PNG writer (8-bit RGB) for the --serve live preview —
    browsers don't render PPM. Flips vertically like write_ppm (framebuffer
    row 0 is the bottom scanline, src/Image.cpp:137-153)."""
    import struct
    import zlib

    h, w, _ = pixels_u8.shape
    img = np.ascontiguousarray(pixels_u8[::-1])
    raw = b''.join(b'\x00' + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n')
        f.write(chunk(b'IHDR', ihdr))
        f.write(chunk(b'IDAT', zlib.compress(raw, 6)))
        f.write(chunk(b'IEND', b''))


def load_hdr(path: str) -> tuple[np.ndarray, int]:
    """Radiance RGBE .hdr -> (H, W, 3) float32 (src/hdrloader.cpp:29-191).

    Handles new-style per-scanline RLE, old-style RLE and flat data. The
    decoded rows follow file order (top-first per the -Y convention); the
    reference stores them as-is, so we match its memory order.
    """
    with open(path, 'rb') as f:
        line = f.readline()
        if not line.startswith(b'#?'):
            raise ValueError(f'not a Radiance file: {path}')
        while True:
            line = f.readline()
            if line in (b'\n', b'\r\n', b''):
                break
        dims = f.readline().split()
        # canonical form: -Y H +X W
        h = int(dims[1]); w = int(dims[3])
        data = f.read()

    img = np.zeros((h, w, 4), np.uint8)
    di = 0

    def decrunch_new(row):
        nonlocal di
        for c in range(4):
            x = 0
            while x < w:
                code = data[di]; di += 1
                if code > 128:  # run
                    n = code & 127
                    img[row, x:x + n, c] = data[di]; di += 1
                    x += n
                else:           # literal
                    n = code
                    img[row, x:x + n, c] = np.frombuffer(data[di:di + n], np.uint8)
                    di += n
                    x += n

    def decrunch_old(row, start_x):
        nonlocal di
        x = start_x
        rshift = 0
        while x < w:
            px = np.frombuffer(data[di:di + 4], np.uint8); di += 4
            if px[0] == 1 and px[1] == 1 and px[2] == 1:  # old-RLE repeat
                n = int(px[3]) << rshift
                img[row, x:x + n] = img[row, x - 1]
                x += n
                rshift += 8
            else:
                img[row, x] = px
                x += 1
                rshift = 0

    for row in range(h):
        # peek scanline header
        if w >= 8 and w < 0x8000 and di + 4 <= len(data) and \
                data[di] == 2 and data[di + 1] == 2 and \
                ((data[di + 2] << 8) | data[di + 3]) == w:
            di += 4
            decrunch_new(row)
        else:
            decrunch_old(row, 0)

    # RGBE -> float (src/hdrloader.cpp: workOnRGBE: ldexp(1, e - 128 - 8))
    e = img[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0).astype(np.float32)
    rgb = img[..., :3].astype(np.float32) * scale[..., None]
    return rgb, HDR


def load_image(path: str) -> tuple[np.ndarray, int]:
    """Extension-dispatching loader (reference: src/RawImage.cpp:16-26)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == '.tga':
        return load_tga(path)
    if ext == '.ppm':
        return load_ppm(path)
    if ext == '.hdr':
        return load_hdr(path)
    raise ValueError(f'unsupported image format: {path}')
