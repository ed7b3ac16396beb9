"""A small PNG reader and writer (zlib and numpy only).

The KITTI-MOT parser reads its camera frames through `read_png`, so a machine
without an image library can parse a KITTI layout. PNG is lossless: the arrays
are the ones `imageio.v2.imread` gives for the same file.

`read_png` takes 8-bit greyscale, grey + alpha, RGB and RGBA images without
interlacing, with any of the five row filters. `write_png` writes 8-bit
images and picks each row's filter as libpng does, so its files take the
decode path of camera frames saved by common encoders (mostly Paeth and Sub
rows).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _header(body: bytes) -> Tuple[int, int, int, int, int]:
    width, height, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return width, height, depth, colour, interlace


def read_png_size(path) -> Tuple[int, int]:
    """(height, width) from the IHDR chunk, without decoding the image."""
    with open(path, "rb") as f:
        head = f.read(33)
    kind, body = next(_chunks(head))
    if kind != b"IHDR":
        raise ValueError(f"{path}: the first chunk is not IHDR")
    width, height = _header(body)[:2]
    return height, width


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor, element-wise on int16 arrays (left, up, upper left)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predict(kind: np.ndarray, a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The predictor of row filter `kind` (broadcast against a, b, c)."""
    return np.where(kind == 4, _paeth(a, b, c), np.where(kind == 3, (a + b) >> 1,
                    np.where(kind == 2, b, np.where(kind == 1, a, 0))))


def _unfilter_wavefront(kinds: np.ndarray, rows: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of `rows` ([R, stride] uint8, any kinds) below the
    reconstructed row `prior`.

    Average (3) and Paeth (4) need the reconstructed pixel to their left, so a
    row is serial along its length. But a pixel needs only its left, upper and
    upper-left neighbours, so the pixels of one anti-diagonal (row + column
    constant) are independent of each other. The rows are skewed so that each
    anti-diagonal is one contiguous slice, and the image is undone in
    R + W - 1 vectorised steps instead of R x W x bpp scalar ones.
    """
    n_rows, stride = rows.shape
    width = stride // bpp
    i = np.arange(1, n_rows + 1)[:, None]
    x = np.arange(width)[None, :]
    # skew[j, i] holds pixel x = j - i - 1 of row i (row 0 is `prior`); the
    # slots of x = -1 stay zero, PNG's left neighbour of a row's first pixel
    skew = np.zeros((n_rows + width + 1, n_rows + 1, bpp), np.int16)
    skew[x[0] + 1, 0] = prior.reshape(width, bpp)
    raw = np.zeros_like(skew)
    raw[i + x + 1, i] = rows.reshape(n_rows, width, bpp)
    kind = np.concatenate([[0], kinds]).astype(np.int16)[:, None]
    for j in range(2, n_rows + width + 1):
        lo, hi = max(1, j - width), min(n_rows, j - 1) + 1
        a, b, c = skew[j - 1, lo:hi], skew[j - 1, lo - 1:hi - 1], skew[j - 2, lo - 1:hi - 1]
        skew[j, lo:hi] = (raw[j, lo:hi] + _predict(kind[lo:hi], a, b, c)) & 0xFF
    return skew[i + x + 1, i].astype(np.uint8).reshape(n_rows, stride)


def read_png(path) -> np.ndarray:
    """uint8 [H, W] (greyscale) or [H, W, C] (C = 2, 3, 4)."""
    data = Path(path).read_bytes()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, grey+alpha, RGB and RGBA PNGs are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8).reshape(height, stride + 1)
    filters, rows = raw[:, 0], raw[:, 1:]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(filters.max())}")
    out = np.empty((height, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.uint8)
    # None, Sub and Up rows are undone a row at a time; from the first Average
    # or Paeth row on, the rest of the image goes through the wavefront
    serial = np.flatnonzero(filters >= 3)
    first = int(serial[0]) if serial.size else height
    for y in range(first):
        kind, row = int(filters[y]), rows[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:  # Sub: a running sum, channel by channel, mod 256
            out[y] = np.cumsum(row.reshape(width, bpp), axis=0, dtype=np.uint64).astype(np.uint8).reshape(-1)
        else:  # Up
            out[y] = row + prior
        prior = out[y]
    if first < height:
        out[first:] = _unfilter_wavefront(filters[first:], rows[first:], prior, bpp)
    img = out.reshape(height, width, bpp)
    return img[..., 0] if bpp == 1 else img


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Filter each row of `rows` ([H, stride] uint8) as libpng's adaptive
    filtering does: every filter is tried and the row keeps the one whose
    residuals, read as signed bytes, have the least sum of magnitudes.
    -> [H, stride + 1] uint8, the filter byte first."""
    cur = rows.astype(np.int16)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left, upper_left = np.zeros_like(cur), np.zeros_like(cur)
    left[:, bpp:], upper_left[:, bpp:] = cur[:, :-bpp], up[:, :-bpp]
    kinds = np.arange(5, dtype=np.int16)[:, None, None]
    residual = ((cur - _predict(kinds, left, up, upper_left)) & 0xFF).astype(np.uint8)  # [5, H, stride]
    magnitude = residual.astype(np.int32)
    cost = np.minimum(magnitude, 256 - magnitude).sum(axis=-1)  # [5, H]
    best = cost.argmin(axis=0)
    chosen = np.take_along_axis(residual, best[None, :, None], axis=0)[0]
    return np.concatenate([best.astype(np.uint8)[:, None], chosen], axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, image: np.ndarray, level: int = 6) -> None:
    """Write a uint8 [H, W] or [H, W, C] (C = 1..4) image, each row with the
    filter libpng's adaptive heuristic picks (`_filter_rows`)."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    height, width, channels = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    raw = _filter_rows(img.reshape(height, width * channels), channels)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                           + _chunk(b"IEND", b""))
