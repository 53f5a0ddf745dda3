"""PNG decode and encode on numpy and zlib, for the TUM images.

The reference reads and writes the TUM sequence's PNGs with OpenCV
(`cv2.imread` / `cv2.imwrite`); the port has no OpenCV, so this module
covers what those calls do on the TUM layout:

  - `imread(path)`: the samples as stored, (H, W) uint8 or uint16 for a
    gray image (cv2.IMREAD_UNCHANGED on a depth PNG), (H, W, 3 | 4) uint8
    in RGB(A) order for a colour one (cv2 gives BGR(A));
  - `imread_gray(path)`: (H, W) uint8 as cv2.IMREAD_GRAYSCALE gives it:
    gray as stored, colour through libpng's fixed-point BT.601 luma
    (alpha dropped);
  - `imwrite(path, img)`: (H, W, 3) uint8 as 8-bit RGB, (H, W) uint16 as
    16-bit gray, every row with filter 0.

Decoding takes non-interlaced 8-bit gray, RGB and RGBA and 16-bit gray,
with all five row filters; any other format raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> samples per pixel
_FORMATS = {(8, 0): 1, (16, 0): 1, (8, 2): 3, (8, 6): 4}
# libpng's rgb_to_gray as OpenCV sets it (0.299, 0.587): 15-bit fixed
# point, each coefficient truncated, blue the rest; the sum is truncated
_RED, _GREEN = 9797, 19234
_BLUE = 32768 - _RED - _GREEN


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered scanlines -> (H, stride) uint8 bytes."""
    ft, x = rows[:, 0], rows[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ft.max())}")
    h, stride = x.shape
    if not np.isin(ft, (3, 4)).any():
        # None, Sub, Up: each row is vectorised (Sub is a running sum mod 256)
        out = np.empty_like(x)
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            if ft[r] == 1:
                prev = np.cumsum(x[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif ft[r] == 2:
                prev = x[r] + prev
            else:
                prev = x[r]
            out[r] = prev
        return out
    # Average and Paeth depend on the reconstructed left neighbour: sweep
    # the anti-diagonals r + p (pixel p of row r needs (r, p-1), (r-1, p)
    # and (r-1, p-1)), each diagonal vectorised, in a zero-padded buffer
    w = stride // bpp
    xs = x.reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        p = d - r
        a, b, c = out[r + 1, p], out[r, p + 1], out[r, p]
        pred = np.choose(ft[r][:, None], [np.zeros_like(a), a, b, (a + b) >> 1,
                                          _paeth(a, b, c)])
        out[r + 1, p + 1] = (xs[r, p] + pred) & 255
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> the stored samples (see `imread`)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    channels = _FORMATS.get((depth, colour))
    if channels is None or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}")
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG image data of the wrong size")
    px = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(h, w)
    return px.reshape(h, w) if channels == 1 else px.reshape(h, w, channels)


def imread(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode(fh.read())


def to_gray(img: np.ndarray) -> np.ndarray:
    """Stored 8-bit samples -> (H, W) uint8 gray: libpng's rgb_to_gray
    (what cv2.IMREAD_GRAYSCALE returns); equal R, G, B stay as they are."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int64)
    y = (_RED * rgb[..., 0] + _GREEN * rgb[..., 1] + _BLUE * rgb[..., 2]) >> 15
    return y.astype(np.uint8)


def imread_gray(path: str) -> np.ndarray:
    img = imread(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit image has no 8-bit gray")
    return to_gray(img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> 8-bit RGB PNG; (H, W) uint16 -> 16-bit gray."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, colour, px = 8, 2, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, colour, px = 16, 0, img.astype(">u2")
    else:
        raise ValueError(f"cannot encode {img.dtype} {img.shape}: expected (H, W, 3) "
                         "uint8 or (H, W) uint16")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(px).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode(img))
