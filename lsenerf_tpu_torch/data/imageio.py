"""8-bit PNG read and write with zlib and numpy, for the scene frames and
the eval artifacts (no imaging library on the card's machine).

`read_png` takes non-interlaced 8-bit gray, gray+alpha, RGB and RGBA files
with any of the five PNG row filters, and palette files. `write_png`
writes gray, RGB or RGBA with filter 0 (none) on every row. `read_image`
also reads JPEG frames, through PIL, which it imports only for them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: raw is h rows of (1 + stride) bytes. A
    pixel depends on its left, upper and upper-left neighbours only, so
    one anti-diagonal of pixels at a time is decoded together."""
    rows = raw.reshape(h, stride + 1)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    if not ftype.any():  # filter 0 on every row, as write_png writes
        return rows[:, 1:].copy()
    w = stride // bpp
    data = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column before
    ys = np.arange(h)
    for d in range(h + w - 1):
        y = ys[max(0, d - w + 1) : min(h, d + 1)]
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]  # left, up, upper left
        f = ftype[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(h, w) uint8 for gray, (h, w, c) for gray+alpha, RGB (palette
    files decoded to RGB or RGBA) and RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    idat, palette, trns = [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNG is read "
                         f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    if ctype == 3:  # palette
        rgb = palette[img[..., 0]]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = trns
            return np.concatenate([rgb, alpha[img[..., 0]][..., None]], -1)
        return rgb
    return img[..., 0] if c == 1 else img


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (h, w) or (h, w, 1|3|4) uint8 image, filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """An RGB frame as (h, w, 3) uint8: PNG through read_png (gray
    repeated, alpha dropped), JPEG through PIL."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] in (1, 2):
            return np.repeat(img[..., :1], 3, axis=-1)
        return img[..., :3]
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL, which is not installed; "
                          "convert the frames to PNG") from e
    return np.asarray(Image.open(path).convert("RGB"))
