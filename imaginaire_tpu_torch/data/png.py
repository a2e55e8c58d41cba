"""A small PNG codec on ``zlib`` and numpy.

The machine that runs the port on the GPU has no OpenCV and no PIL, so
the port reads and writes PNG itself: 8-bit grayscale, RGB and RGBA,
non-interlaced. ``decode_png`` returns (H, W, C) uint8 with the channels
in file order (RGB, RGBA), which is what the JAX package's
``cv2.imdecode`` + BGR->RGB conversion returns for the same files.
``encode_png`` writes the same formats with every row's filter "Up".
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grayscale, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(buf, name):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        ctype = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if len(data) != length or zlib.crc32(ctype + data) != crc:
            raise ValueError(f"{name}: PNG chunk {ctype!r} is truncated or "
                             "fails its CRC")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends before its IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows, filters, bpp):
    """Undo the per-row filters of (H, stride) filtered bytes."""
    h, stride = rows.shape
    kinds = set(np.unique(filters).tolist())
    if not kinds <= {0, 1, 2, 3, 4}:
        raise ValueError(f"unknown PNG filter types {sorted(kinds)}")
    if kinds == {2}:
        # Up everywhere (the encoder's choice): a running sum down the
        # columns, mod 256
        return np.cumsum(rows, axis=0, dtype=np.uint8)
    if kinds <= {0, 1, 2}:
        out = np.empty_like(rows)
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            if filters[r] == 1:
                prev = np.cumsum(rows[r].reshape(-1, bpp), axis=0,
                                 dtype=np.uint8).reshape(-1)
            elif filters[r] == 2:
                prev = rows[r] + prev
            else:
                prev = rows[r].copy()
            out[r] = prev
        return out
    # Average and Paeth read the reconstructed left neighbour: sweep the
    # anti-diagonals of the (row, pixel) grid, every row at once
    w = stride // bpp
    raw = rows.reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # zero row above, column left
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        c = d - r
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        f = filters[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        out[r + 1, c + 1] = (raw[r, c] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(buf, name="<buffer>"):
    """PNG bytes -> (H, W, C) uint8 (C = 1, 3 or 4)."""
    buf = bytes(buf)
    if not buf.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for ctype, data in _chunks(buf, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{name}: PNG of bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}; the port's codec reads 8-bit "
            "grayscale, RGB and RGBA, non-interlaced")
    ch = _CHANNELS[colour]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: PNG image data holds {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    return _unfilter(raw[:, 1:], raw[:, 0], ch).reshape(h, w, ch)


def _chunk(ctype, data):
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data)))


def encode_png(image, level=6):
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 -> PNG bytes."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"encode_png takes (H, W[, 1|3|4]) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, ch = img.shape
    rows = np.ascontiguousarray(img).reshape(h, w * ch)
    filtered = np.empty((h, w * ch + 1), np.uint8)
    filtered[:, 0] = 2  # Up
    filtered[:, 1:] = rows
    filtered[1:, 1:] -= rows[:-1]
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, image):
    with open(path, "wb") as f:
        f.write(encode_png(image))
    return path
