"""Still images on the host without OpenCV or PIL: a PNG writer and reader on
the standard library's `zlib`.

The JAX package writes the context frames' PNGs and reads the demo's input
image with OpenCV, which a machine may lack. Here:
  * `write_png(path, rgb)`: (H, W, 3) uint8 RGB -> an 8-bit RGB PNG, every
    row under filter type 0;
  * `read_image(path)`: (H, W, 3) uint8 RGB. A non-interlaced 8-bit PNG of
    colour type 0 (grey), 2 (RGB), 4 (grey + alpha) or 6 (RGBA) is decoded
    here, undoing the five row filters (None, Sub, Up, Average, Paeth); the
    alpha channel is dropped. Any other file (JPEG, palette or 16-bit PNG)
    goes through OpenCV, and without it raises an ImportError that names
    `.png`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB -> an 8-bit RGB PNG at `path`."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png: (H, W, 3) uint8 expected, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)  # filter byte 0
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _chunks(data: bytes):
    i = len(_SIGNATURE)
    while i + 8 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind = data[i + 4:i + 8]
        body = data[i + 8:i + 8 + n]
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        i += 12 + n


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of PNG's filter method 0 (uint8 rows)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum of each pixel's bytes, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each byte needs the decoded one bpp to its left
            ln, up, cur_l = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"PNG row {y}: filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray | None:
    """(H, W, 3) uint8 RGB of a non-interlaced 8-bit grey / RGB (+ alpha)
    PNG; None for another PNG layout (palette, 16-bit, interlaced)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        return None
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}x{ch}")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ch < 3:  # grey (+ alpha)
        px = np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB: PNGs of the layouts above here, the rest by
    OpenCV."""
    with open(path, "rb") as f:
        is_png = f.read(len(_SIGNATURE)) == _SIGNATURE
    if is_png:
        img = read_png(path)
        if img is not None:
            return img
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path} needs OpenCV (cv2), which is not installed; "
                          "use an 8-bit .png") from e
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
