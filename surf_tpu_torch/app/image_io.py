"""Image output (port of ``surf_tpu.app.image_io``; NumPy and zlib only):
U32 pixel packing, sqrt display gamma, PNG/NPY writers.

Replaces the reference's present path (PixelBuffer -> staging -> swapchain,
SURVEY.md §2 'Pixel buffer + present'): on a headless machine the output
surface is a file.  Semantics replicated:
- RgbaToU32 (sources/surf_math.cpp:13-29): round-to-nearest, saturate to
  [0,255] (the SSE packus path);
- display gamma = sqrt (shaders/fs_quad.frag:13) applied at write time.

The PNG encoder is self-contained (zlib + struct) — no imaging deps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def rgba_to_u32(color: np.ndarray) -> np.ndarray:
    """Pack [..., 4] float RGBA into uint32 ABGR words like RgbaToU32
    (surf_math.cpp:23-27: cvtps rounds to nearest even, packus saturates)."""
    c = np.rint(np.asarray(color, np.float32) * np.float32(255.0))
    c = np.clip(c, 0, 255).astype(np.uint32)
    return (
        (c[..., 3] << 24) | (c[..., 2] << 16) | (c[..., 1] << 8) | c[..., 0]
    ).astype(np.uint32)


def tonemap(img: np.ndarray, gamma_sqrt: bool = True) -> np.ndarray:
    """Resolved radiance -> displayable u8 RGB (sqrt gamma per fs_quad.frag)."""
    img = np.asarray(img, np.float32)
    img = np.clip(img, 0.0, None)
    if gamma_sqrt:
        img = np.sqrt(img)
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Minimal RGB8 PNG writer."""
    img_u8 = np.asarray(img_u8)
    if img_u8.ndim == 2:
        img_u8 = np.stack([img_u8] * 3, axis=-1)
    h, w, c = img_u8.shape
    assert c == 3 and img_u8.dtype == np.uint8

    def chunk(tag: bytes, data: bytes) -> bytes:
        block = tag + data
        return struct.pack(">I", len(data)) + block + struct.pack(
            ">I", zlib.crc32(block) & 0xFFFFFFFF
        )

    raw = b"".join(
        b"\x00" + img_u8[y].tobytes() for y in range(h)
    )
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal RGB8 PNG reader (for round-trip tests)."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype == 2
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(w * 3, np.int64)
    for y in range(h):
        row = raw[y * stride: (y + 1) * stride]
        filt, line = row[0], np.frombuffer(row[1:], np.uint8).astype(np.int64)
        if filt == 0:
            cur = line
        elif filt == 1:
            cur = line.copy()
            for i in range(3, len(cur)):
                cur[i] = (cur[i] + cur[i - 3]) % 256
        elif filt == 2:
            cur = (line + prev) % 256
        else:
            raise NotImplementedError(f"PNG filter {filt}")
        out[y] = cur.reshape(w, 3).astype(np.uint8)
        prev = cur
    return out


def save_image(path: str, resolved: np.ndarray, gamma_sqrt: bool = True) -> None:
    """Write a resolved radiance image to .png or .npy by extension."""
    if path.endswith(".npy"):
        np.save(path, np.asarray(resolved, np.float32))
    elif path.endswith(".png"):
        write_png(path, tonemap(resolved, gamma_sqrt=gamma_sqrt))
    else:
        raise ValueError(f"unsupported image extension: {path}")
