"""Image writers: PPM (text) and PNG from the standard library (encoded
against the spec with zlib and struct), JPEG through Pillow
(rt_tpu/io/image.py, without its native path)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_ppm(path: str, u8_topdown: np.ndarray) -> None:
    h, w, _ = u8_topdown.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.writelines(f"{r} {g} {b}\n" for r, g, b in u8_topdown.reshape(-1, 3))


def png_bytes(u8_topdown: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (filter 0 rows + zlib)."""
    img = np.ascontiguousarray(u8_topdown.astype(np.uint8))
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"png_bytes wants [H,W,3] RGB, got {img.shape}")
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, u8_topdown: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(u8_topdown))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG, as png_bytes writes it and as image
    textures come (rt_tpu/io/image.py read_png): every chunk's CRC is
    checked and the rows are unfiltered (None, Sub, Up, Average, Paeth).
    Returns [H,W,3] u8 (alpha dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(tag + payload) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or ihdr[2] != 8 or ihdr[3] not in (2, 6) or ihdr[6]:
        raise ValueError(f"{path}: want an 8-bit RGB or RGBA PNG without "
                         f"interlacing, header {ihdr}")
    w, h = ihdr[0], ihdr[1]
    nc = 3 if ihdr[3] == 2 else 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, nc * w + 1)
    out = np.empty((h, nc * w), np.uint8)
    prev = np.zeros(nc * w, np.int64)
    for y in range(h):
        ftype, row = raw[y, 0], raw[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = row
        elif ftype == 1:    # Sub: a running sum along each channel
            cur = np.cumsum(row.reshape(w, nc), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:    # Up
            cur = (row + prev) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth: byte by byte
            cur = row.copy()
            for i in range(nc * w):
                a = int(cur[i - nc]) if i >= nc else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - nc]) if i >= nc else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, nc)[..., :3].copy()


def write_jpg(path: str, u8_topdown: np.ndarray, quality: int = 95) -> None:
    """JPEG through Pillow, as rt_tpu/io/image.py `write_jpg`: the Taichi
    and naive references write JPEG frames (ti.imwrite out{i}.jpg,
    taichi-version/main.py:216). Pillow is imported here only, so the
    PNG and PPM writers need nothing beyond the standard library."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "JPEG output needs Pillow; write .png or .ppm instead") from e
    Image.fromarray(np.ascontiguousarray(u8_topdown.astype(np.uint8)),
                    "RGB").save(path, quality=quality)


def write_image(path: str, u8_topdown: np.ndarray) -> None:
    """Write by extension: .ppm (text P3), .jpg / .jpeg (Pillow), else
    PNG."""
    if path.endswith(".ppm"):
        write_ppm(path, u8_topdown)
    elif path.endswith((".jpg", ".jpeg")):
        write_jpg(path, u8_topdown)
    else:
        write_png(path, u8_topdown)
