"""Video assembly for animation runs (rt_tpu/io/video.py): the
reference's drivers write frame sequences (gpu-version/blue.py renders
360 PNGs and stops); this turns them into a video.

Backends, best available first:
  - ffmpeg on PATH (H.264 .mp4), when `shutil.which` finds it;
  - an MJPEG AVI writer in Python (Pillow encodes the JPEG frames): a
    RIFF 'AVI ' container of JPEG frames that mainstream players decode;
  - an animated GIF through Pillow for .gif outputs.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
from typing import List, Sequence


def _u32(x: int) -> bytes:
    return struct.pack("<I", x & 0xFFFFFFFF)


def _u16(x: int) -> bytes:
    return struct.pack("<H", x & 0xFFFF)


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + _u32(len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(out_path: str, jpeg_frames: Sequence[bytes],
                    width: int, height: int, fps: int = 30) -> None:
    """Minimal AVI 1.0 (RIFF) writer: one MJPG video stream + idx1."""
    n = len(jpeg_frames)
    max_size = max((len(j) for j in jpeg_frames), default=0)

    avih = _chunk(b"avih", b"".join([
        _u32(1_000_000 // fps),      # dwMicroSecPerFrame
        _u32(max_size * fps),        # dwMaxBytesPerSec
        _u32(0),                     # dwPaddingGranularity
        _u32(0x10),                  # dwFlags: AVIF_HASINDEX
        _u32(n), _u32(0), _u32(1),   # frames, initial, streams
        _u32(max_size),              # dwSuggestedBufferSize
        _u32(width), _u32(height),
        _u32(0) * 4,                 # reserved
    ]))
    strh = _chunk(b"strh", b"".join([
        b"vids", b"MJPG",
        _u32(0), _u16(0), _u16(0),   # flags, priority, language
        _u32(0),                     # initial frames
        _u32(1), _u32(fps),          # scale, rate -> fps
        _u32(0), _u32(n),            # start, length
        _u32(max_size), _u32(0xFFFFFFFF),  # buffer, quality (default)
        _u32(0),                     # sample size
        _u16(0), _u16(0), _u16(width), _u16(height),  # rcFrame
    ]))
    strf = _chunk(b"strf", b"".join([
        _u32(40), _u32(width), _u32(height),
        _u16(1), _u16(24), b"MJPG",
        _u32(width * height * 3),
        _u32(0) * 4,
    ]))
    hdrl = _list(b"hdrl", avih + _list(b"strl", strh + strf))

    movi_payload = b"movi"
    idx = b""
    for j in jpeg_frames:
        # idx1 offsets are relative to the start of the 'movi' fourcc
        idx += b"00dc" + _u32(0x10) + _u32(len(movi_payload)) + _u32(len(j))
        movi_payload += _chunk(b"00dc", j)
    movi = _chunk(b"LIST", movi_payload)
    idx1 = _chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(out_path, "wb") as f:
        f.write(b"RIFF" + _u32(len(riff_payload)) + riff_payload)


def _png_to_jpeg(path: str, quality: int = 92) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.open(path).convert("RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def assemble_video(frame_paths: List[str], out_path: str,
                   fps: int = 30) -> str:
    """Assemble rendered frames into a video file.

    Returns the path actually written (the extension may be adjusted to
    .avi when ffmpeg is unavailable for an .mp4 request)."""
    if not frame_paths:
        raise ValueError("no frames to assemble")
    frame_paths = sorted(frame_paths)

    if shutil.which("ffmpeg") and out_path.endswith(".mp4"):
        listfile = out_path + ".frames.txt"
        with open(listfile, "w") as f:
            for p in frame_paths:
                f.write(f"file '{os.path.abspath(p)}'\nduration {1 / fps}\n")
        subprocess.run(
            ["ffmpeg", "-y", "-f", "concat", "-safe", "0", "-i", listfile,
             "-pix_fmt", "yuv420p", "-r", str(fps), out_path],
            check=True, capture_output=True)
        os.remove(listfile)
        return out_path

    if out_path.endswith(".gif"):
        from PIL import Image

        frames = [Image.open(p).convert("RGB") for p in frame_paths]
        frames[0].save(out_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
        return out_path

    if out_path.endswith(".mp4"):
        out_path = out_path[:-4] + ".avi"
    from PIL import Image

    with Image.open(frame_paths[0]) as im:
        width, height = im.size
    jpegs = [_png_to_jpeg(p) for p in frame_paths]
    write_mjpeg_avi(out_path, jpegs, width, height, fps=fps)
    return out_path
