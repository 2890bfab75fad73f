"""PNG frames without OpenCV: a reader and a writer on the standard library's ``zlib``.

:func:`read_png` returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns for the
kinds that datasets store frames in (non-interlaced grey, RGB and RGBA, 8 or 16 bits,
with no transparency chunk): (H, W) for grey and (H, W, C) for colour, colour channels in
BGR(A) order, 16-bit samples as native ``uint16``.  Undoing the scanline filters runs in
C++ (``native/png.cpp``, in the host library of the rasterizer): Sub, Average and Paeth
are serial along a row.  Any other kind (palette, grey with alpha, interlaced, below 8
bits, a ``tRNS`` chunk) is read by ``cv2`` if it is installed, and raises, naming the
kind, where it is not.  :func:`write_png` writes the same kinds, filter 0 on every row.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from m3t_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}
_KIND_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey with alpha", 6: "RGBA"}


def unfilter(data, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The (height, row_bytes) uint8 scanlines of inflated PNG image data (each row a
    filter-type byte and row_bytes filtered bytes); bpp is the bytes per pixel."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, not "
                         f"{height} rows of 1 + {row_bytes}")
    out = np.empty((height, row_bytes), np.uint8)
    bad = native.library().m3t_png_unfilter(raw.ctypes.data_as(ctypes.c_void_p), height,
                                            row_bytes, bpp,
                                            out.ctypes.data_as(ctypes.c_void_p))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {raw[(bad - 1) * (row_bytes + 1)]}")
    return out


def _chunks(blob: bytes, path):
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        yield kind, blob[pos + 8:pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path} ends before its IEND chunk")


def _read_with_cv2(path, kind: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as error:
        raise ImportError(f"{path} is a PNG of {kind}, which the reader leaves to cv2, "
                          f"and cv2 is not installed") from error
    image = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if image is None:
        raise ValueError(f"cv2 could not read {path}")
    return image


def read_png(path) -> np.ndarray:
    """The frame in the PNG file at ``path``, as ``cv2.imread(path, IMREAD_UNCHANGED)``
    returns it."""
    blob = Path(path).read_bytes()
    header, idat, transparency = None, [], False
    for kind, data in _chunks(blob, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[:13])
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"tRNS":
            transparency = True
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace or transparency:
        kind = (f"colour type {colour} ({_KIND_NAMES.get(colour, 'unknown')}), "
                f"bit depth {depth}, interlace {interlace}"
                + (", tRNS transparency" if transparency else ""))
        return _read_with_cv2(path, kind)
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    rows = unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    image = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    image = image.reshape(height, width, channels)
    if channels == 1:
        return image[:, :, 0]
    order = [2, 1, 0, 3][:channels]  # RGB(A) -> BGR(A)
    return np.ascontiguousarray(image[:, :, order])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image, compression: int = 1) -> None:
    """Write a (H, W) grey or (H, W, 3|4) BGR(A) uint8 or uint16 frame as a PNG file
    that ``cv2.imread(path, IMREAD_UNCHANGED)`` reads back equal; ``compression`` is
    zlib's level, 0-9 (cv2's default, 1, unless given)."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16 frames, not {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), not {image.shape}")
    height, width, channels = image.shape
    if channels > 1:
        image = image[:, :, [2, 1, 0, 3][:channels]]  # BGR(A) -> RGB(A)
    depth = 8 * image.dtype.itemsize
    rows = np.ascontiguousarray(image, ">u2" if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, _COLOUR_TYPE[channels], 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), compression))
                           + _chunk(b"IEND", b""))
