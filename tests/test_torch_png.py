"""The port's PNG reader and writer (m3t_tpu_torch/utils/png.py) against OpenCV.

The reader must return exactly what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns
(dtype, shape, BGR(A) order, every sample) on files that ``cv2.imwrite`` writes at every
compression level and with every compression strategy, for 8-bit BGR, BGRA and grey and
16-bit grey and BGR frames of odd and full sizes; the C++ unfilter must equal a numpy
version of the five PNG filters on random rows, each filter forced; cv2 must read the
writer's files back equal; and a kind that the reader leaves to cv2 must raise, naming
the kind, where cv2 is absent.
"""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from m3t_tpu_torch import camera
from m3t_tpu_torch.utils import png

KINDS = {  # name -> (channels or None for (H, W), dtype)
    "bgr8": (3, np.uint8), "bgra8": (4, np.uint8), "grey8": (None, np.uint8),
    "grey16": (None, np.uint16), "bgr16": (3, np.uint16),
}
SIZES = [(1, 1), (3, 5), (121, 161), (512, 640)]  # (H, W)
LEVELS = range(10)
STRATEGIES = (cv2.IMWRITE_PNG_STRATEGY_DEFAULT, cv2.IMWRITE_PNG_STRATEGY_FILTERED,
              cv2.IMWRITE_PNG_STRATEGY_HUFFMAN_ONLY, cv2.IMWRITE_PNG_STRATEGY_RLE,
              cv2.IMWRITE_PNG_STRATEGY_FIXED)


def _frame(kind, size, seed=0):
    """Bands of rows that suit each of libpng's adaptive filter choices (zeros, noise,
    ramps along x, y and the diagonal, a half-rate ramp with noise), so that a file
    written by cv2 uses all five filters."""
    channels, dtype = KINDS[kind]
    h, w = size
    rng = np.random.default_rng(seed)
    scale = 1 if dtype == np.uint8 else 257
    y, x = np.mgrid[:h, :w]
    bands = [np.zeros((h, w), np.int64), rng.integers(0, 256 * scale, (h, w)),
             (x * 7 + y * 3) * scale, ((x // 2) * 3 + rng.integers(0, 3, (h, w))) * scale,
             (y * 5 + rng.integers(0, 2, (h, w))) * scale, (x + y) * 2 * scale]
    image = np.choose(np.minimum(y * len(bands) // h, len(bands) - 1), bands)
    if channels is not None:
        image = image[..., None] + 40 * scale * np.arange(channels)
    return (image % (256 * scale)).astype(dtype)


def _filters_used(path) -> set:
    """The filter types of the rows of a non-interlaced PNG written by cv2."""
    blob = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + length
    width, height, depth, colour = header[:4]
    row = width * {0: 1, 2: 3, 6: 4}[colour] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw[::row + 1][:height].tolist())


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_reader_equals_cv2_imread(tmp_path, kind, size):
    image = _frame(kind, size)
    path = tmp_path / "frame.png"
    settings = ([(level, cv2.IMWRITE_PNG_STRATEGY_DEFAULT) for level in LEVELS]
                + [(6, strategy) for strategy in STRATEGIES])
    filters = set()
    for level, strategy in settings:
        assert cv2.imwrite(str(path), image, [cv2.IMWRITE_PNG_COMPRESSION, level,
                                              cv2.IMWRITE_PNG_STRATEGY, strategy])
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        got = png.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (level, strategy)
        np.testing.assert_array_equal(got, want, err_msg=f"level {level}, {strategy}")
        filters |= _filters_used(path)
    if size == (121, 161):
        assert filters == {0, 1, 2, 3, 4}, filters


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_writer_reads_back_through_cv2(tmp_path, kind, size):
    image = _frame(kind, size, seed=1)
    for level in (0, 1, 9):
        path = tmp_path / f"w{level}.png"
        png.write_png(path, image, compression=level)
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert want.dtype == image.dtype and want.shape == image.shape
        np.testing.assert_array_equal(want, image)
        np.testing.assert_array_equal(png.read_png(path), image)


def _unfilter_numpy(data, height, row_bytes, bpp):
    """The five PNG filters undone byte by byte (PNG specification, section 9)."""
    data = np.frombuffer(data, np.uint8).reshape(height, row_bytes + 1).astype(np.int64)
    out = np.zeros((height, row_bytes), np.int64)
    for y in range(height):
        kind, row = data[y, 0], data[y, 1:]
        up = out[y - 1] if y else np.zeros(row_bytes, np.int64)
        for x in range(row_bytes):
            a = out[y, x - bpp] if x >= bpp else 0
            b = up[x]
            c = up[x - bpp] if x >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, x] = (row[x] + pred) & 0xFF
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("forced", [0, 1, 2, 3, 4, None])
def test_native_unfilter_equals_numpy(forced, bpp):
    """Random filtered rows, every row with the forced filter (None: a random filter per
    row), through the C++ unfilter and the numpy version."""
    rng = np.random.default_rng(bpp * 10 + (forced if forced is not None else 9))
    height, row_bytes = 9, bpp * 13
    data = rng.integers(0, 256, (height, row_bytes + 1), np.uint8)
    data[:, 0] = forced if forced is not None else rng.integers(0, 5, height)
    np.testing.assert_array_equal(png.unfilter(data.tobytes(), height, row_bytes, bpp),
                                  _unfilter_numpy(data.tobytes(), height, row_bytes, bpp))


def test_unfilter_rejects_a_bad_filter_type():
    data = np.zeros((3, 5), np.uint8)
    data[1, 0] = 7
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        png.unfilter(data.tobytes(), 3, 4, 1)


def test_palette_png_needs_cv2(tmp_path, monkeypatch):
    """A palette PNG goes to cv2; with cv2 hidden it raises, naming its kind."""
    path = tmp_path / "palette.png"
    rows = np.zeros((2, 3), np.uint8)  # filter 0, two palette indices
    rows[:, 1:] = [[0, 1], [1, 0]]
    header = struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0)
    palette = bytes([255, 0, 0, 0, 0, 255])
    path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", header)
                     + png._chunk(b"PLTE", palette)
                     + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
                     + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png(path),
                                  cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="colour type 3 \\(palette\\), bit depth 8"):
        png.read_png(path)


def test_loader_cameras_read_and_save_png_without_cv2(tmp_path, monkeypatch):
    """With cv2 hidden, the loader cameras replay PNG frames written by cv2 (BGR and
    16-bit depth) and save them through the writer; a missing frame ends the sequence."""
    colour, depth = _frame("bgr8", (121, 161)), _frame("grey16", (121, 161))
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"color{i}.png"), np.roll(colour, i, axis=1))
        cv2.imwrite(str(tmp_path / f"depth{i}.png"), np.roll(depth, i, axis=0))
    monkeypatch.setitem(sys.modules, "cv2", None)
    save = tmp_path / "saved"
    save.mkdir()
    cams = [camera.LoaderColorCamera("c", load_directory=str(tmp_path),
                                     image_name_pre="color"),
            camera.LoaderDepthCamera("d", load_directory=str(tmp_path),
                                     image_name_pre="depth", depth_scale=0.001)]
    for cam, frame, axis in zip(cams, (colour, depth), (1, 0)):
        assert cam.SetUp()
        cam.StartSavingImages(str(save))
        for i in range(2):
            assert cam.UpdateImage()
            np.testing.assert_array_equal(cam.image, np.roll(frame, i, axis=axis))
        assert not cam.UpdateImage()
    monkeypatch.undo()
    for cam, frame, axis in zip(cams, (colour, depth), (1, 0)):
        for i in range(2):
            np.testing.assert_array_equal(
                cv2.imread(str(save / f"{cam.name}_image_{i}.png"), cv2.IMREAD_UNCHANGED),
                np.roll(frame, i, axis=axis))
