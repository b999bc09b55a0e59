"""PNG codec and the few image operations the dataset contract needs.

8-bit, non-interlaced PNGs in gray (L), gray+alpha (LA), RGB and RGBA,
with the standard library's zlib. The writer filters every row with
'Up' (vectorized both ways); the reader takes all five filter types,
as other encoders pick them per row.

`resize`, `to_gray` and `rotate_270` reproduce Pillow's `Image.resize`
(its separable convolution with 22-bit fixed-point coefficients and a
rounding to 8 bits between the horizontal and the vertical pass),
`Image.convert("L")` and `Image.transpose(ROTATE_270)` pixel for pixel,
so datasets decode to the values the reference's torchvision pipeline
saw.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG color type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (
        struct.pack(">I", len(data))
        + body
        + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray, compress_level: int = 1) -> bytes:
    """uint8 (H, W) or (H, W, 1|2|3|4) -> PNG bytes."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"unsupported PNG pixel shape {img.shape}")
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c)
    up = rows.copy()
    up[1:] -= rows[:-1]  # 'Up' filter, modulo 256 by uint8 wraparound
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img: np.ndarray, compress_level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, compress_level))


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) for gray, else (H, W, C)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, color type {color}, "
            f"interlace {interlace} (8-bit non-interlaced L/LA/RGB/RGBA only)"
        )
    c = _CHANNELS[color]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    filters, rows = raw[:, 0], raw[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = filters[y], rows[y]
        if f == 0:
            cur = line
        elif f == 1:
            cur = (
                np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint64) & 0xFF
            ).astype(np.uint8).reshape(stride)
        elif f == 2:
            cur = line + prev
        elif f in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if f == 3 else _paeth_row)(buf, prev.tobytes(), c)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {f} in row {y}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def drop_alpha(img: np.ndarray) -> np.ndarray:
    """The L or RGB channels of an LA or RGBA image (as Pillow's
    convert("L") ignores alpha); other images unchanged."""
    if img.ndim == 3 and img.shape[2] in (2, 4):
        return img[:, :, :-1]
    return img


def to_gray(img: np.ndarray) -> np.ndarray:
    """Pillow's convert("L"): ITU-R 601-2 luma in 16-bit fixed point;
    alpha is dropped."""
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:  # L or LA
        return img[:, :, 0]
    rgb = img[:, :, :3].astype(np.uint32)
    luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
    return ((luma + 0x8000) >> 16).astype(np.uint8)


def rotate_270(img: np.ndarray) -> np.ndarray:
    """Pillow's transpose(ROTATE_270): 90 degrees clockwise."""
    return np.ascontiguousarray(np.rot90(img, -1))


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0),
    )


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}
_PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int, kind: str):
    """First source index (out,) and fixed-point weights (out, taps) of
    one resampling pass — Pillow's precompute_coeffs and
    normalize_coeffs_8bpc."""
    fn, support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    centers = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(centers - support + 0.5).astype(np.int64), 0)
    count = np.minimum(
        np.trunc(centers + support + 0.5).astype(np.int64), in_size
    ) - xmin
    taps = np.arange(ksize)
    used = taps[None, :] < count[:, None]
    w = fn(((taps[None, :] + xmin[:, None]) - centers[:, None] + 0.5)
           * (1.0 / filterscale))
    w = np.where(used, w, 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):  # sequential sum, as Pillow accumulates
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0, 1, total)[:, None], w)
    fixed = w * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return xmin, np.where(used, fixed, 0)


def _pass(img: np.ndarray, in_size: int, out_size: int, kind: str, axis: int):
    xmin, weights = _coefficients(in_size, out_size, kind)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    extra = (1,) * (src.ndim - 1)
    acc = np.full(src.shape[:0] + (out_size,) + src.shape[1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(weights.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        acc += src[idx] * weights[:, k].reshape((out_size,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize(img: np.ndarray, size, kind: str = "bilinear") -> np.ndarray:
    """Pillow's Image.resize((width, height), BILINEAR|BICUBIC) for uint8
    L or RGB images: the horizontal pass first, rounded to 8 bits, then
    the vertical pass."""
    out_w, out_h = size
    h, w = img.shape[:2]
    if img.ndim == 3 and img.shape[2] not in (1, 3):
        raise ValueError("resize takes L or RGB images (alpha is not supported)")
    if (w, h) == (out_w, out_h):
        return img.copy()
    out = img
    if out_w != w:
        out = _pass(out, w, out_w, kind, axis=1)
    if out_h != h:
        out = _pass(out, h, out_h, kind, axis=0)
    return out
