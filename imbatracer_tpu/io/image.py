"""Image I/O: PNG (zlib), TGA and Radiance HDR (RGBE), all hand-parsed.

Mirrors the reference's loader surface (reference: loaders/loaders.h:13-28,
store_png.h:23-74): `load_image` dispatches by extension, `store_png`
applies weight + gamma tone mapping before 8-bit quantisation.
All images are float32 RGBA in [0, 1] (HDR unbounded), row-major, top-left
origin.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples


def _unfilter_slow(ft: int, row: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) filters, in place (PNG spec §9.2)."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ft == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG -> (H, W, C) uint8 (C = 1, 2, 3 or 4;
    palette images expand to RGB or RGBA)."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}): 8-bit "
                         "non-interlaced only")
    bpp = _PNG_CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ft, row = int(raw[y, 0]), raw[y, 1:]
        if ft == 0:
            cur = row
        elif ft == 1:
            cur = (np.cumsum(row.reshape(width, bpp), axis=0, dtype=np.int64)
                   .astype(np.uint8).reshape(stride))
        elif ft == 2:
            cur = row + prev
        elif ft in (3, 4):
            buf = bytearray(row.tobytes())
            _unfilter_slow(ft, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        out[y] = cur
        prev = out[y]
    img = out.reshape(height, width, bpp)
    if ctype == 3:
        idx = img[..., 0]
        rgb = plte[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[:len(trns)] = trns
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    return img


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3 or 4) uint8 -> PNG bytes (Sub-filtered, zlib level 6)."""
    height, width, ch = img.shape
    ctype = {3: 2, 4: 6}[ch]
    rows = img.reshape(height, width * ch).astype(np.int16)
    sub = rows.copy()
    sub[:, ch:] -= rows[:, :-ch]
    raw = np.concatenate([np.ones((height, 1), np.uint8),
                          (sub & 0xFF).astype(np.uint8)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _to_rgba_float(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 4) float32 in [0, 1]."""
    if img.shape[-1] in (1, 2):  # grey (+ alpha)
        grey = np.repeat(img[..., :1], 3, axis=-1)
        img = np.concatenate([grey, img[..., 1:]], axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return img.astype(np.float32) / 255.0


def load_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return _to_rgba_float(decode_png(f.read()))


def decode_tga(data: bytes) -> np.ndarray:
    """Truecolour or greyscale TGA (types 2, 3, 10, 11; 8/24/32 bits),
    raw or run-length encoded -> (H, W, C) uint8, top-left origin."""
    id_len, cmap_type, itype = data[0], data[1], data[2]
    width, height, bits, desc = struct.unpack("<HHBB", data[12:18])
    if cmap_type != 0 or itype not in (2, 3, 10, 11) or bits not in (8, 24, 32):
        raise ValueError(f"unsupported TGA (type {itype}, {bits} bits)")
    bpp = bits // 8
    pos = 18 + id_len
    count = width * height * bpp
    if itype in (2, 3):
        pix = np.frombuffer(data, np.uint8, count, pos)
    else:
        out = bytearray()
        while len(out) < count:
            head = data[pos]
            pos += 1
            n = (head & 0x7F) + 1
            if head & 0x80:
                out += data[pos:pos + bpp] * n
                pos += bpp
            else:
                out += data[pos:pos + n * bpp]
                pos += n * bpp
        pix = np.frombuffer(bytes(out[:count]), np.uint8)
    img = pix.reshape(height, width, bpp)
    if bpp >= 3:  # stored BGR(A)
        img = img[..., [2, 1, 0] + ([3] if bpp == 4 else [])]
    if not desc & 0x20:  # bottom-left origin
        img = img[::-1]
    return np.ascontiguousarray(img)


def load_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return _to_rgba_float(decode_tga(f.read()))


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE) decoder, incl. adaptive RLE scanlines.

    Replaces the reference's hand parser (reference: loaders/load_hdr.cpp,
    HDRPixel decode at :18-33).  Returns (H, W, 4) float32, alpha=1.
    """
    with open(path, "rb") as f:
        data = f.read()

    # Header: lines until the blank line, then the resolution line.
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            # Flat (non-RLE) scanline.
            row = buf[bp : bp + width * 4].reshape(width, 4)
            rgbe[y] = row
            bp += width * 4
            continue
        if (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != width:
            raise ValueError("HDR scanline length mismatch")
        bp += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bp])
                bp += 1
                if count > 128:  # run
                    count -= 128
                    rgbe[y, x : x + count, c] = buf[bp]
                    bp += 1
                else:  # literal
                    rgbe[y, x : x + count, c] = buf[bp : bp + count]
                    bp += count
                x += count

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    out = np.empty((height, width, 4), np.float32)
    out[..., :3] = (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
    out[..., 3] = 1.0
    return out


def load_image(path: str) -> np.ndarray | None:
    """Dispatch by extension; returns None on failure (caller substitutes a
    placeholder, reference: frontend/build_scene.cpp:136)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg", ".bmp"):
        raise ImportError(
            f"{path}: JPEG and BMP textures need the Pillow package, which "
            "this renderer does not depend on; convert the texture to PNG "
            "or TGA")
    try:
        if ext == ".png":
            return load_png(path)
        if ext == ".tga":
            return load_tga(path)
        if ext in (".hdr", ".pic"):
            return load_hdr(path)
    except (OSError, ValueError):
        return None
    return None


def store_png(path: str, img: np.ndarray, weight: float = 1.0, gamma: float = 1.0 / 2.2,
              alpha: bool = False) -> None:
    """Tone-map (`pow(v * weight, gamma)`) and write 8-bit PNG, matching the
    reference writer (reference: loaders/store_png.h:34-49)."""
    rgb = np.clip(np.power(np.maximum(img[..., :3] * weight, 0.0), gamma), 0.0, 1.0)
    out = (rgb * 255.0 + 0.5).astype(np.uint8)
    if alpha and img.shape[-1] >= 4:
        a = (np.clip(img[..., 3] * weight, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        out = np.concatenate([out, a[..., None]], axis=-1)
    with open(path, "wb") as f:
        f.write(encode_png(out))


def magenta_placeholder(size: int = 4) -> np.ndarray:
    """Texture-load-failure placeholder (reference: build_scene.cpp:136,152)."""
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0] = 1.0
    img[..., 2] = 1.0
    img[..., 3] = 1.0
    return img
