"""Dependency-free image IO: PNG (zlib) and Radiance HDR (RGBE).

Port of ``photorealistic_rendering_using_opencl_tpu/utils/image.py``:
``png_bytes``, ``write_png``, ``read_png``, ``write_hdr``, ``read_hdr`` and
``save_image``, byte for byte.  Numpy in and out; pass a tensor through
``.cpu().numpy()`` first.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def png_bytes(img: np.ndarray) -> bytes:
    """Encode [H,W,3|4] uint8 or float in [0,1] as PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H,W,3|4] uint8 or float in [0,1]."""
    with open(path, "wb") as fh:
        fh.write(png_bytes(img))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit, no interlace) -> uint8 [H,W,C]."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = bitd = ctype = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bitd, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if bitd != 8 or interlace != 0:
                raise ValueError(f"{path}: only 8-bit, non-interlaced PNGs")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + ln
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 2:  # up
            cur = (line + prev).astype(np.uint8)
        elif filt in (1, 3, 4):
            cur = np.zeros(stride, np.uint8)
            for x in range(stride):
                a = cur[x - nch] if x >= nch else 0
                b = prev[x]
                cc = prev[x - nch] if x >= nch else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (int(a) + int(b)) // 2
                else:
                    p = int(a) + int(b) - int(cc)
                    pa, pb, pc = abs(p - int(a)), abs(p - int(b)), abs(p - int(cc))
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (int(line[x]) + int(pred)) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, nch)


# ---------------------------------------------------------------------------
# Radiance HDR (RGBE)
# ---------------------------------------------------------------------------

def write_hdr(path: str, img: np.ndarray) -> None:
    """img: [H,W,3] float linear radiance."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=2)
    frac, exp = np.frexp(np.maximum(maxc, 1e-32))
    scale = frac * 256.0 / np.maximum(maxc, 1e-32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    nz = maxc >= 1e-32
    for c in range(3):
        rgbe[..., c] = np.where(nz, np.minimum(img[..., c] * scale, 255.0),
                                0).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode())
        fh.write(rgbe.tobytes())  # flat (uncompressed) scanlines


def read_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (flat or RLE scanlines) -> float32 [H,W,3]."""
    with open(path, "rb") as fh:
        data = fh.read()
    # header
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"-Y") or line.startswith(b"+Y"):
            parts = line.split()
            h = int(parts[1])
            w = int(parts[3])
            break
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            # adaptive RLE scanline
            pos += 4
            row = np.zeros((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:  # run
                        row[c, x:x + cnt - 128] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:  # literal
                        row[c, x:x + cnt] = np.frombuffer(
                            data[pos:pos + cnt], np.uint8)
                        pos += cnt
                        x += cnt
            rgbe[y] = row.T
        else:
            rgbe[y] = np.frombuffer(data[pos:pos + 4 * w],
                                    np.uint8).reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    # (m + 0.5) * 2^(e-136) has at most 9 significant bits and an exponent
    # inside float32's range: the cast is exact
    return ((rgbe[..., :3].astype(np.float32) + 0.5)
            * scale[..., None]).astype(np.float32)


def save_image(path: str, img, encoder: int = 0) -> None:
    """saveImage parity (cl_gl_interop.h:144-160): 0 -> png, 1 -> hdr."""
    img = np.asarray(img)
    if encoder == 1 or path.endswith(".hdr"):
        write_hdr(path if path.endswith(".hdr") else path + ".hdr", img)
    else:
        write_png(path if path.endswith(".png") else path + ".png", img)
