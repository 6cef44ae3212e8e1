"""Minimal OpenEXR scanline I/O in pure Python: the port's copy of
``yuki_tpu/app/exr.py`` (the port imports nothing of ``yuki_tpu``).

The reference uses the `exr` crate for headless/raw output
(app/util.rs:90-111).  This writes/reads uncompressed (NO_COMPRESSION)
float32 RGB scanline EXRs — version 2 files readable by every EXR tool —
and reads back the same subset plus what it wrote (for golden-image tests).
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630


def _attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_name.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def _channels_rgb() -> bytes:
    # Channels must be alphabetically sorted: B, G, R. pixel type 2 = FLOAT.
    out = b""
    for ch in (b"B", b"G", b"R"):
        out += ch + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    return out + b"\x00"


def write_exr(path: str, pixels) -> None:
    """pixels: [h, w, 3] float32 RGB, a numpy array or a tensor on any
    device."""
    if hasattr(pixels, "detach"):
        pixels = pixels.detach().cpu().numpy()
    img = np.ascontiguousarray(pixels, dtype=np.float32)
    h, w, _ = img.shape
    header = b""
    header += _attr("channels", "chlist", _channels_rgb())
    header += _attr("compression", "compression", struct.pack("<B", 0))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<ii", _MAGIC, 2)
    offset_table_pos = len(preamble) + len(header)
    offset_table_size = 8 * h
    data_start = offset_table_pos + offset_table_size

    scanline_bytes = 8 + 3 * 4 * w  # y + size prefix, then B,G,R planes
    offsets = [data_start + y * scanline_bytes for y in range(h)]

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        f.write(struct.pack(f"<{h}q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            f.write(img[y, :, 2].tobytes())  # B
            f.write(img[y, :, 1].tobytes())  # G
            f.write(img[y, :, 0].tobytes())  # R


def read_exr(path: str) -> np.ndarray:
    """Reads uncompressed float32/half RGB scanline EXRs -> [h,w,3] f32."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        nul = buf.index(b"\x00", pos)
        name = buf[pos:nul].decode()
        pos = nul + 1
        nul = buf.index(b"\x00", pos)
        tname = buf[pos:nul].decode()
        pos = nul + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (tname, buf[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    if struct.unpack_from("<B", attrs["compression"][1])[0] != 0:
        raise ValueError("only NO_COMPRESSION EXRs supported")
    x0, y0, x1, y1 = struct.unpack_from("<iiii", attrs["dataWindow"][1])
    w = x1 - x0 + 1
    h = y1 - y0 + 1

    # Parse channel list: (name, pixel_type) in file order (alphabetical).
    chdata = attrs["channels"][1]
    chans = []
    cpos = 0
    while chdata[cpos] != 0:
        nul = chdata.index(b"\x00", cpos)
        cname = chdata[cpos:nul].decode()
        ptype = struct.unpack_from("<i", chdata, nul + 1)[0]
        chans.append((cname, ptype))
        cpos = nul + 1 + 16
    dtype_of = {1: (np.float16, 2), 2: (np.float32, 4)}

    pos += 8 * h  # skip offset table; scanlines are sequential
    planes = {c: np.zeros((h, w), np.float32) for c, _ in chans}
    for _ in range(h):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        for cname, ptype in chans:
            dt, nbytes = dtype_of[ptype]
            row = np.frombuffer(buf, dtype=dt, count=w, offset=pos)
            planes[cname][y - y0] = row.astype(np.float32)
            pos += nbytes * w
    out = np.zeros((h, w, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in planes:
            out[..., i] = planes[c]
    return out
