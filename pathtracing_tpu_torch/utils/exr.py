"""Minimal OpenEXR 2.0 writer and reader (the JAX package's
``utils/exr.py``; stdlib only): linear float RGB.

Scope: single-part scanline images, three FLOAT channels (B, G, R, in the
spec's alphabetical order), no compression. The reader handles what the
writer emits; it is not a general EXR loader.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_VERSION = 2
_PIXEL_FLOAT = 2  # pixel type enum: 0=UINT, 1=HALF, 2=FLOAT


def _attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(payload)) \
        + payload


def _channel_list() -> bytes:
    out = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, required by the spec
        out += name + b"\0"
        out += struct.pack("<iBBBBii", _PIXEL_FLOAT, 0, 0, 0, 0, 1, 1)
    return out + b"\0"


def encode_exr(rgb: np.ndarray) -> bytes:
    """Linear (H, W, 3) float array → uncompressed scanline EXR bytes."""
    rgb = np.asarray(rgb, np.float32)
    h, w, c = rgb.shape
    assert c == 3, "encode_exr expects (H, W, 3)"

    header = struct.pack("<ii", _MAGIC, _VERSION)
    header += _attr(b"channels", b"chlist", _channel_list())
    header += _attr(b"compression", b"compression", b"\0")  # NONE
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float",
                    struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    # Scanline blocks: [y int32][byte count int32][B row][G row][R row].
    row_bytes = 8 + 3 * 4 * w
    base = len(header) + 8 * h  # offsets table follows the header
    offsets = b"".join(
        struct.pack("<Q", base + y * row_bytes) for y in range(h)
    )
    blocks = bytearray()
    for y in range(h):
        blocks += struct.pack("<ii", y, 3 * 4 * w)
        blocks += rgb[y, :, 2].tobytes()  # B
        blocks += rgb[y, :, 1].tobytes()  # G
        blocks += rgb[y, :, 0].tobytes()  # R
    return header + offsets + bytes(blocks)


def write_exr(path: str, rgb) -> None:
    with open(path, "wb") as f:
        f.write(encode_exr(np.asarray(rgb)))


def read_exr(path: str) -> np.ndarray:
    """Read an EXR produced by ``encode_exr`` → (H, W, 3) float32 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    assert magic == _MAGIC, "not an EXR file"
    assert version & 0xFF == 2 and not version & 0x200, \
        "reader supports single-part scanline EXR only"
    pos = 8
    w = h = None
    channels = []
    compression = None
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        name = data[pos:name_end]
        pos = name_end + 1
        type_end = data.index(b"\0", pos)
        typ = data[pos:type_end]
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == b"dataWindow":
            x0, y0, x1, y1 = struct.unpack("<iiii", payload)
            w, h = x1 - x0 + 1, y1 - y0 + 1
        elif name == b"compression":
            compression = payload[0]
        elif name == b"channels":
            cpos = 0
            while payload[cpos] != 0:
                cend = payload.index(b"\0", cpos)
                cname = payload[cpos:cend].decode()
                (ptype,) = struct.unpack_from("<i", payload, cend + 1)
                channels.append((cname, ptype))
                cpos = cend + 1 + 16
        _ = typ
    pos += 1  # header terminator
    assert compression == 0, "reader supports uncompressed EXR only"
    assert [c for c, _ in channels] == ["B", "G", "R"] and all(
        t == _PIXEL_FLOAT for _, t in channels
    ), "reader supports FLOAT B,G,R channels only"
    offsets = struct.unpack_from(f"<{h}Q", data, pos)
    img = np.empty((h, w, 3), np.float32)
    for y, off in enumerate(offsets):
        yy, nbytes = struct.unpack_from("<ii", data, off)
        assert nbytes == 3 * 4 * w
        row = np.frombuffer(data, np.float32, 3 * w, off + 8)
        img[yy, :, 2] = row[:w]
        img[yy, :, 1] = row[w:2 * w]
        img[yy, :, 0] = row[2 * w:]
    return img
