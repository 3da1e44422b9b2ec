"""Uncompressed AVI in numpy: a reader and a writer.

The machine with the card has neither OpenCV's native library nor `cv2`, so
the port reads uncompressed AVI itself: a RIFF `AVI ` file whose video
stream holds raw frames of 24 or 32 bits (`BI_RGB`, BGR or BGRA rows,
bottom-up unless the height is negative, each row padded to 4 bytes; or the
`RGBA` / `BGRA` fourccs that OpenCV's FFmpeg writer uses, top-down). Frames
read here equal OpenCV's for the same file, byte for byte. `write_avi`
writes files that OpenCV reads back exactly.
"""

from __future__ import annotations

import struct
from fractions import Fraction

import numpy as np

# biCompression -> (bytes a pixel, channel order of the stored bytes,
# rows bottom-up when the height is positive)
_RAW = {0: None, b"RGBA": (4, "RGBA", False), b"BGRA": (4, "BGRA", False)}


class AviFormatError(ValueError):
    """The file is not an AVI this reader decodes; `kind` names what was
    found (a fourcc, or what is missing)."""

    def __init__(self, message: str, kind: str = "unreadable"):
        super().__init__(message)
        self.kind = kind


def sniff_format(path: str) -> str:
    """'avi-raw' for an uncompressed AVI this module reads; otherwise a short
    name of what the file is ('avi-<fourcc>', or 'unknown')."""
    with open(path, "rb") as f:
        head = f.read(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
        return "unknown"
    try:
        _parse(path)
    except AviFormatError as e:
        return f"avi-{e.kind}"
    return "avi-raw"


def _chunks(buf: memoryview, off: int, end: int):
    """(fourcc, data offset, size, list type or None) of the chunks in
    buf[off:end]."""
    while off + 8 <= end:
        cid = bytes(buf[off:off + 4])
        size = struct.unpack_from("<I", buf, off + 4)[0]
        if cid in (b"RIFF", b"LIST"):
            yield cid, off + 12, size - 4, bytes(buf[off + 8:off + 12])
        else:
            yield cid, off + 8, size, None
        off += 8 + size + (size & 1)


def _parse(path: str) -> dict:
    data = np.memmap(path, np.uint8, mode="r")
    buf = memoryview(data)
    video = None           # (stream number, fps, width, height, bpp, order, bottom_up)
    frames: list[tuple[int, int]] = []

    def walk(off, end, depth):
        nonlocal video
        stream = 0
        for cid, doff, size, ltype in _chunks(buf, off, end):
            if cid in (b"RIFF", b"LIST"):
                if ltype == b"strl":
                    hdr = _stream(buf, doff, doff + size, stream)
                    if hdr is not None and video is None:
                        video = hdr
                    stream += 1
                else:
                    walk(doff, doff + size, depth + 1)
            elif (video is not None and len(cid) == 4
                  and cid[:2] == b"%02d" % video[0] and cid[2:] in (b"db", b"dc")):
                frames.append((doff, size))

    walk(0, len(data), 0)
    if video is None:
        raise AviFormatError(f"{path}: no video stream", "novideo")
    return {"data": data, "video": video, "frames": frames}


def _stream(buf, off, end, number):
    strh = strf = None
    for cid, doff, size, _ in _chunks(buf, off, end):
        if cid == b"strh":
            strh = (doff, size)
        elif cid == b"strf":
            strf = (doff, size)
    if strh is None or bytes(buf[strh[0]:strh[0] + 4]) != b"vids":
        return None
    scale, rate = struct.unpack_from("<II", buf, strh[0] + 20)
    if strf is None or strf[1] < 40:
        raise AviFormatError("video stream without a BITMAPINFOHEADER", "nobih")
    (_, width, height, _, bpp, comp) = struct.unpack_from("<IiiHHI", buf,
                                                          strf[0])
    tag = struct.pack("<I", comp)
    if comp == 0:
        if bpp not in (24, 32):
            raise AviFormatError(f"BI_RGB with {bpp} bits a pixel", f"rgb{bpp}")
        spec = (bpp // 8, "BGR" if bpp == 24 else "BGRA", height > 0)
    elif tag in _RAW and bpp == 32:
        spec = _RAW[tag]
    else:
        name = tag.decode("latin-1").strip("\0 ") or str(comp)
        raise AviFormatError(f"video codec {name!r} is not uncompressed", name)
    fps = rate / scale if scale else 0.0
    return (number, fps, width, abs(height)) + spec


def read_avi(path: str):
    """-> (fps, frame count, frame(i) -> [H,W,3] uint8 RGB). Raises
    AviFormatError when the file is not an uncompressed AVI."""
    info = _parse(path)
    data, (_, fps, w, h, px, order, bottom_up) = info["data"], info["video"]
    frames = info["frames"]
    stride = (w * px + 3) // 4 * 4 if order in ("BGR", "BGRA") else w * px
    rgb = [order.index(ch) for ch in "RGB"]

    def frame(i: int) -> np.ndarray:
        off, size = frames[i]
        if size < stride * h:
            raise AviFormatError(
                f"{path}: frame {i} holds {size} bytes, not {stride * h}",
                "short")
        rows = np.asarray(data[off:off + stride * h]).reshape(h, stride)
        pix = rows[:, :w * px].reshape(h, w, px)
        if bottom_up:
            pix = pix[::-1]
        return np.ascontiguousarray(pix[..., rgb])

    return fps, len(frames), frame


def write_avi(path: str, frames, fps: float, bits: int = 32) -> None:
    """frames: iterable of [H,W,3] uint8 RGB -> an uncompressed AVI, one
    '00db' chunk a frame, with an idx1 index. bits=32 (the default) writes
    the `RGBA` fourcc top-down, as OpenCV's FFmpeg writer does; bits=24 a
    `BI_RGB` BGR file, bottom-up, rows padded to 4 bytes (OpenCV's native
    library reads it; the FFmpeg of some cv2 wheels does not)."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("write_avi needs at least one frame")
    if bits not in (24, 32):
        raise ValueError(f"bits must be 24 or 32, got {bits}")
    h, w, _ = frames[0].shape
    stride = w * 4 if bits == 32 else (w * 3 + 3) // 4 * 4
    size = stride * h
    rate = Fraction(fps).limit_denominator(1001000)
    movi, index, pos = [], [], 4
    for f in frames:
        if f.shape != (h, w, 3):
            raise ValueError(f"frame of shape {f.shape}, expected {(h, w, 3)}")
        if bits == 32:
            body = np.full((h, w, 4), 255, np.uint8)
            body[..., :3] = f
        else:
            body = np.zeros((h, stride), np.uint8)
            body[:, :w * 3] = f[::-1, :, ::-1].reshape(h, w * 3)
        movi.append(b"00db" + struct.pack("<I", size) + body.tobytes())
        index.append(struct.pack("<4sIII", b"00db", 0x10, pos, size))
        pos += 8 + size
    tag = b"RGBA" if bits == 32 else b"\0\0\0\0"
    avih = struct.pack("<IIIIIIIIII16x", int(1e6 / fps), 0, 0, 0x10,
                       len(frames), 0, 1, size, w, h)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", tag, 0, 0, 0,
                       0, rate.denominator, rate.numerator, 0, len(frames),
                       size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits,
                       struct.unpack("<I", tag)[0], size, 0, 0, 0, 0)

    def chunk(cid, body):
        return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    def lst(ltype, body):
        return b"LIST" + struct.pack("<I", len(body) + 4) + ltype + body

    strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)
    body = (b"AVI " + hdrl + lst(b"movi", b"".join(movi))
            + chunk(b"idx1", b"".join(index)))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
