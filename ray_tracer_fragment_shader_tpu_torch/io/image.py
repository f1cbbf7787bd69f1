"""Image export.

Replaces the reference's output path: immediate-mode GL point plotting
(``glColor3d``/``glVertex2i``, Hw4/MySdlApplication.cpp:1312-1314) and the
in-tree-but-dead PPM writer (``writePpmScreenshot``, Hw4/ppm.cpp:15-25).

Renders come out of the core in GL screen coordinates (row j=0 = bottom
scanline); writers flip to top-down raster order.  Colors are accumulated
unclamped like the reference (GL clamps at rasterization); writers clamp to
[0, 1] at export.
"""
from __future__ import annotations

import numpy as np


def to_uint8(img) -> np.ndarray:
    """[H,W,3] float (j=0 bottom) -> top-down uint8 raster."""
    arr = np.asarray(img, np.float64)
    arr = np.clip(arr, 0.0, 1.0)
    arr = arr[::-1]  # GL bottom-up -> raster top-down
    return (arr * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path: str, img) -> None:
    """Binary P6 PPM, the format of the reference's ppm.cpp."""
    raster = to_uint8(img)
    h, w, _ = raster.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(raster.tobytes())


def _ppm_read_int(f, want_term: bool = False):
    """One positive integer from a PPM header/P3 body: digits accumulate,
    ``#`` starts an end-of-line comment, whitespace separates — the
    reference's tokenizer semantics (Hw4/ppm.cpp::ppmReadInteger:29-55),
    which also accepts its own writer's one-line ``P6 w h 255`` header.
    ``want_term``: return ``(value, terminating byte)`` instead (the P6
    maxval needs it to recognize a CRLF header)."""
    got, accum, in_comment = False, 0, False
    while True:
        ch = f.read(1)
        if in_comment:
            if not ch:
                raise ValueError("ppm: unexpected end of file in comment")
            if ch == b"\n":
                in_comment = False
            continue
        if ch.isdigit():
            accum = accum * 10 + (ch[0] - ord("0"))
            got = True
        elif not ch:  # EOF: legal right after the last P3 value
            if got:
                return (accum, ch) if want_term else accum
            raise ValueError("ppm: unexpected end of file")
        elif ch == b"#":
            in_comment = True
        elif ch not in b" \t\r\n":
            raise ValueError(f"ppm: invalid character {ch!r}")
        elif got:
            return (accum, ch) if want_term else accum


def read_ppm(path: str) -> np.ndarray:
    """Read a P6 (binary) or P3 (ASCII) PPM back to top-down uint8
    [H,W,3] — both formats of the reference's reader
    (Hw4/ppm.cpp::ppmRead:71-109; P3 is its dead-code branch)."""
    with open(path, "rb") as f:
        magic = f.read(2)
        if magic not in (b"P6", b"P3"):
            raise ValueError(f"not a P6/P3 PPM: {magic!r}")
        w = _ppm_read_int(f)
        h = _ppm_read_int(f)
        maxval, term = _ppm_read_int(f, want_term=True)
        if maxval != 255:
            raise ValueError("only maxval 255 supported")
        if magic == b"P6":
            # exactly one whitespace byte separates maxval from the raster
            # (PPM spec; the reference parser consumes exactly one too) —
            # but when that byte was the \r of a CRLF-written header, the
            # stray \n must also be consumed or every raster byte shifts.
            # Only a \r terminator triggers the peek, so a legitimate
            # first raster byte of value 10 after "255\n" is never eaten.
            if term == b"\r":
                pos = f.tell()
                if f.read(1) != b"\n":
                    f.seek(pos)
            data = np.frombuffer(f.read(w * h * 3), np.uint8)
        else:
            vals = [_ppm_read_int(f) for _ in range(w * h * 3)]
            data = np.asarray(vals, np.uint8)
    return data.reshape(h, w, 3)


def write_png(path: str, img) -> None:
    """PNG via PIL when available, else fall back to PPM next to it."""
    raster = to_uint8(img)
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        write_ppm(path.rsplit(".", 1)[0] + ".ppm", img)
        return
    Image.fromarray(raster).save(path)


def write_image(path: str, img) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, img)
    elif path.endswith(".npy"):
        np.save(path, np.asarray(img))
    else:
        write_png(path, img)
