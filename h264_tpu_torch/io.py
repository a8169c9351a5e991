"""Raw YUV 4:2:0 file I/O (ReadOneFrame / img2buf equivalents,
lencod/src/image.c ReadOneFrame, lencod/src/output.c:75 img2buf)."""

from __future__ import annotations

import numpy as np


def frame_size(width: int, height: int) -> int:
    return width * height * 3 // 2


def read_yuv_frames(path: str, width: int, height: int,
                    n_frames: int | None = None, start: int = 0,
                    skip: int = 0):
    """List of (Y, U, V) uint8 arrays from a planar 4:2:0 file."""
    fs = frame_size(width, height)
    data = open(path, "rb").read()
    total = len(data) // fs
    idx = list(range(start, total, skip + 1))
    if n_frames is not None:
        idx = idx[:n_frames]
    cw, chh = width // 2, height // 2
    out = []
    for i in idx:
        off = i * fs
        Y = np.frombuffer(data, np.uint8, width * height, off).reshape(
            height, width
        )
        U = np.frombuffer(data, np.uint8, cw * chh, off + width * height
                          ).reshape(chh, cw)
        V = np.frombuffer(data, np.uint8, cw * chh,
                          off + width * height + cw * chh).reshape(chh, cw)
        out.append((Y, U, V))
    return out


def write_yuv_frame(f, planes) -> None:
    f.write(np.asarray(planes.Y, np.uint8).tobytes())
    f.write(np.asarray(planes.U, np.uint8).tobytes())
    f.write(np.asarray(planes.V, np.uint8).tobytes())


def psnr(a: np.ndarray, b: np.ndarray, max_val: int = 255) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val * max_val / mse)
