"""Polar-image files: the `radar/image` publisher surface (counterpart of
radarays_ros_tpu/io/image_io.py; NumPy + zlib, byte-identical output).

The reference emits frames as mono8 sensor_msgs/Image over ROS
(radar_simulator.cpp:179-180, RadarCPU.cpp:555-561). Here a frame is a
uint8 (n_cells, n_angles) array written as an 8-bit grayscale PNG (an
encoder and decoder of its own, no PIL) or as .npy, and `polar_to_points`
turns it into a point cloud (the radar_img_to_pcl helper of
launch/tests/radar_sim_test.launch). Only `read_image_gray` on a file that
is not an 8-bit grayscale PNG imports PIL, at the call.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _write_png(path, img: np.ndarray, color_type: int) -> None:
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def write_png_gray(path, img: np.ndarray) -> None:
    """Write a (H, W) uint8 array as an 8-bit grayscale PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected (H, W) image, got {img.shape}")
    _write_png(path, img, 0)


def write_png_rgb(path, img: np.ndarray) -> None:
    """Write a (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
    _write_png(path, img, 2)


def read_image_gray(path) -> np.ndarray:
    """Read any common image as (H, W) uint8 grayscale: the in-tree PNG
    reader for mono8 frames, PIL (imported here, only then) for other
    files such as the reference's published color figure."""
    try:
        return read_png_gray(path)
    except ValueError:
        try:
            from PIL import Image
        except ImportError as e:
            raise ValueError(
                f"{path}: not an 8-bit grayscale PNG and PIL is "
                "unavailable for conversion") from e
        return np.asarray(Image.open(path).convert("L"), np.uint8)


def read_png_gray(path) -> np.ndarray:
    """Read an 8-bit grayscale PNG (filter none, and the sub/up/average/
    paeth filters of externally produced files)."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, w = 8, 0
    h = bit_depth = color_type = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8 or color_type != 0:
        raise ValueError(f"{path}: only 8-bit grayscale supported")
    raw = zlib.decompress(idat)
    stride = w + 1
    img = np.empty((h, w), np.uint8)
    prev = np.zeros(w, np.int32)
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        filt = row[0]
        line = np.frombuffer(row[1:], np.uint8).astype(np.int32)
        if filt == 0:
            out = line
        elif filt == 2:  # up
            out = (line + prev) & 0xFF
        elif filt in (1, 3, 4):  # sub / average / paeth: sequential scan
            out = np.zeros(w, np.int32)
            for x in range(w):
                a = out[x - 1] if x else 0
                b = prev[x]
                c = prev[x - 1] if x else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                out[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unsupported filter {filt}")
        img[y] = out.astype(np.uint8)
        prev = out
    return img


def polar_to_points(img: np.ndarray, resolution: float,
                    threshold: int = 1, scroll: int = 0) -> np.ndarray:
    """(n_cells, n_angles) polar frame -> (N, 4) [x, y, z=0, value]: cell r
    of column a at range r*resolution, azimuth -2*pi*a/A
    (utils/transforms.py:azimuth_angles)."""
    n_cells, A = img.shape
    cells, cols = np.nonzero(img >= threshold)
    ang = -(2.0 * np.pi) * ((cols - scroll) % A) / A
    r = cells.astype(np.float32) * resolution
    return np.stack(
        [r * np.cos(ang), r * np.sin(ang), np.zeros_like(r),
         img[cells, cols].astype(np.float32)], axis=-1)


def save_frame(path, img: np.ndarray) -> None:
    """Write a frame by extension: .png or .npy."""
    path = Path(path)
    if path.suffix == ".png":
        write_png_gray(path, img)
    elif path.suffix == ".npy":
        np.save(path, np.asarray(img))
    else:
        raise ValueError(f"unsupported frame format {path.suffix}")
