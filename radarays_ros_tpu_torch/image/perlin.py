"""Perlin noise (counterpart of radarays_ros_tpu/image/perlin.py): the
classic 3-D noise over any coordinates (`perlin_noise`), its two-octave
blend (`perlin_noise_hilo`), a NumPy float64 scalar oracle
(`perlin_noise_reference`), and the rowwise 2-D form the ambient-noise
stage uses (`perlin_affine_rows`).

Ken Perlin's improved noise with the canonical permutation
(image_algorithms.h:14-50). In `perlin_affine_rows` the reference expands
per-interval constants to per-cell values with one-hot selection matmuls
because table gathers are slow on a TPU; here they are direct gathers,
which give the same values (each one-hot product picks exactly one term).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_PERM256 = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], np.int64)
PERM = np.concatenate([_PERM256, _PERM256])


def _hash_stack() -> np.ndarray:
    """(256_y, 256_x, 4) corner hashes [G, G2, G(x+1), G2(x+1)] with
    G[x, y] = perm[perm[perm[x] + y]] & 15 and G2[x, y] the same at y + 1."""
    a = PERM[np.arange(256)][:, None] + np.arange(256)[None, :]
    g = PERM[PERM[a]] & 15
    g2 = PERM[PERM[a + 1]] & 15
    st = np.stack([g, g2, np.roll(g, -1, axis=0), np.roll(g2, -1, axis=0)],
                  axis=-1)
    return np.ascontiguousarray(st.transpose(1, 0, 2))


_HASH_STACK = _hash_stack()


@functools.lru_cache(maxsize=None)
def _on_device(name: str, device: torch.device) -> torch.Tensor:
    """The table PERM or _HASH_STACK on `device`, copied there once a
    process (not once a call: a CUDA graph cannot hold a host copy)."""
    return torch.as_tensor(globals()[name], device=device)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where(h & 1 == 0, u, -u) + torch.where(h & 2 == 0, v, -v)


def perlin_noise(src_x, src_y, src_z=0.0) -> torch.Tensor:
    """Classic 3-D Perlin noise in [-1, 1] in f32, elementwise over tensors
    (image_algorithms.h:69-106), on src_x's device."""
    src_x = torch.as_tensor(src_x, dtype=torch.float32)
    dev = src_x.device
    src_y = torch.as_tensor(src_y, dtype=torch.float32, device=dev)
    src_z = torch.as_tensor(src_z, dtype=torch.float32,
                            device=dev).expand(src_x.shape)
    perm = _on_device("PERM", dev)

    fx, fy, fz = torch.floor(src_x), torch.floor(src_y), torch.floor(src_z)
    X = fx.to(torch.int64) & 255
    Y = fy.to(torch.int64) & 255
    Z = fz.to(torch.int64) & 255
    x, y, z = src_x - fx, src_y - fy, src_z - fz
    u, v, w = _fade(x), _fade(y), _fade(z)

    A = perm[X] + Y
    AA = perm[A] + Z
    AB = perm[A + 1] + Z
    B = perm[X + 1] + Y
    BA = perm[B] + Z
    BB = perm[B + 1] + Z

    def lerp(t, a, b):
        return a + t * (b - a)

    return lerp(
        w,
        lerp(v,
             lerp(u, _grad(perm[AA], x, y, z), _grad(perm[BA], x - 1.0, y, z)),
             lerp(u, _grad(perm[AB], x, y - 1.0, z),
                  _grad(perm[BB], x - 1.0, y - 1.0, z))),
        lerp(v,
             lerp(u, _grad(perm[AA + 1], x, y, z - 1.0),
                  _grad(perm[BA + 1], x - 1.0, y, z - 1.0)),
             lerp(u, _grad(perm[AB + 1], x, y - 1.0, z - 1.0),
                  _grad(perm[BB + 1], x - 1.0, y - 1.0, z - 1.0))),
    )


def perlin_noise_hilo(off_x, off_y, x, y, scale_low, scale_high, p_low):
    """Two-octave blend p_low*low + (1-p_low)*high (image_algorithms.h:
    108-128)."""
    low = perlin_noise(off_x + x * scale_low, off_y + y * scale_low)
    high = perlin_noise(off_x + x * scale_high, off_y + y * scale_high)
    return p_low * low + (1.0 - p_low) * high


def perlin_noise_reference(src_x, src_y, src_z=0.0):
    """Pure-NumPy float64 scalar reference (oracle for tests)."""
    p = PERM

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    def lerp(t, a, b):
        return a + t * (b - a)

    def grad(h, x, y, z):
        h = h & 15
        u = x if h < 8 else y
        v = y if h < 4 else (x if h in (12, 14) else z)
        return (u if (h & 1) == 0 else -u) + (v if (h & 2) == 0 else -v)

    X = int(np.floor(src_x)) & 255
    Y = int(np.floor(src_y)) & 255
    Z = int(np.floor(src_z)) & 255
    x = src_x - np.floor(src_x)
    y = src_y - np.floor(src_y)
    z = src_z - np.floor(src_z)
    u, v, w = fade(x), fade(y), fade(z)
    A = p[X] + Y
    AA = p[A] + Z
    AB = p[A + 1] + Z
    B = p[X + 1] + Y
    BA = p[B] + Z
    BB = p[B + 1] + Z
    return lerp(w,
                lerp(v,
                     lerp(u, grad(p[AA], x, y, z), grad(p[BA], x - 1, y, z)),
                     lerp(u, grad(p[AB], x, y - 1, z),
                          grad(p[BB], x - 1, y - 1, z))),
                lerp(v,
                     lerp(u, grad(p[AA + 1], x, y, z - 1),
                          grad(p[BA + 1], x - 1, y, z - 1)),
                     lerp(u, grad(p[AB + 1], x, y - 1, z - 1),
                          grad(p[BB + 1], x - 1, y - 1, z - 1))))


def _alpha_beta(h):
    """grad(h, x, y, 0) = alpha * x + beta * y for a 4-bit hash h."""
    su = torch.where(h & 1 == 0, 1.0, -1.0)
    sv = torch.where(h & 2 == 0, 1.0, -1.0)
    lo8 = h < 8
    alpha = torch.where(lo8, su, 0.0) + torch.where((h == 12) | (h == 14),
                                                    sv, 0.0)
    beta = torch.where(lo8, 0.0, su) + torch.where(h < 4, sv, 0.0)
    return alpha, beta


def perlin_affine_rows(x0_int, y, scale: float, n_cells: int) -> torch.Tensor:
    """(A, n_cells) Perlin noise at x = x0_int[a] + i*scale, y[a].

    x0_int: (A,) integer row offsets; y: (A,) float rows. Equals classic
    perlin_noise(x0_int[:, None] + i*scale, y[:, None]) because the integer
    offsets share the x lattice phase across rows."""
    x0_int = torch.as_tensor(x0_int).to(torch.int64)
    y = torch.as_tensor(y, dtype=torch.float32)
    dev = y.device

    i = torch.arange(n_cells, dtype=torch.float32, device=dev) \
        * float(np.float32(scale))
    fi = torch.floor(i)
    k_cell = fi.to(torch.int64)          # lattice interval of each cell
    t = i - fi
    u = _fade(t)
    K = int(np.floor((n_cells - 1) * float(scale))) + 1

    fy = torch.floor(y)
    Y = fy.to(torch.int64) & 255
    yf = y - fy
    v = _fade(yf)

    Xk = (x0_int[:, None] + torch.arange(K + 1, device=dev)[None, :]) & 255
    hs = _on_device("_HASH_STACK", dev)
    hashes = hs[Y[:, None], Xk]                          # (A, K+1, 4)
    aAA, bAA = _alpha_beta(hashes[..., 0])
    aAB, bAB = _alpha_beta(hashes[..., 1])
    aBA, bBA = _alpha_beta(hashes[..., 2])
    aBB, bBB = _alpha_beta(hashes[..., 3])
    v_ = v[:, None]
    yf_ = yf[:, None]
    a0 = ((1 - v_) * aAA + v_ * aAB)[:, :K]
    c0 = ((1 - v_) * bAA * yf_ + v_ * bAB * (yf_ - 1.0))[:, :K]
    a1 = ((1 - v_) * aBA + v_ * aBB)[:, :K]
    c1 = ((1 - v_) * bBA * yf_ + v_ * bBB * (yf_ - 1.0))[:, :K]

    A0, C0 = a0[:, k_cell], c0[:, k_cell]
    A1, C1 = a1[:, k_cell], c1[:, k_cell]
    t_ = t[None, :]
    u_ = u[None, :]
    return (1.0 - u_) * (t_ * A0 + C0) + u_ * ((t_ - 1.0) * A1 + C1)
