"""Image comparison metrics for real-vs-sim evaluation and optimization
(counterpart of radarays_ros_tpu/opti/metrics.py): PSNR, SSIM and the soft
joint-histogram information measures, as differentiable torch functions in
true f32 (the package switches TF32 off for matmuls and convolutions)."""

from __future__ import annotations

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def mse(a, b):
    a, b = _f32(a), _f32(b)
    return torch.mean((a - b) ** 2)


def psnr(a, b, data_range: float = 255.0):
    """Peak signal-to-noise ratio [dB]; higher = more similar."""
    m = torch.clamp_min(mse(a, b), 1e-12)
    return 10.0 * torch.log10(data_range * data_range / m)


def _uniform_filter(x, size: int):
    """Mean filter with a (size, size) box, 'same' zero padding."""
    k = torch.ones((1, 1, size, size), dtype=torch.float32,
                   device=x.device) / (size * size)
    pad = size // 2
    x4 = torch.nn.functional.pad(x[None, None],
                                 (pad, size - 1 - pad, pad, size - 1 - pad))
    return torch.nn.functional.conv2d(x4, k)[0, 0]


def ssim(a, b, data_range: float = 255.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03):
    """Structural similarity (mean over the image), skimage-compatible
    constants. Differentiable."""
    a, b = _f32(a), _f32(b)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _uniform_filter(a, win_size)
    mu_b = _uniform_filter(b, win_size)
    s_aa = _uniform_filter(a * a, win_size) - mu_a * mu_a
    s_bb = _uniform_filter(b * b, win_size) - mu_b * mu_b
    s_ab = _uniform_filter(a * b, win_size) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)


def _joint_hist(a, b, bins: int, data_range: float, sigma: float = 1.0):
    """Soft (differentiable) joint histogram via Gaussian binning."""
    centers = torch.linspace(0.0, data_range, bins, device=a.device)
    aw = torch.softmax(-((a.reshape(-1, 1) - centers) ** 2)
                       / (2 * sigma ** 2), dim=-1)
    bw = torch.softmax(-((b.reshape(-1, 1) - centers) ** 2)
                       / (2 * sigma ** 2), dim=-1)
    h = aw.T @ bw
    return h / torch.sum(h)


def _hist(a, b, bins: int, data_range: float):
    return _joint_hist(_f32(a), _f32(b), bins, data_range,
                       sigma=data_range / bins)


def _entropy(p):
    return -torch.sum(p * torch.log(torch.clamp_min(p, 1e-12)))


def mutual_information(a, b, bins: int = 32, data_range: float = 255.0):
    """Soft mutual information [nats] (the MI of radaray_opti.py:27)."""
    p_ab = _hist(a, b, bins, data_range)
    p_a = torch.sum(p_ab, dim=1, keepdim=True)
    p_b = torch.sum(p_ab, dim=0, keepdim=True)
    ratio = p_ab / torch.clamp_min(p_a * p_b, 1e-12)
    return torch.sum(p_ab * torch.log(torch.clamp_min(ratio, 1e-12)))


def normalized_mutual_information(a, b, bins: int = 32,
                                  data_range: float = 255.0):
    """NMI = (H(a) + H(b)) / H(a, b) (radaray_opti.py:21)."""
    p_ab = _hist(a, b, bins, data_range)
    h_a = _entropy(torch.sum(p_ab, dim=1))
    h_b = _entropy(torch.sum(p_ab, dim=0))
    return (h_a + h_b) / torch.clamp_min(_entropy(p_ab.reshape(-1)), 1e-12)


def variation_of_information(a, b, bins: int = 32, data_range: float = 255.0):
    """VoI = H(a,b) - MI (radaray_opti.py:24)."""
    p_ab = _hist(a, b, bins, data_range)
    return _entropy(p_ab) - mutual_information(a, b, bins, data_range)
