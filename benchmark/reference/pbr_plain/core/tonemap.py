# Frozen copy of physically_based_renderer_tpu_torch/core/tonemap.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""HDR -> LDR tonemapping, differentiable torch path (port of `core/tonemap.py`).

Hill's ACES fit with the reference shader's constants (row-vector
convention: out = color @ M), the RRT+ODT rational, gamma 2.2, clamp to
[0, 1]; and the exact sRGB transfer pair.  The 3x3 mixes are written as
explicit multiply-adds, not `@`, so no matmul precision mode (TF32) can
touch them.  The tonemap kernel
(`ops/tonemap.py`, K3) is held against `aces_gamma`.
"""

from __future__ import annotations

import torch

ACES_INPUT = ((0.59719, 0.35458, 0.04823),
              (0.07600, 0.90834, 0.01566),
              (0.02840, 0.13383, 0.83777))
ACES_OUTPUT = ((1.60475, -0.53108, -0.07367),
               (-0.10208, 1.10813, -0.00605),
               (-0.00327, -0.07276, 1.07602))


def mix3(r, g, b, m):
    """(r, g, b) row vector times the 3x3 matrix m, as multiply-adds."""
    return (r * m[0][0] + g * m[1][0] + b * m[2][0],
            r * m[0][1] + g * m[1][1] + b * m[2][1],
            r * m[0][2] + g * m[1][2] + b * m[2][2])


def rrt_and_odt_fit(c: torch.Tensor) -> torch.Tensor:
    """Rational RRT+ODT fit."""
    num = c * (c + 0.0245786) - 0.000090537
    den = c * (0.983729 * c + 0.4329510) + 0.238081
    return num / den


def aces_tonemap(hdr: torch.Tensor) -> torch.Tensor:
    """ACES fitted tonemap of linear HDR RGB [..., 3]."""
    c = mix3(hdr[..., 0], hdr[..., 1], hdr[..., 2], ACES_INPUT)
    c = [rrt_and_odt_fit(x) for x in c]
    return torch.stack(mix3(*c, ACES_OUTPUT), dim=-1)


def gamma_correct(c: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """pow(c, 1/gamma) on non-negative input."""
    return torch.pow(torch.clamp_min(c, 0.0), 1.0 / gamma)


def aces_gamma(hdr: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Full post chain: ACES fit -> gamma 2.2 -> clamp [0, 1]."""
    ldr = gamma_correct(aces_tonemap(hdr), gamma)
    return torch.clamp(ldr, 0.0, 1.0)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Exact sRGB OETF on [0, 1]-clamped linear values."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-7), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB OETF (decoding 8-bit albedo texels)."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c / 12.92
    hi = torch.pow((c + 0.055) / 1.055, 2.4)
    return torch.where(c <= 0.04045, lo, hi)
