"""Fused ACES+gamma tonemap (K3): HDR -> LDR in one pass on the device.

Port of the reference's `ops/tonemap.py`.  The kernel
(`csrc/tonemap.cu`) applies the same math as the reference kernel; the
plain version `tonemap_plain` is the same function in torch and is what
the wrapper `tonemap` runs for CPU tensors.  Primal only: the
differentiable path is `core.tonemap.aces_gamma`.
"""

from __future__ import annotations

import torch

from ..core.tonemap import ACES_INPUT, ACES_OUTPUT, mix3, rrt_and_odt_fit
from ..utils.profiling import span
from . import cuda_lib

# Kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0


def tonemap_plain(hdr: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Plain-torch K3: ACES fit -> exp(log(c)/gamma) for c > 0 else 0 ->
    clamp [0, 1], on f32[..., 3]."""
    inv_gamma = 1.0 / gamma
    c = mix3(hdr[..., 0], hdr[..., 1], hdr[..., 2], ACES_INPUT)
    c = mix3(*(rrt_and_odt_fit(x) for x in c), ACES_OUTPUT)

    def gamma_clamp(x):
        pos = x > 0.0
        safe = torch.where(pos, x, 1.0)
        g = torch.where(pos, torch.exp(torch.log(safe) * inv_gamma), 0.0)
        return torch.clamp(g, 0.0, 1.0)

    return torch.stack([gamma_clamp(x) for x in c], dim=-1)


def tonemap(hdr: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """K3 on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  hdr: f32[..., 3]."""
    global LAUNCHES
    if hdr.shape[-1] != 3:
        raise ValueError(f"expected [..., 3] HDR image, got {tuple(hdr.shape)}")
    if hdr.dtype != torch.float32:
        raise TypeError(f"hdr must be float32, got {hdr.dtype}")
    if hdr.device.type == "cpu":
        with span("pbr.tonemap"):
            return tonemap_plain(hdr, gamma)
    if hdr.device.type != "cuda":
        raise ValueError(f"tonemap: unsupported device {hdr.device}")
    if not hdr.is_contiguous():
        raise ValueError("hdr must be contiguous")
    n = hdr.numel() // 3
    if n >= 1 << 31:
        raise ValueError("image too large for 32-bit indexing")
    with span("pbr.tonemap"):
        lib = cuda_lib.library()
        out = torch.empty_like(hdr)
        rc = lib.pbr_tonemap(hdr.data_ptr(), out.data_ptr(), n, 1.0 / gamma,
                             cuda_lib.stream_ptr(hdr.device))
        cuda_lib.check(rc, "pbr_tonemap")
        LAUNCHES += 1
        return out
