"""glTF 2.0 metallic-roughness BSDF: GGX + Lambert + Schlick (port of
`models/bsdf.py`).

    c_diff = base_color * (1 - metallic)
    F0     = lerp(0.04 * specular, base_color, metallic)
    f      = (1 - F(VoH)) * c_diff/pi  +  D_GGX * Vis_Smith * F(VoH)

Trowbridge-Reitz D, height-correlated Smith visibility, Fresnel-Schlick;
sampling mixes cosine-hemisphere (diffuse) with Heitz's visible-normal GGX
(specular).  Directions are in the LOCAL shading frame (+z = normal), wo
points toward the viewer.  Differentiable in the material parameters;
bounds on values that carry gradient split a tie's gradient in half, as
the reference's do (`core.math3d.maximum`/`clip`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import math3d

INV_PI = 0.31830988618379067
MIN_ALPHA = 1e-4
MIN_ROUGHNESS = 1e-2


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize with a finite gradient at |v| = 0."""
    n2 = torch.clamp_min(torch.sum(v * v, dim=-1, keepdim=True), 1e-20)
    return v * torch.rsqrt(n2)


@dataclasses.dataclass(frozen=True)
class BsdfParams:
    """Per-hit material parameters (after texture lookups)."""

    base_color: torch.Tensor  # f32[..., 3] linear
    metallic: torch.Tensor    # f32[...]
    roughness: torch.Tensor   # f32[...]
    specular: torch.Tensor    # f32[...] scale on dielectric F0

    @property
    def alpha(self) -> torch.Tensor:
        r = math3d.clip(self.roughness, MIN_ROUGHNESS, 1.0)
        return math3d.maximum(r * r, MIN_ALPHA)

    @property
    def f0(self) -> torch.Tensor:
        m = self.metallic[..., None]
        return (0.04 * self.specular[..., None] * (1.0 - m)
                + self.base_color * m)

    @property
    def diffuse_color(self) -> torch.Tensor:
        return self.base_color * (1.0 - self.metallic[..., None])


def cos_theta(w: torch.Tensor) -> torch.Tensor:
    return w[..., 2]


def d_ggx(alpha: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Trowbridge-Reitz NDF, local frame."""
    a2 = alpha * alpha
    nh = math3d.maximum(cos_theta(h), 0.0)
    d = nh * nh * (a2 - 1.0) + 1.0
    return a2 * INV_PI / math3d.maximum(d * d, 1e-12)


def smith_lambda(alpha: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Smith's lambda for GGX: (sqrt(1 + a^2 tan^2) - 1) / 2."""
    c = math3d.clip(cos_theta(w).abs(), 1e-6, 1.0)
    tan2 = math3d.maximum(1.0 - c * c, 0.0) / (c * c)
    return 0.5 * (torch.sqrt(1.0 + alpha * alpha * tan2) - 1.0)


def vis_smith_hc(alpha, wo, wi) -> torch.Tensor:
    """Height-correlated Smith visibility V = G2 / (4 |NL| |NV|)."""
    no = math3d.maximum(cos_theta(wo).abs(), 1e-6)
    ni = math3d.maximum(cos_theta(wi).abs(), 1e-6)
    lam = smith_lambda(alpha, wo) + smith_lambda(alpha, wi)
    return 1.0 / (4.0 * no * ni * (1.0 + lam))


def g1_smith(alpha, w) -> torch.Tensor:
    return 1.0 / (1.0 + smith_lambda(alpha, w))


def fresnel_schlick(f0: torch.Tensor, voh: torch.Tensor) -> torch.Tensor:
    m = math3d.clip(1.0 - voh, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m ** 5)[..., None]


def eval_bsdf(params: BsdfParams, wo: torch.Tensor, wi: torch.Tensor):
    """BRDF value f(wo, wi) [..., 3] and its sampling pdf [...]; zero when
    either direction is below the hemisphere."""
    valid = (cos_theta(wo) > 1e-6) & (cos_theta(wi) > 1e-6)
    h = _safe_normalize(wo + wi)
    voh = math3d.maximum(torch.sum(wo * h, dim=-1), 0.0)
    alpha = params.alpha
    f = fresnel_schlick(params.f0, voh)
    spec = (d_ggx(alpha, h) * vis_smith_hc(alpha, wo, wi))[..., None] * f
    diff = params.diffuse_color * INV_PI * (1.0 - f)
    val = torch.where(valid[..., None], diff + spec, 0.0)
    pdf = torch.where(valid, _pdf(params, wo, wi, h), 0.0)
    return val, pdf


def _spec_select_prob(params: BsdfParams) -> torch.Tensor:
    """Probability of sampling the specular lobe: energy-based heuristic."""
    ls = math3d.maximum(math3d.luminance(params.f0), 1e-4)
    ld = math3d.maximum(math3d.luminance(params.diffuse_color), 0.0)
    return math3d.clip(ls / (ls + ld), 0.05, 0.99)


def _pdf_vndf(alpha, wo, h) -> torch.Tensor:
    """pdf of wi when h is drawn from the visible normals: G1 D / (4 |NV|)."""
    no = math3d.maximum(cos_theta(wo).abs(), 1e-6)
    return g1_smith(alpha, wo) * d_ggx(alpha, h) / (4.0 * no)


def _pdf(params: BsdfParams, wo, wi, h) -> torch.Tensor:
    ps = _spec_select_prob(params)
    pdf_d = math3d.maximum(cos_theta(wi), 0.0) * INV_PI
    pdf_s = _pdf_vndf(params.alpha, wo, h)
    return ps * pdf_s + (1.0 - ps) * pdf_d


def pdf_bsdf(params: BsdfParams, wo: torch.Tensor, wi: torch.Tensor):
    h = _safe_normalize(wo + wi)
    pdf = _pdf(params, wo, wi, h)
    return torch.where((cos_theta(wo) > 1e-6) & (cos_theta(wi) > 1e-6),
                       pdf, 0.0)


def sample_cosine_hemisphere(u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction from u in [0,1)^2 (local)."""
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * math.pi * u2[..., 1]
    z = torch.sqrt(torch.clamp_min(1.0 - u2[..., 0], 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_vndf_ggx(alpha: torch.Tensor, wo: torch.Tensor,
                    u2: torch.Tensor) -> torch.Tensor:
    """Heitz 2018 visible-normal GGX sampling -> half vector h (local)."""
    vh = _safe_normalize(torch.stack(
        [alpha * wo[..., 0], alpha * wo[..., 1], wo[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(math3d.maximum(lensq, 1e-12))
    t1 = torch.where(
        lensq[..., None] > 1e-9,
        torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                     torch.zeros_like(inv)], dim=-1),
        math3d.device_constant((1.0, 0.0, 0.0), vh.device))
    t2 = math3d.cross(vh, t1)
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * math.pi * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(math3d.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                     math3d.maximum(nh[..., 2], 1e-6)], dim=-1)
    return _safe_normalize(h)


def sample_bsdf(params: BsdfParams, wo: torch.Tensor, u_lobe: torch.Tensor,
                u2: torch.Tensor):
    """Draw wi ~ p(.|wo); returns (wi, f, pdf) for the MIXTURE pdf, so f/pdf
    is unbiased whichever lobe fired."""
    ps = _spec_select_prob(params)
    wi_d = sample_cosine_hemisphere(u2)
    h = sample_vndf_ggx(params.alpha, wo, u2)
    wi_s = 2.0 * torch.sum(wo * h, dim=-1, keepdim=True) * h - wo
    use_spec = u_lobe < ps
    wi = _safe_normalize(torch.where(use_spec[..., None], wi_s, wi_d))
    f, pdf = eval_bsdf(params, wo, wi)
    return wi, f, pdf
