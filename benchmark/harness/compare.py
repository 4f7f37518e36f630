"""The numbers that decide `correct`, each held to the limit in
`limits/<cell>.json`.

Images: the share of pixels off, the film mean's and the ray count's
relative gaps.  A pixel is off where any channel differs by more than
1e-4 + 1e-3 |reference| (the port's agreement rule since its first
renders); an LDR pixel where any channel differs by more than 1e-5 (K3's
rule against its plain version).  Training: per step the loss's relative
gap; per trained leaf the gap between the two sides' norms of the first
gradient and of the change over the checked steps, over the larger of the
reference leaf's norm and the median leaf's, worst leaf taken.
"""

from __future__ import annotations

import math
import statistics

HDR_ATOL, HDR_RTOL, LDR_ATOL = 1e-4, 1e-3, 1e-5


def off_pct(img, ref, atol: float, rtol: float = 0.0) -> float:
    """Percent of pixels [.., 3] with a channel outside atol + rtol|ref|."""
    bad = ((img - ref).abs() > atol + rtol * ref.abs()).any(dim=-1)
    return 100.0 * float(bad.float().mean())


def rel_gap(a: float, b: float) -> float:
    if b == 0.0:
        return 0.0 if a == 0.0 else float("inf")
    return abs(a / b - 1.0)


def image_numbers(hdr, hdr_ref, ldr, ldr_ref, count, count_ref) -> dict:
    """hdr, hdr_ref: f32[H, W, 3] means; ldr, ldr_ref: tonemapped; counts:
    ray queries."""
    return {"hdr_off_pct": off_pct(hdr, hdr_ref, HDR_ATOL, HDR_RTOL),
            "mean_rel": rel_gap(float(hdr.double().mean()),
                                float(hdr_ref.double().mean())),
            "ldr_off_pct": off_pct(ldr, ldr_ref, LDR_ATOL),
            "rays_rel": rel_gap(float(count), float(count_ref))}


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖) over
    the leaves in `keep` (all when None)."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: float(ref[k].double().norm()) for k in ref}
    med = statistics.median(norms.values())
    gaps = []
    for k in names:
        # A leaf the program gave no gradient is as far off as can be.
        d = (math.inf if prog[k] is None
             else abs(float(prog[k].double().norm()) - norms[k]))
        den = max(norms[k], med)
        gaps.append(math.nan if math.isnan(d + den)
                    else d / den if den > 0.0
                    else 0.0 if d == 0.0 else math.inf)
    return max(gaps, key=lambda g: math.inf if math.isnan(g) else g,
               default=0.0)
