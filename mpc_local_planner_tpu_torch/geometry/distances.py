"""Batched 2D distance primitives (port of
``mpc_local_planner_tpu.geometry.distances``).

Every primitive broadcasts over leading batch dims. The subgradients are
JAX's, not PyTorch's defaults: the segment clip is ``minimum(maximum(t, 0),
1)`` (0.5 at an exact 0 or 1, where ``clamp`` passes 1), and the masked
minimum over polygon edges is ``torch.amin``, which splits the gradient
equally among ties as ``jnp.min`` does (``min(dim=...)`` sends it all to one
index).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _safe_norm(d):
    """‖d‖ with a bounded gradient at 0 (plain norm AD yields NaN there —
    and trajectory inits routinely pass exactly through obstacle centers)."""
    return torch.sqrt(torch.sum(d * d, dim=-1) + _EPS)


def point_to_point(p, q):
    """|p - q| with batch broadcasting; last dim = 2."""
    return _safe_norm(p - q)


def _clip01(t):
    return torch.minimum(torch.maximum(t, torch.zeros_like(t)), torch.ones_like(t))


def point_to_segment(p, a, b):
    """Distance from point(s) p to segment(s) [a, b]; all (..., 2)."""
    ab = b - a
    denom = torch.maximum(torch.sum(ab * ab, dim=-1), torch.full_like(ab[..., 0], _EPS))
    t = _clip01(torch.sum((p - a) * ab, dim=-1) / denom)
    closest = a + t[..., None] * ab
    return _safe_norm(p - closest)


def _orient(a, b, c):
    """Signed area orientation of triangle (a, b, c)."""
    return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (c[..., 0] - a[..., 0])


def segments_intersect(p1, p2, q1, q2):
    """Proper-intersection test for segments [p1,p2] and [q1,q2] (bool)."""
    d1 = _orient(q1, q2, p1)
    d2 = _orient(q1, q2, p2)
    d3 = _orient(p1, p2, q1)
    d4 = _orient(p1, p2, q2)
    return (d1 * d2 < 0) & (d3 * d4 < 0)


def segment_to_segment(p1, p2, q1, q2):
    """Distance between two segments; 0 if they intersect."""
    d = torch.minimum(
        torch.minimum(point_to_segment(p1, q1, q2), point_to_segment(p2, q1, q2)),
        torch.minimum(point_to_segment(q1, p1, p2), point_to_segment(q2, p1, p2)),
    )
    return torch.where(segments_intersect(p1, p2, q1, q2), 0.0, d)


def _polygon_edges(verts, nv):
    """Edge endpoints (a_i, b_i) of a padded closed polygon.

    verts: (..., V, 2); nv: (...,) active vertex count (>= 3 when active).
    Edge i connects vertex i to vertex (i+1) mod nv; edges i >= nv are padding.
    Returns a: (..., V, 2), b: (..., V, 2), mask: (..., V) bool.
    """
    V = verts.shape[-2]
    idx = torch.arange(V, device=verts.device)
    nv_ = torch.clamp(nv.long(), min=1)
    nxt = torch.remainder(idx + 1, nv_[..., None])
    lead = torch.broadcast_shapes(verts.shape[:-1], nxt.shape)
    b = torch.gather(verts.expand(lead + (2,)), -2, nxt.expand(lead)[..., None].expand(lead + (2,)))
    mask = idx < nv[..., None]
    return verts, b, mask


def _masked_min(d, mask):
    """jnp.min of ``d`` over the last axis where ``mask``, inf elsewhere."""
    return torch.amin(torch.where(mask, d, torch.inf), dim=-1)


def point_to_polygon_signed(p, verts, nv):
    """Signed distance from point(s) to a closed polygon boundary.

    Negative inside (even-odd rule), positive outside. p: (..., 2),
    verts: (..., V, 2), nv: (...,). Batch dims broadcast.
    """
    a, b, mask = _polygon_edges(verts, nv)
    d = _masked_min(point_to_segment(p[..., None, :], a, b), mask)

    # even-odd crossing count for the inside test
    px, py = p[..., 0], p[..., 1]
    ax, ay = a[..., 0], a[..., 1]
    bx, by = b[..., 0], b[..., 1]
    cond = (ay > py[..., None]) != (by > py[..., None])
    dy = torch.where(torch.abs(by - ay) < _EPS, _EPS, by - ay)
    x_int = ax + (py[..., None] - ay) * (bx - ax) / dy
    crossing = cond & (px[..., None] < x_int) & mask
    inside = torch.remainder(torch.sum(crossing.int(), dim=-1), 2) == 1
    return torch.where(inside, -d, d)


def segment_to_polygon(p1, p2, verts, nv):
    """Distance from segment [p1,p2] to a closed polygon boundary (0 on contact)."""
    a, b, mask = _polygon_edges(verts, nv)
    d = _masked_min(segment_to_segment(p1[..., None, :], p2[..., None, :], a, b), mask)
    # segment fully inside the polygon touches nothing above; treat inside as 0
    inside = point_to_polygon_signed(p1, verts, nv) < 0
    return torch.where(inside, 0.0, d)


def polygon_to_polygon(verts_a, nv_a, verts_b, nv_b):
    """Distance between two closed polygon boundaries (0 on contact/overlap).

    Min over (edges of A) x (edges of B) segment distances; if either contains
    the other's first vertex, returns 0.
    """
    a1, a2, mask_a = _polygon_edges(verts_a, nv_a)
    b1, b2, mask_b = _polygon_edges(verts_b, nv_b)
    d = segment_to_segment(
        a1[..., :, None, :], a2[..., :, None, :], b1[..., None, :, :], b2[..., None, :, :]
    )  # (..., Va, Vb)
    m = mask_a[..., :, None] & mask_b[..., None, :]
    dmin = torch.amin(torch.where(m, d, torch.inf), dim=(-2, -1))
    a_in_b = point_to_polygon_signed(verts_a[..., 0, :], verts_b, nv_b) < 0
    b_in_a = point_to_polygon_signed(verts_b[..., 0, :], verts_a, nv_a) < 0
    return torch.where(a_in_b | b_in_a, 0.0, dmin)


def softmin(values, mask, tau: float):
    """Smooth masked minimum: -tau * logsumexp(-v / tau). tau -> 0 gives min."""
    v = torch.where(mask, values, torch.inf)
    vmin = torch.amin(v, dim=-1, keepdim=True)
    w = torch.where(mask, torch.exp(-(values - vmin) / tau), 0.0)
    s = torch.sum(w, dim=-1)
    return vmin[..., 0] - tau * torch.log(torch.maximum(s, torch.full_like(s, _EPS)))
