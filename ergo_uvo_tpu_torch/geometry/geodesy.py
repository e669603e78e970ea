"""WGS-84 geodetic conversions (lat/lon <-> local NE / NED tangent frames).

A numpy copy of ``ergo_uvo_tpu/geometry/geodesy.py`` (whose package imports
JAX), held equal to it by ``tests/test_torch_host_modules.py``.  It is the
reference's ll2ne / ne2ll / lld2ned (math_utility.cpp:262-335): a flat-earth
local tangent-plane approximation built from the WGS-84 meridian and normal
radii of curvature at the origin latitude (a = 6378137 m,
f = 1/298.257223563).

The reference writes the metres-per-radian factors as ``atan2(1, R)``; for
the radii involved that equals ``1/R`` to < 1e-13 relative error, so the
direct small-angle form is used.  Geodesy runs on the host, on trajectory
post-processing, never on the device path.
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563

__all__ = [
    "ll_to_ne",
    "ne_to_ll",
    "lld_to_ned",
    "ned_to_lld",
    "WGS84_A",
    "WGS84_F",
]


def _radii(lat0_rad: np.ndarray):
    """Meridian (Rm) and prime-vertical (Rn) radii of curvature at lat0."""
    e2 = 2.0 * WGS84_F - WGS84_F * WGS84_F
    s2 = np.sin(lat0_rad) ** 2
    rn = WGS84_A / np.sqrt(1.0 - e2 * s2)
    rm = rn * (1.0 - e2) / (1.0 - e2 * s2)
    return rm, rn


def ll_to_ne(ll0, ll):
    """(lat, lon) degrees -> local (north, east) metres about origin ``ll0``.

    Mirrors the reference's ``ll2ne`` (math_utility.cpp:262-289).  Accepts
    ``ll`` of shape (..., 2); ``ll0`` is the (lat0, lon0) origin in degrees.
    """
    ll0 = np.asarray(ll0, dtype=np.float64)
    ll = np.asarray(ll, dtype=np.float64)
    lat0 = np.deg2rad(ll0[..., 0])
    lon0 = np.deg2rad(ll0[..., 1])
    lat = np.deg2rad(ll[..., 0])
    lon = np.deg2rad(ll[..., 1])
    rm, rn = _radii(lat0)
    north = (lat - lat0) * rm
    east = (lon - lon0) * rn * np.cos(lat0)
    return np.stack([north, east], axis=-1)


def ne_to_ll(ll0, ne):
    """Local (north, east) metres -> (lat, lon) degrees about origin ``ll0``.

    Mirrors the reference's ``ne2ll`` (math_utility.cpp:316-335).
    """
    ll0 = np.asarray(ll0, dtype=np.float64)
    ne = np.asarray(ne, dtype=np.float64)
    lat0 = np.deg2rad(ll0[..., 0])
    lon0 = np.deg2rad(ll0[..., 1])
    rm, rn = _radii(lat0)
    lat = lat0 + ne[..., 0] / rm
    lon = lon0 + ne[..., 1] / (rn * np.cos(lat0))
    return np.stack([np.rad2deg(lat), np.rad2deg(lon)], axis=-1)


def lld_to_ned(lld0, lld):
    """(lat, lon, depth) -> (north, east, down) metres about origin ``lld0``.

    Mirrors the reference's ``lld2ned`` (math_utility.cpp:297-308): NE from
    the tangent plane, down = depth - depth0.
    """
    lld0 = np.asarray(lld0, dtype=np.float64)
    lld = np.asarray(lld, dtype=np.float64)
    ne = ll_to_ne(lld0[..., :2], lld[..., :2])
    down = lld[..., 2] - lld0[..., 2]
    return np.concatenate([ne, down[..., None]], axis=-1)


def ned_to_lld(lld0, ned):
    """Inverse of :func:`lld_to_ned` (round-trip convenience; no reference
    analogue — the reference only ships the forward direction plus ne2ll)."""
    lld0 = np.asarray(lld0, dtype=np.float64)
    ned = np.asarray(ned, dtype=np.float64)
    ll = ne_to_ll(lld0[..., :2], ned[..., :2])
    depth = lld0[..., 2] + ned[..., 2]
    return np.concatenate([ll, depth[..., None]], axis=-1)
