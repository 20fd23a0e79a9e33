"""WGS84 -> UTM projection in pure numpy (no PROJ dependency).

Replaces the reference's pyproj usage (reference tools/gpsconversions.py:6-41).
Implements the Karney-Krüger transverse-Mercator series to 6th order in the
third flattening, which agrees with PROJ to well below 1 mm over a UTM zone.

Like the reference, :func:`gps2utm` subtracts a per-dataset reference origin
(robot0/gps0/reference.yaml).  Unlike the reference — which hardcodes zone 30
(gpsconversions.py:22) — the zone defaults to the one containing the
reference longitude, with an optional override for exact parity.
"""

from __future__ import annotations

import numpy as np

from lidar_slam_arvc_tpu.io.formats import take_rows

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E0 = 500000.0  # false easting

_N = _F / (2.0 - _F)
_N2 = _N * _N
_N3 = _N2 * _N
_N4 = _N3 * _N
_N5 = _N4 * _N
_N6 = _N5 * _N

# rectifying radius
_ABAR = _A / (1.0 + _N) * (1.0 + _N2 / 4.0 + _N4 / 64.0 + _N6 / 256.0)

# Krüger alpha series (forward), 6th order
_ALPHA = np.array([
    _N / 2.0 - 2.0 / 3.0 * _N2 + 5.0 / 16.0 * _N3 + 41.0 / 180.0 * _N4
    - 127.0 / 288.0 * _N5 + 7891.0 / 37800.0 * _N6,
    13.0 / 48.0 * _N2 - 3.0 / 5.0 * _N3 + 557.0 / 1440.0 * _N4
    + 281.0 / 630.0 * _N5 - 1983433.0 / 1935360.0 * _N6,
    61.0 / 240.0 * _N3 - 103.0 / 140.0 * _N4 + 15061.0 / 26880.0 * _N5
    + 167603.0 / 181440.0 * _N6,
    49561.0 / 161280.0 * _N4 - 179.0 / 168.0 * _N5 + 6601661.0 / 7257600.0 * _N6,
    34729.0 / 80640.0 * _N5 - 3418889.0 / 1995840.0 * _N6,
    212378941.0 / 319334400.0 * _N6,
])


def utm_zone_from_longitude(lon_deg: float) -> int:
    return int(np.floor((lon_deg + 180.0) / 6.0)) % 60 + 1


def latlon_to_utm(lat_deg, lon_deg, zone: int | None = None):
    """Project WGS84 lat/lon (degrees) to UTM easting/northing (meters).

    Returns (easting, northing) arrays.  Northern-hemisphere false northing
    (0) is used, matching pyproj's ``Proj(proj='utm', zone=30)`` for the
    reference's Spanish datasets.
    """
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.asarray(lon_deg, dtype=np.float64)
    if zone is None:
        zone = utm_zone_from_longitude(float(np.atleast_1d(lon)[0]))
    lon0 = float(zone) * 6.0 - 183.0
    dlon = np.deg2rad(lon - lon0)

    # conformal latitude
    e = np.sqrt(_F * (2.0 - _F))
    sphi = np.sin(lat)
    t = np.sinh(np.arctanh(sphi) - e * np.arctanh(e * sphi))

    xi_p = np.arctan2(t, np.cos(dlon))
    eta_p = np.arcsinh(np.sin(dlon) / np.sqrt(t * t + np.cos(dlon) ** 2))

    j = np.arange(1, 7, dtype=np.float64)
    two_j_xi = 2.0 * j[:, None] * np.atleast_1d(xi_p)[None, :]
    two_j_eta = 2.0 * j[:, None] * np.atleast_1d(eta_p)[None, :]
    xi = np.atleast_1d(xi_p) + np.sum(_ALPHA[:, None] * np.sin(two_j_xi) * np.cosh(two_j_eta), axis=0)
    eta = np.atleast_1d(eta_p) + np.sum(_ALPHA[:, None] * np.cos(two_j_xi) * np.sinh(two_j_eta), axis=0)

    easting = _E0 + _K0 * _ABAR * eta
    northing = _K0 * _ABAR * xi
    if np.isscalar(lat_deg) or np.ndim(lat_deg) == 0:
        return float(easting[0]), float(northing[0])
    return easting, northing


def gps2utm(df_gps, config_ref: dict, zone: int | None = None):
    """Add x/y (UTM offsets from the dataset reference) + relative altitude.

    Table semantics of reference tools/gpsconversions.py:6-41: columns
    ``x``/``y`` are UTM easting/northing minus the reference origin's, and
    ``altitude`` is re-based on the reference altitude.  ``zone=None`` derives
    the UTM zone from the reference longitude (pass ``zone=30`` to force the
    reference's hardcoded behavior).
    """
    lat_ref = config_ref["latitude"]
    lon_ref = config_ref["longitude"]
    alt_ref = config_ref["altitude"]
    if zone is None:
        zone = utm_zone_from_longitude(float(lon_ref))

    ref_x, ref_y = latlon_to_utm(lat_ref, lon_ref, zone=zone)
    x, y = latlon_to_utm(
        np.asarray(df_gps["latitude"], dtype=np.float64),
        np.asarray(df_gps["longitude"], dtype=np.float64),
        zone=zone,
    )
    out = {k: np.asarray(v) for k, v in df_gps.items()}
    out["x"] = x - ref_x
    out["y"] = y - ref_y
    out["altitude"] = np.asarray(df_gps["altitude"], np.float64) - alt_ref
    return out


def filter_gps(df_gps):
    """Drop rows with latitude == 0 (reference tools/gpsconversions.py:44-62)."""
    return take_rows(df_gps, np.asarray(df_gps["latitude"]) != 0.0)
