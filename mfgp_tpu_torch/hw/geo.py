"""GPS geometry (SURVEY C23; reference/controllerHelper.py:210-231).

Counterpart of ``mfgp_tpu/hw/geo.py``, copied as it is (numpy only).
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_M = 6371000.0


def gps_bearing_distance(lat, lon, target_lat, target_lon):
    """Great-circle initial bearing (degrees from north) and haversine
    distance (meters) to a target fix
    (reference/controllerHelper.py:214-231)."""
    lat1, lat2 = np.deg2rad(lat), np.deg2rad(target_lat)
    lon1, lon2 = np.deg2rad(lon), np.deg2rad(target_lon)
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    y = np.sin(dlon) * np.cos(lat2)
    x = (np.cos(lat1) * np.sin(lat2)
         - np.sin(lat1) * np.cos(lat2) * np.cos(dlat))
    bearing = np.rad2deg(np.arctan2(y, x))
    a = (np.sin(dlat / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2)
    dist = EARTH_RADIUS_M * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))
    return bearing, dist


def convert_gps_format(lat, lon):
    """ddmm.mmmm -> dd.mmmmmm (reference/controllerHelper.py:229-231 keeps
    this simplistic /100 conversion; reproduced as-is)."""
    return lat / 100.0, lon / 100.0
