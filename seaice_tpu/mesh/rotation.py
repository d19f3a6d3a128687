"""Grid rotation and lat-lon vector rotation.

JAX re-design of the reference rotation machinery
(`mpas_seaice_mesh.F`: seaice_grid_rotation_forward :2350,
seaice_latlon_vector_rotation_forward :2530): the Cartesian grid is
rotated so the geographic poles map to the equator — moving the latlon
coordinate singularities away from the sea-ice covered regions — and
velocity components transform between the true and rotated east/north
frames.

Rotation convention (reference :2350-2420): forward maps
(x, y, z) -> (-z, y, x), i.e. the north pole (0,0,1) -> (-1,0,0).
"""

from __future__ import annotations

import numpy as np


def grid_rotation_forward(x, y, z):
    """(x,y,z) -> (-z, y, x)."""
    return -z, y, x


def grid_rotation_reverse(xr, yr, zr):
    """Inverse: (xr,yr,zr) -> (zr, yr, -xr)."""
    return zr, yr, -xr


def latlon_from_xyz(x, y, z):
    r = np.sqrt(x * x + y * y + z * z)
    lat = np.arcsin(np.clip(z / np.maximum(r, 1e-300), -1.0, 1.0))
    lon = np.arctan2(y, x)
    return lat, lon


def east_north_basis(x, y, z):
    """Unit east/north vectors at points on the sphere ([..., 3] each).
    Zero-length inputs (padded dummy entries) yield zero bases."""
    p = np.stack([x, y, z], axis=-1)
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-300)
    zhat = np.array([0.0, 0.0, 1.0])
    e = np.cross(np.broadcast_to(zhat, p.shape), p)
    n = np.linalg.norm(e, axis=-1, keepdims=True)
    e = e / np.maximum(n, 1e-300)
    nvec = np.cross(p, e)
    return e, nvec


def latlon_vector_rotation_forward(u_true, v_true, x, y, z):
    """Rotate velocity components from the TRUE east/north frame at
    (x,y,z) to the ROTATED grid's east/north frame (reference
    seaice_latlon_vector_rotation_forward, mpas_seaice_mesh.F:2530).

    Returns (u_rot, v_rot)."""
    e_t, n_t = east_north_basis(x, y, z)
    vec = u_true[..., None] * e_t + v_true[..., None] * n_t  # 3D vector
    # rotate the 3D vector with the grid
    vx, vy, vz = vec[..., 0], vec[..., 1], vec[..., 2]
    vxr, vyr, vzr = -vz, vy, vx
    xr, yr, zr = grid_rotation_forward(x, y, z)
    e_r, n_r = east_north_basis(xr, yr, zr)
    vec_r = np.stack([vxr, vyr, vzr], axis=-1)
    u_rot = (vec_r * e_r).sum(-1)
    v_rot = (vec_r * n_r).sum(-1)
    return u_rot, v_rot


def latlon_vector_rotation_reverse(u_rot, v_rot, x, y, z):
    """Inverse of latlon_vector_rotation_forward; (x,y,z) are the
    UNROTATED coordinates."""
    xr, yr, zr = grid_rotation_forward(x, y, z)
    e_r, n_r = east_north_basis(xr, yr, zr)
    vec_r = u_rot[..., None] * e_r + v_rot[..., None] * n_r
    vxr, vyr, vzr = vec_r[..., 0], vec_r[..., 1], vec_r[..., 2]
    vx, vy, vz = grid_rotation_reverse(vxr, vyr, vzr)
    e_t, n_t = east_north_basis(x, y, z)
    vec = np.stack([vx, vy, vz], axis=-1)
    return (vec * e_t).sum(-1), (vec * n_t).sum(-1)
