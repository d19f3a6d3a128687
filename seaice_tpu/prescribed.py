"""Prescribed (data) ice mode.

JAX re-design of `mpas_seaice_prescribed.F`
(seaice_run_prescribed_ice :128-320): impose observed ice coverage on
the state each step — the CIME `_MPASSI%PRES` compset behavior. The
per-cell branching becomes masked dense updates.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import jax.numpy as jnp

from . import constants as c
from .column.thermo_shared import (ice_enthalpy_from_temperature,
                                   melting_temperature, salinity_profile,
                                   snow_enthalpy_from_temperature)

COVERAGE_MIN = 1.0e-4


def prescribe_ice_state(tracers: Dict[str, jnp.ndarray],
                        ice_coverage, lat_cell,
                        sea_freezing_temperature,
                        hin_max: np.ndarray) -> Dict[str, jnp.ndarray]:
    """Impose `ice_coverage` [nCells] on the category state.

    Northern hemisphere prescribed thickness 2 m, southern 1 m
    (reference :215-224); the matching thickness category receives all
    the area; other categories are zeroed. Enthalpy/salinity profiles
    are initialized where previously unset."""
    tr = dict(tracers)
    aicen = tr["iceAreaCategory"]
    ncat = aicen.shape[-1]
    ni = tr["iceEnthalpy"].shape[-1]
    ns = tr["snowEnthalpy"].shape[-1]

    cov = jnp.clip(jnp.where(ice_coverage < COVERAGE_MIN, 0.0,
                             ice_coverage), 0.0, 1.0)
    has_cov = cov >= COVERAGE_MIN
    h_presc = jnp.where(lat_cell >= 0.0, 2.0, 1.0)

    sprof = jnp.asarray(salinity_profile(ni), aicen.dtype)
    tf = sea_freezing_temperature

    new = {k: [] for k in ("iceAreaCategory", "iceVolumeCategory",
                           "snowVolumeCategory", "surfaceTemperature",
                           "iceEnthalpy", "iceSalinity", "snowEnthalpy")}
    for n in range(ncat):
        in_cat = has_cov & (h_presc >= hin_max[n]) & \
            (h_presc < hin_max[n + 1])
        a_old = aicen[..., n]
        hs_old = jnp.where(a_old > 0.0,
                           tr["snowVolumeCategory"][..., n] /
                           jnp.where(a_old > 0, a_old, 1.0), 0.0)
        a_new = jnp.where(in_cat, cov, 0.0)
        v_new = jnp.where(in_cat, h_presc * cov, 0.0)
        vs_new = jnp.where(in_cat, hs_old * cov, 0.0)

        tsf_old = tr["surfaceTemperature"][..., n]
        tsf = jnp.where(in_cat, jnp.where(a_old < c.PUNY, tf, tsf_old),
                        tf)
        # initialize profiles where enthalpy was unset (reference
        # :230-250): linear temperature gradient surface -> freezing
        q_old = tr["iceEnthalpy"][..., n, :]
        unset = jnp.abs(q_old).sum(-1) < c.PUNY
        k = (jnp.arange(ni, dtype=aicen.dtype) + 0.5) / ni
        t_ice = tsf[..., None] + (tf - tsf)[..., None] * k
        q_init = ice_enthalpy_from_temperature(
            t_ice, melting_temperature(sprof))
        s_init = jnp.broadcast_to(sprof, q_old.shape)
        q_new = jnp.where((in_cat & unset)[..., None], q_init, q_old)
        s_new = jnp.where((in_cat & unset)[..., None], s_init,
                          tr["iceSalinity"][..., n, :])
        qs_init = snow_enthalpy_from_temperature(tsf)[..., None] * \
            jnp.ones((1,) * tsf.ndim + (ns,), aicen.dtype)
        qs_old = tr["snowEnthalpy"][..., n, :]
        qs_unset = jnp.abs(qs_old).sum(-1) < c.PUNY
        qs_new = jnp.where((in_cat & qs_unset)[..., None], qs_init,
                           qs_old)
        out_cat = ~in_cat
        new["iceAreaCategory"].append(a_new)
        new["iceVolumeCategory"].append(v_new)
        new["snowVolumeCategory"].append(vs_new)
        new["surfaceTemperature"].append(tsf)
        new["iceEnthalpy"].append(jnp.where(out_cat[..., None], 0.0,
                                            q_new))
        new["iceSalinity"].append(jnp.where(out_cat[..., None], 0.0,
                                            s_new))
        new["snowEnthalpy"].append(jnp.where(out_cat[..., None], 0.0,
                                             qs_new))

    for k2 in ("iceAreaCategory", "iceVolumeCategory",
               "snowVolumeCategory", "surfaceTemperature"):
        tr[k2] = jnp.stack(new[k2], axis=-1)
    for k2 in ("iceEnthalpy", "iceSalinity", "snowEnthalpy"):
        tr[k2] = jnp.stack(new[k2], axis=-2)
    return tr
