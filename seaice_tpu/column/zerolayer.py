"""Zero-layer (Semtner 0-layer) thermodynamics, ktherm=0.

JAX re-design of `ice_therm_0layer.F90` (zerolayer_temperature):
no internal heat capacity — the surface temperature satisfies the
instantaneous balance fsurf(Tsf) = kh (Tsf - Tbot) through the slab
(effective conductivity kseaice over hilyr + kratio*hslyr), solved by a
batched Newton iteration with convergence masking. Growth/melt use the
fresh-ice enthalpy -rhoi*Lfresh via the shared thickness_changes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import constants as c
from .thermo_shared import dsurface_heat_flux_dTsf, surface_heat_flux

KSEAICE_0LAYER = 2.0    # fixed slab conductivity (reference kseaice)
NITERMAX = 50
TSF_ERRMAX = 5.0e-4


class ZeroLayerResult(NamedTuple):
    Tsf: jnp.ndarray
    fsensn: jnp.ndarray
    flatn: jnp.ndarray
    flwoutn: jnp.ndarray
    fsurfn: jnp.ndarray
    fcondtopn: jnp.ndarray
    fcondbot: jnp.ndarray
    converged: jnp.ndarray


def zerolayer_temperature(dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
                          fswsfc, hilyr, hslyr, Tsf,
                          Tbot) -> ZeroLayerResult:
    """Solve the 0-layer surface balance in all columns at once."""
    del dt
    kratio = KSEAICE_0LAYER / c.KSNO
    heff = jnp.maximum(hilyr + kratio * hslyr, c.PUNY)
    kh = KSEAICE_0LAYER / heff
    zeros = jnp.zeros_like(Tsf)

    def body(carry):
        (Tsf, dTsf_prev, f_lw, f_sen, f_lat, f_surf, converged,
         niter) = carry
        flwoutn, fsensn, flatn, fsurfn = surface_heat_flux(
            Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef)
        _, _, _, dfsurf_dT = dsurface_heat_flux_dTsf(
            Tsf, rhoa, shcoef, lhcoef)
        fcondtop = kh * (Tsf - Tbot)
        Tsf_adj = jnp.where(fsurfn < fcondtop,
                            jnp.minimum(Tsf, -c.PUNY), Tsf)
        diag = dfsurf_dT - kh
        rhs = dfsurf_dT * Tsf_adj - fsurfn - kh * Tbot
        Tsf_new = rhs / diag
        dTsf = Tsf_new - Tsf_adj
        conv = jnp.abs(dTsf) < TSF_ERRMAX
        # surface capped at melting: excess resolved by melt in
        # thickness_changes
        melting = Tsf_new > 0.0
        Tsf_new = jnp.minimum(Tsf_new, 0.0)
        # oscillation damping
        osc = (dTsf * dTsf_prev < -c.PUNY)
        Tsf_new = jnp.where(osc, 0.5 * (Tsf_new + Tsf_adj), Tsf_new)
        conv = conv & ~osc
        # a surface pinned at the melting point that stays pinned is
        # converged (the excess flux melts ice in thickness_changes)
        conv = conv | (melting & (Tsf_adj >= -2.0 * c.PUNY))

        def sel(new, old):
            return jnp.where(converged, old, new)

        return (sel(Tsf_new, Tsf), sel(dTsf, dTsf_prev),
                sel(flwoutn, f_lw), sel(fsensn, f_sen),
                sel(flatn, f_lat), sel(fsurfn, f_surf),
                converged | conv, niter + 1)

    def cond(carry):
        return (~jnp.all(carry[-2])) & (carry[-1] <= NITERMAX)

    init = (Tsf, zeros, zeros, zeros, zeros, zeros,
            jnp.zeros(Tsf.shape, bool), jnp.array(1))
    (Tsf_f, _, flw_f, fsen_f, flat_f, fsurf_f, conv_f,
     _) = jax.lax.while_loop(cond, body, init)

    fcondtop = kh * (Tsf_f - Tbot)
    # melting surface: conduction capped at the surface flux (excess
    # melts the top)
    fcondtop = jnp.where(Tsf_f >= -c.PUNY,
                         jnp.minimum(fcondtop, fsurf_f), fcondtop)
    fcondbot = fcondtop       # no internal storage
    return ZeroLayerResult(
        Tsf=Tsf_f, fsensn=fsen_f, flatn=flat_f, flwoutn=flw_f,
        fsurfn=fsurf_f, fcondtopn=fcondtop, fcondbot=fcondbot,
        converged=conv_f)
