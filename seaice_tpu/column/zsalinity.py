"""Prognostic vertical salinity (solve_zsal, ktherm=1 companion).

JAX re-design of the reference's `src/column/ice_zsalinity.F90`
(`zsalinity` :38-182 -> `solve_zsalinity` :188-425 -> `solve_S_dt`
:435-885): the bulk salinity on the bio grid evolves by gravity
drainage (the Rayleigh-number-gated convective diffusivity iDin from
`brine.py`), Darcy flushing, and exchange with the ocean at the brine
bottom; growth entrains ocean salt scaled by (1 - salt_loss).

Redesign: the reference's per-cell adaptive sub-stepping and
flux-corrected matrix assembly become one batched implicit
advection-diffusion Thomas solve per sub-step, vectorized over
[cells, categories], with positivity enforced by the min_salin floor
and the clipped salt booked into the ocean flux (conservation is exact
by construction).  Sub-stepping is ADAPTIVE per column, as in the
reference (`solve_S_dt`, ice_zsalinity.F90:435-885, which shrinks dts
until the drainage/flushing rates are resolved): each column picks
n_eff = ceil(dt * rate) sub-steps of dt/n_eff from its own
diffusion+advection+exchange rate, capped at N_SUBSTEPS_MAX; the
batched loop runs N_SUBSTEPS_MAX iterations with finished columns
frozen by masking (the lax-friendly analog of a per-cell while loop).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from . import constants as c
from .brine import MIN_SALIN
from .zbgc import _thomas

SALT_LOSS = 0.4          # fraction of ocean salt retained on growth
                         # (reference ice_colpkg_shared.F90:46)
N_SUBSTEPS_MAX = 8       # cap on adaptive sub-steps per coupling step
N_SUBSTEPS = N_SUBSTEPS_MAX   # back-compat alias


class ZsalResult(NamedTuple):
    bSin: jnp.ndarray        # [*B, nblyr] bulk salinity on bio layers
    fzsal: jnp.ndarray       # total salt flux to ocean (kg/m^2/s)
    fzsal_g: jnp.ndarray     # gravity-drainage component alone
                             # (reference calc_salt_fluxes :891 tracks
                             # fzsal and fzsal_g separately)
    zsal_tot: jnp.ndarray    # total column salt (g/m^2)


def solve_zsalinity(dt, bSin, iphin, iDin, darcy_v, hbr, hbr_old,
                    dh_bot, dh_top, sss, brine_sal_bottom) -> ZsalResult:
    """Advance the vertical bulk salinity (reference solve_zsalinity /
    solve_S_dt).

    bSin [*B, nblyr] bulk salinity (ppt) on the interior bio layers;
    iphin/iDin [*B, nblyr+1] on the interface grid; darcy_v [*B]
    (m/s); hbr/hbr_old [*B]; dh_bot/dh_top [*B] brine-boundary motion
    (+growth / -melt at the bottom; top melt <0); sss [*B];
    brine_sal_bottom [*B] equilibrium brine salinity at the bottom."""
    nblyr = bSin.shape[-1]
    dx = 1.0 / nblyr
    hbr_s = jnp.maximum(hbr, c.PUNY)

    # nondimensional velocities
    w = darcy_v / jnp.maximum(iphin[..., nblyr // 2], c.PUNY) / hbr_s
    growth_vel = jnp.maximum(dh_bot, 0.0) / dt / hbr_s
    melt_vel = jnp.maximum(-dh_bot, 0.0) / dt / hbr_s

    # adaptive per-column sub-stepping (reference solve_S_dt adapts
    # dts until drainage/flushing rates are resolved): resolve the
    # fastest local rate (diffusion + advection + bottom exchange) at
    # ~one e-folding per sub-step, capped at N_SUBSTEPS_MAX; the
    # implicit solve is unconditionally stable, so the cap costs
    # accuracy only in the stiffest transients, like the reference's
    # own dts floor
    Dif_all = 0.5 * (iDin[..., :nblyr] + iDin[..., 1:nblyr + 1])
    rate = (Dif_all.max(-1) / dx ** 2 + jnp.abs(w) / dx +
            2.0 * iDin[..., nblyr] / dx ** 2 +
            (growth_vel + melt_vel) / dx)
    n_eff = jnp.clip(jnp.ceil(dt * rate), 1.0, float(N_SUBSTEPS_MAX))
    dts = dt / n_eff                       # per-column sub-step [*B]

    S = bSin
    fzsal = jnp.zeros(bSin.shape[:-1], bSin.dtype)
    fzsal_g = jnp.zeros_like(fzsal)
    # ocean-entrained salinity on growth: (1-salt_loss) * ocean brine
    S_entrain = (1.0 - SALT_LOSS) * sss
    to_flux = dx * hbr_s * c.RHOI * 1.0e-3 / dt   # nondim -> kg/m^2/s

    for isub in range(N_SUBSTEPS_MAX):
        active = isub < n_eff              # [*B] bool
        Dif = Dif_all
        lo = jnp.zeros_like(S)
        di = jnp.ones_like(S)
        up = jnp.zeros_like(S)
        rhs = S
        for k in range(nblyr):
            d_dn = Dif[..., k] / dx ** 2 if k < nblyr - 1 else 0.0
            d_up = Dif[..., k - 1] / dx ** 2 if k > 0 else 0.0
            a_dn = jnp.maximum(-w, 0.0) / dx if k < nblyr - 1 else 0.0
            a_up = jnp.maximum(w, 0.0) / dx if k > 0 else 0.0
            diag = 1.0 + dts * (d_dn + d_up + a_dn + a_up)
            if k == nblyr - 1:
                # bottom: gravity-drainage exchange with the ocean +
                # growth entrainment + melt loss
                ex = 2.0 * iDin[..., nblyr] / dx ** 2 + \
                    jnp.maximum(w, 0.0) / dx + growth_vel / dx + \
                    melt_vel / dx
                diag = diag + dts * ex
                src = (2.0 * iDin[..., nblyr] / dx ** 2 +
                       jnp.maximum(w, 0.0) / dx) * sss + \
                    growth_vel / dx * S_entrain
                rhs = rhs.at[..., k].add(dts * src)
            di = di.at[..., k].set(diag)
            if k > 0:
                lo = lo.at[..., k].set(-dts * (d_up + a_up))
            if k < nblyr - 1:
                up = up.at[..., k].set(-dts * (d_dn + a_dn))
        S_new = _thomas(lo, di, up, rhs)
        # columns past their adaptive sub-step count are frozen
        S_new = jnp.where(active[..., None], S_new, S)
        # salt budget: ocean flux from the change (kg/m^2/s); bulk
        # salinity S [ppt] * rho_si ~ g salt / m^3 * 1e-3
        dsalt = ((S_new - S) * dx).sum(-1) * hbr_s * \
            c.RHOI * 1.0e-3                  # kg/m^2 per substep
        fzsal = fzsal - dsalt / dt
        # gravity-drainage component alone (the implicit bottom
        # molecular-sublayer exchange evaluated at the new state —
        # backward Euler makes this the exact booked contribution;
        # reference calc_salt_fluxes :891 splits fzsal_g the same way)
        gd = jnp.where(active,
                       2.0 * iDin[..., nblyr] / dx ** 2 *
                       (S_new[..., -1] - sss) * dts, 0.0)
        fzsal_g = fzsal_g + gd * to_flux
        S = S_new

    # min_salin floor; clipped salt comes from the ocean
    S_f = jnp.maximum(S, MIN_SALIN)
    fzsal = fzsal - ((S_f - S) * dx).sum(-1) * hbr_s * \
        c.RHOI * 1.0e-3 / dt
    zsal_tot = (S_f * dx).sum(-1) * hbr_s * c.RHOI * 1.0e-3
    return ZsalResult(bSin=S_f, fzsal=fzsal, fzsal_g=fzsal_g,
                      zsal_tot=zsal_tot)
