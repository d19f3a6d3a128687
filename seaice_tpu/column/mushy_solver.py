"""Mushy-layer vertical heat solver (ktherm=2): batched Picard iteration.

JAX re-design of the reference mushy temperature solve
(`ice_therm_mushy.F90`: picard_solver :1128-1406 with
solve_heat_conduction :2110 and the matrix_elements_* family
:2345-2851): the liquid fraction phi is frozen at its step-initial
value for the WHOLE solve (as in the reference, where phi is
intent(in) throughout picard_solver); each Picard iteration re-solves
a tridiagonal system for the new temperatures (effective heat capacity
phi*(cw-ci)+ci, latent heat in the right-hand side) with re-linearized
surface fluxes — batched over all columns with per-column convergence
masking, like the BL99 solver.

Gravity drainage and flushing (reference explicit_flow_velocities
:3005-3176, flushing_velocity :3182-3298, solve_salinity :2855-2931):
the rapid-mode convective Darcy flow q and slow-mode desalination rate
dSdt are computed once per step from the Rayleigh number of the mush
(suffix min/sum scans replace the reference's bottom-up accumulation
loop), the flushing velocity w from the pond hydraulic head through
the harmonic-mean Golden-2007 permeability; q and w enter the Picard
heat matrix as advective brine-heat terms, and bulk salinity evolves
explicitly after convergence.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as c
from .bl99 import _tridiag
from .mushy import (conductivity_mush, density_brine, enthalpy_brine,
                    enthalpy_mush, enthalpy_mush_liquid_fraction,
                    liquid_fraction, liquidus_brine_salinity,
                    temperature_mush)
from .thermo_shared import (dsurface_heat_flux_dTsf,
                            snow_enthalpy_from_temperature,
                            snow_temperature_from_enthalpy,
                            surface_heat_flux)

NITERMAX = 100
DT_ERRMAX = 5.0e-4
_CW = c.CP_OCN * c.RHOW
_CI = c.CP_ICE * c.RHOI
_LI = c.LFRESH * c.RHOI

# drainage parameters (reference Registry.xml:1639-1668 defaults)
A_RAPID_MODE = 0.5e-3      # brine channel radius (m)
RAC_RAPID_MODE = 10.0      # critical Rayleigh number
ASPECT_RAPID_MODE = 1.0    # convection cell aspect ratio
DSDT_SLOW_MODE = -5.0e-8   # slow-mode drainage strength (m/s/K)
PHI_C_SLOW_MODE = 0.05     # slow-mode porosity cutoff
KAPPA_L = 8.824e-8         # heat diffusivity of liquid (m^2/s)
S_MIN = 0.01               # minimum bulk salinity (ppt)


def permeability_mush(phi):
    """Golden et al. 2007 hierarchical-model permeability (reference
    `permeability`, ice_therm_mushy.F90:2985-3001)."""
    return 3.0e-8 * jnp.maximum(phi - 0.05, 0.0) ** 3


def explicit_flow_velocities(dt, zSin, zTin, Tsf, Tbot, sss, qocn,
                             hilyr, hin, tun=None):
    """Rapid-mode Darcy flow q and slow-mode desalination rate dSdt
    (reference explicit_flow_velocities :3005-3176). The reference's
    bottom-up running accumulations (min permeability, harmonic-mean
    permeability, brine density sum from each layer to the ocean)
    become flipped cumulative scans over the layer axis.

    zSin/zTin [*B, ni]; the rest [*B]. Returns (q, dSdt, Sbr, qbr,
    phi) all [*B, ni]; q[k] is the upward interface flow under layer
    k."""
    if tun is None:
        from .tuning import DEFAULT as tun
    ni = zSin.shape[-1]
    Sbr = liquidus_brine_salinity(zTin)
    phi = liquid_fraction(zTin, zSin)
    qbr = enthalpy_brine(zTin)
    rho = density_brine(Sbr)
    rho_ocn = density_brine(sss)[..., None]
    ra_const = c.GRAVIT / (c.VISCOSITY_DYN * KAPPA_L)
    qlimit = (0.2 * hilyr / dt)[..., None]

    perm = permeability_mush(phi)

    ax = perm.ndim - 1
    perm_min = jax.lax.cummin(perm, axis=ax, reverse=True)
    perm_harm = jax.lax.cumsum(1.0 / jnp.maximum(perm, 1.0e-30),
                               axis=ax, reverse=True)
    rho_sum = jax.lax.cumsum(rho, axis=ax, reverse=True)
    rho_pipe = 0.5 * (rho + jnp.concatenate(
        [rho[..., :1], rho[..., :-1]], -1))          # rho(0)=rho(1)

    z = ((np.arange(ni) + 0.5) / ni) * hin[..., None]
    drho = jnp.maximum(rho - rho_ocn, 0.0)
    Ra = drho * (hin[..., None] - z) * perm_min * ra_const

    rn = jnp.asarray(ni - np.arange(ni), zSin.dtype)  # layers k..bottom
    L = rn * hilyr[..., None]
    dx2 = (L * 2.0 * tun.rapid_mode_aspect_ratio) ** 2
    Am = dx2 * rn / (c.VISCOSITY_DYN * perm_harm)
    Bm = -c.GRAVIT * rho_sum / rn
    Ap = np.pi * tun.rapid_mode_channel_radius ** 4 / \
        (8.0 * c.VISCOSITY_DYN)
    Bp = -rho_pipe * c.GRAVIT
    q = jnp.maximum((Am / dx2) * ((-Ap * Bp - Am * Bm) / (Am + Ap) +
                                  Bm), 1.0e-30)
    q = jnp.minimum(q * jnp.maximum(
        Ra - tun.rapid_mode_critical_ra, 0.0) /
                    (Ra + c.PUNY), qlimit)

    dSdt = tun.slow_mode_drainage_strength * \
        jnp.maximum(zSin - tun.slow_mode_critical_porosity * Sbr,
                    0.0) * \
        jnp.maximum(Tbot - Tsf, 0.0)[..., None] / \
        (hin[..., None] + 0.001)
    dSdt = jnp.maximum(dSdt, -zSin * 0.5 / dt)

    # safety limiter: never drive salinity below zSin_min = 0.1
    Sbr_dn = jnp.concatenate([Sbr[..., 1:], sss[..., None] *
                              jnp.ones_like(Sbr[..., :1])], -1)
    dS_guess = ((q * (Sbr_dn - Sbr)) / hilyr[..., None] + dSdt) * \
        dt * 10.0
    alpha = jnp.where(jnp.abs(dS_guess) < c.PUNY, 1.0,
                      (0.1 - zSin) / jnp.where(
                          jnp.abs(dS_guess) < c.PUNY, 1.0, dS_guess))
    alpha = jnp.where((alpha < 0.0) | (alpha > 1.0), 1.0, alpha)
    return q * alpha, dSdt * alpha, Sbr, qbr, phi


def flushing_velocity(dt, zTin, phi, hin, hsn, hilyr, hpond, apond):
    """Downward flushing Darcy velocity from the pond hydraulic head
    (reference flushing_velocity :3182-3298). All [*B]; phi/zTin
    [*B, ni]. Returns w >= 0 [*B]."""
    ni = phi.shape[-1]
    perm = permeability_mush(phi)
    phi_min = phi.min(-1)
    ice_mass = ((phi * density_brine(liquidus_brine_salinity(zTin)) +
                 (1.0 - phi) * c.RHOI).sum(-1)) * hilyr
    perm_harm = ni / (1.0 / jnp.maximum(perm, 1.0e-30)).sum(-1)
    hocn = (ice_mass + hpond * apond * c.RHOW + hsn * c.RHOS) / c.RHOW
    dhhead = jnp.maximum(hin + hpond - hocn, 0.0)
    w = perm_harm * c.RHOW * c.GRAVIT * \
        (dhhead / jnp.maximum(hin, c.PUNY)) / c.VISCOSITY_DYN
    w = jnp.minimum(w, hpond * apond / dt)
    wlimit = (0.005 * phi_min * hilyr) / dt
    w = jnp.where(jnp.abs(w) > c.PUNY,
                  w * jnp.clip(wlimit / jnp.maximum(jnp.abs(w),
                                                    c.PUNY), 0.0, 1.0),
                  0.0)
    return jnp.maximum(w, 0.0)


def solve_salinity(dt, zSin, Sbr, Spond, sss, q, dSdt, w, hilyr):
    """Explicit bulk-salinity update from drainage + flushing
    (reference solve_salinity :2855-2931): upward Darcy flow advects
    brine salinity from below, flushing advects from above (pond
    water into the top layer), floored at S_min."""
    Sbr_dn = jnp.concatenate(
        [Sbr[..., 1:],
         sss[..., None] * jnp.ones_like(Sbr[..., :1])], -1)
    Sbr_up = jnp.concatenate(
        [Spond[..., None] * jnp.ones_like(Sbr[..., :1]),
         Sbr[..., :-1]], -1)
    h = hilyr[..., None]
    dS = (q * (Sbr_dn - Sbr)) / h + dSdt + \
        (w[..., None] * (Sbr_up - Sbr)) / h
    return zSin + jnp.maximum(S_MIN - zSin, dS * dt)


def drainage_heat_fluxes(q, w, qbr, qocn, qpond):
    """Advective heat to the ocean (reference picard_drainage_fluxes
    :1710-1746 + picard_flushing_fluxes :1750-1771)."""
    qbr_dn = jnp.concatenate(
        [qbr[..., 1:],
         qocn[..., None] * jnp.ones_like(qbr[..., :1])], -1)
    fadv = -(q * (qbr_dn - qbr)).sum(-1)
    return fadv + w * (qbr[..., -1] - qpond)


class MushySolveResult(NamedTuple):
    Tsf: jnp.ndarray
    zTsn: jnp.ndarray
    zTin: jnp.ndarray
    zqsn: jnp.ndarray
    zqin: jnp.ndarray
    phi: jnp.ndarray
    fsensn: jnp.ndarray
    flatn: jnp.ndarray
    flwoutn: jnp.ndarray
    fsurfn: jnp.ndarray
    fcondtopn: jnp.ndarray
    fcondbot: jnp.ndarray
    converged: jnp.ndarray
    zSin: jnp.ndarray        # bulk salinity after drainage (ppt)
    fadvheat: jnp.ndarray    # advective heat to ocean (W/m^2)
    w: jnp.ndarray           # flushing Darcy velocity (m/s)


def _intercell(hilyr, hslyr, km, ks, l_snow, ns, ni):
    """Grid-point distances dxp and interface conductivities kcstar
    (reference calc_intercell_thickness/_conductivity). All [*B, ...]."""
    rows = []
    krow = []
    # snow-present layout
    dxp_s = [hslyr / 2.0] + [hslyr] * (ns - 1) + \
        [(hilyr + hslyr) / 2.0] + [hilyr] * (ni - 1) + [hilyr / 2.0]
    kc_s = [ks[..., 0]]
    for k in range(1, ns):
        kc_s.append(2.0 * ks[..., k] * ks[..., k - 1] /
                    (ks[..., k] + ks[..., k - 1]))
    fe = hilyr / jnp.maximum(hilyr + hslyr, c.PUNY)
    kc_s.append(1.0 / ((1.0 - fe) / jnp.maximum(ks[..., ns - 1], c.PUNY)
                       + fe / jnp.maximum(km[..., 0], c.PUNY)))
    for k in range(1, ni):
        kc_s.append(2.0 * km[..., k] * km[..., k - 1] /
                    (km[..., k] + km[..., k - 1]))
    kc_s.append(km[..., ni - 1])
    # no-snow layout: shift ice to the front, zero-pad the tail
    dxp_n = [hilyr / 2.0] + [hilyr] * (ni - 1) + [hilyr / 2.0] + \
        [jnp.zeros_like(hilyr)] * ns
    kc_n = [km[..., 0]]
    for k in range(1, ni):
        kc_n.append(2.0 * km[..., k] * km[..., k - 1] /
                    (km[..., k] + km[..., k - 1]))
    kc_n.append(km[..., ni - 1])
    kc_n += [jnp.zeros_like(hilyr)] * ns

    ls = l_snow
    for i in range(ns + ni + 1):
        rows.append(jnp.where(ls, dxp_s[i], dxp_n[i]))
        krow.append(jnp.where(ls, kc_s[i], kc_n[i]))
    return jnp.stack(rows, -1), jnp.stack(krow, -1)


def temperature_changes_mushy(dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
                              fswsfc, fswint, Sswabs, Iswabs,
                              hilyr, hslyr, zqin, zSin, zqsn,
                              Tsf, Tbot, sss=None, hpond=None,
                              apond=None,
                              tun=None) -> MushySolveResult:
    """Solve the mushy heat equation in all columns at once.

    Shapes as in bl99.temperature_changes. With sss given, gravity
    drainage (rapid q + slow dSdt) and — with hpond/apond — pond
    flushing w are active: q and w advect brine heat through the
    Picard matrix and bulk salinity evolves explicitly after
    convergence (reference temperature_changes_salinity :35-341).
    With sss=None the q = w = 0 fixed-salinity configuration runs."""
    ns = zqsn.shape[-1]
    ni = zqin.shape[-1]

    l_snow = hslyr > c.HS_MIN / ns
    zTin = temperature_mush(zqin, zSin)
    phi = liquid_fraction(zTin, zSin)
    zTsn = jnp.where(l_snow[..., None],
                     jnp.minimum(snow_temperature_from_enthalpy(zqsn),
                                 0.0), 0.0)
    zqsn0 = jnp.where(l_snow[..., None], zqsn,
                      snow_enthalpy_from_temperature(0.0) *
                      jnp.ones_like(zqsn))
    km = conductivity_mush(zqin, zSin)
    ks = jnp.full_like(zqsn, c.KSNO)
    dxp, kc = _intercell(jnp.maximum(hilyr, c.PUNY), hslyr, km, ks,
                         l_snow, ns, ni)

    zqin0 = zqin
    hil = jnp.maximum(hilyr, c.PUNY)
    hsl = hslyr
    einit = (hil[..., None] * zqin).sum(-1) + \
        jnp.where(l_snow, (hsl[..., None] * zqsn0).sum(-1), 0.0)
    zeros = jnp.zeros_like(Tsf)

    # drainage velocities, held fixed through the Picard iteration
    # (reference temperature_changes_salinity :210-224)
    hin = hil * ni
    qocn = enthalpy_brine(Tbot)
    qpond = jnp.zeros_like(Tsf)      # enthalpy_brine(0 C)
    Spond = jnp.zeros_like(Tsf)
    if sss is not None:
        q, dSdt, _, _, _ = explicit_flow_velocities(
            dt, zSin, zTin, Tsf, Tbot, sss, qocn, hil, hin, tun=tun)
        if hpond is not None:
            hsn = jnp.where(l_snow, hsl * ns, 0.0)
            w = flushing_velocity(dt, zTin, phi, hin, hsn, hil,
                                  hpond, apond)
        else:
            w = zeros
    else:
        q = jnp.zeros_like(zqin)
        dSdt = jnp.zeros_like(zqin)
        w = zeros

    def one_iteration(carry):
        # *_pp are the k-2 iterates (for the oscillation detector); the
        # unsuffixed values are the k-1 iterates
        (Tsf, zTsn, zTin, phi, Tsf_pp, zTsn_pp, zTin_pp,
         fsurf_p, fct_p, fcb_p, flw_p, fsn_p, flt_p,
         converged, niter) = carry

        flwoutn, fsensn, flatn, fsurfn = surface_heat_flux(
            Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef)
        _, _, _, dfsurf_dT = dsurface_heat_flux_dTsf(
            Tsf, rhoa, shcoef, lhcoef)
        l_cold = Tsf < 0.0

        # assemble the fixed-size tridiagonal (reference
        # matrix_elements_*): row 0 = Tsf (snow), rows 1..ns snow,
        # row ns doubles as Tsf for bare ice, rows ns+1..ns+ni ice.
        nmat = ns + ni + 1
        SB = [zeros] * nmat
        D = [jnp.ones_like(Tsf)] * nmat
        SP = [zeros] * nmat
        R = [zeros] * nmat

        tsf_diag = dfsurf_dT - jnp.where(l_snow, kc[..., 0] /
                                         dxp[..., 0],
                                         kc[..., 0] / dxp[..., 0])
        tsf_sp = jnp.where(l_snow, kc[..., 0] / dxp[..., 0],
                           kc[..., 0] / dxp[..., 0])
        tsf_rhs = dfsurf_dT * Tsf - fsurfn

        row0_is_tsf = l_snow & l_cold
        D[0] = jnp.where(row0_is_tsf, tsf_diag, 1.0)
        SP[0] = jnp.where(row0_is_tsf, tsf_sp, 0.0)
        R[0] = jnp.where(row0_is_tsf, tsf_rhs, 0.0)

        # snow rows (heat capacity rhos*cp_ice; reference
        # matrix_elements_snow_*)
        rcs = c.RHOS * c.CP_ICE
        for k in range(ns):
            r = k + 1
            kup = kc[..., k] / dxp[..., k]
            kdn = kc[..., k + 1] / dxp[..., k + 1]
            diag = (rcs / dt) * hsl + kup + kdn
            # rhos*ci*T_old = q_s0 + rhos*Lfresh (snow enthalpy relation)
            rhs = ((zqsn0[..., k] + c.RHOS * c.LFRESH) / dt) * hsl + \
                Sswabs[..., k]
            sb = -kup
            if k == 0:
                # melting surface: Tsf = 0 contributes nothing to rhs
                sb = jnp.where(l_cold, -kup, 0.0)
            SB[r] = jnp.where(l_snow, sb, 0.0)
            D[r] = jnp.where(l_snow, diag, 1.0)
            SP[r] = jnp.where(l_snow, -kdn, 0.0)
            R[r] = jnp.where(l_snow, rhs, 0.0)

        rowns_is_tsf = (~l_snow) & l_cold
        D[ns] = jnp.where(rowns_is_tsf, tsf_diag, D[ns])
        SP[ns] = jnp.where(rowns_is_tsf, tsf_sp, SP[ns])
        R[ns] = jnp.where(rowns_is_tsf, tsf_rhs, R[ns])
        SB[ns] = jnp.where(rowns_is_tsf, 0.0, SB[ns])

        # ice rows: interface index in the snow layout is k+ns; in the
        # bare layout it is k. Select per column.
        for k in range(ni):
            r = ns + 1 + k
            i_s = k + ns          # snow-present interface index
            i_n = k               # bare-ice interface index
            kup = jnp.where(l_snow, kc[..., i_s] / dxp[..., i_s],
                            kc[..., i_n] / jnp.maximum(dxp[..., i_n],
                                                       c.PUNY))
            kdn = jnp.where(l_snow,
                            kc[..., i_s + 1] / dxp[..., i_s + 1],
                            kc[..., i_n + 1] /
                            jnp.maximum(dxp[..., i_n + 1], c.PUNY))
            ceff = (phi[..., k] * (_CW - _CI) + _CI) / dt * hil
            # advective brine-heat coupling (reference
            # matrix_elements_* :2520-2560: upward Darcy q from below,
            # downward flushing w from above, brine heat capacity cw)
            diag = ceff + kup + kdn + (q[..., k] + w) * _CW
            rhs = (((1.0 - phi[..., k]) * _LI + zqin0[..., k]) / dt) * \
                hil + Iswabs[..., k]
            sb = -kup
            sp = -kdn - q[..., k] * _CW
            if k == 0:
                # bare melting surface: Tsf = 0 enters the rhs;
                # flushing brings pond water into the top ice layer
                warm_bare = (~l_snow) & (~l_cold)
                sb = jnp.where(warm_bare, 0.0, sb)
                rhs = rhs + w * qpond
            else:
                sb = sb - w * _CW
            if k == ni - 1:
                sp = zeros
                rhs = rhs + kdn * Tbot + q[..., k] * qocn
            SB[r], D[r], SP[r], R[r] = sb, diag, sp, rhs

        Tmat = _tridiag(jnp.stack(SB, -1), jnp.stack(D, -1),
                        jnp.stack(SP, -1), jnp.stack(R, -1))

        Tsf_new = jnp.where(
            l_cold, jnp.where(l_snow, Tmat[..., 0], Tmat[..., ns]), 0.0)
        # two-stage switch (reference two_stage_solver_*): a cold solve
        # ending above melt restarts as a melting surface
        went_melt = Tsf_new > 0.0
        Tsf_new = jnp.minimum(Tsf_new, 0.0)
        zTsn_new = jnp.where(l_snow[..., None],
                             jnp.minimum(Tmat[..., 1:ns + 1], 0.0), 0.0)
        zTin_new = Tmat[..., ns + 1:]

        # phi stays FROZEN at its step-initial value through the whole
        # Picard iteration, exactly like the reference (phi is
        # intent(in) everywhere inside picard_solver :1128-1406 and
        # picard_final :1923 rebuilds the enthalpy with it): with phi
        # fixed the system is nearly linear and converges in a few
        # iterations; the phase-change error is first order in dt
        phi_new = phi

        # convergence: temperature change + energy closure (reference
        # check_picard_convergence)
        dT = jnp.maximum(
            jnp.abs(Tsf_new - Tsf),
            jnp.maximum(jnp.abs(zTsn_new - zTsn).max(-1),
                        jnp.abs(zTin_new - zTin).max(-1)))
        zqin_new = enthalpy_mush_liquid_fraction(zTin_new, phi)
        zqsn_new = snow_enthalpy_from_temperature(zTsn_new)
        efinal = (hil[..., None] * zqin_new).sum(-1) + \
            jnp.where(l_snow, (hsl[..., None] * zqsn_new).sum(-1), 0.0)
        fcondtop = jnp.where(
            l_snow,
            kc[..., 0] / dxp[..., 0] * (Tsf_new - zTsn_new[..., 0]),
            kc[..., 0] / jnp.maximum(dxp[..., 0], c.PUNY) *
            (Tsf_new - zTin_new[..., 0]))
        fcondbot = 2.0 * km[..., ni - 1] * (zTin_new[..., ni - 1] -
                                            Tbot) / hil
        fadv = drainage_heat_fluxes(q, w, enthalpy_brine(zTin_new),
                                    qocn, qpond)
        ferr = jnp.abs((efinal - einit) / dt -
                       (fcondtop - fcondbot + fswint - fadv))
        # dtype-aware energy tolerance (see bl99.py: in f32 the
        # cancellation noise of (efinal-einit)/dt can exceed the
        # absolute FERRMAX; exact no-op in f64)
        eps = jnp.finfo(efinal.dtype).eps
        ferr_tol = jnp.maximum(
            0.9 * c.FERRMAX,
            4.0 * eps * jnp.maximum(jnp.abs(efinal),
                                    jnp.abs(einit)) / dt)
        conv = (dT < DT_ERRMAX) & (ferr < ferr_tol) & ~went_melt

        fsurfn_out = fsurfn + (Tsf_new - Tsf) * dfsurf_dT

        def sel(new, old):
            cexp = converged.reshape(converged.shape + (1,) *
                                     (new.ndim - converged.ndim))
            return jnp.where(cexp, old, new)

        return (sel(Tsf_new, Tsf), sel(zTsn_new, zTsn),
                sel(zTin_new, zTin), sel(phi_new, phi),
                sel(Tsf, Tsf_pp), sel(zTsn, zTsn_pp),
                sel(zTin, zTin_pp),
                sel(fsurfn_out, fsurf_p), sel(fcondtop, fct_p),
                sel(fcondbot, fcb_p),
                sel(flwoutn, flw_p), sel(fsensn, fsn_p),
                sel(flatn, flt_p),
                converged | conv, niter + 1)

    def cond_fn(carry):
        return (~jnp.all(carry[-2])) & (carry[-1] <= NITERMAX)

    init = (Tsf, zTsn, zTin, phi, Tsf, zTsn, zTin,
            zeros, zeros, zeros, zeros, zeros, zeros,
            jnp.zeros(Tsf.shape, bool), jnp.array(1))
    out = jax.lax.while_loop(cond_fn, one_iteration, init)
    (Tsf_f, zTsn_f, zTin_f, phi_f, _, _, _, fsurf_f, fct_f, fcb_f,
     flwout_f, fsens_f, flat_f, conv_f, _) = out

    zqin_f = enthalpy_mush_liquid_fraction(zTin_f, phi_f)
    zqsn_f = snow_enthalpy_from_temperature(zTsn_f)
    # explicit salinity evolution after the heat solve (reference
    # picard_solver :1361 -> solve_salinity); the enthalpy keeps the
    # pre-drainage salinity, exactly as the reference's zqin does
    fadv_f = drainage_heat_fluxes(q, w, enthalpy_brine(zTin_f),
                                  qocn, qpond)
    if sss is not None:
        zSin_f = solve_salinity(dt, zSin,
                                liquidus_brine_salinity(zTin_f),
                                Spond, sss, q, dSdt, w, hil)
    else:
        zSin_f = zSin
    return MushySolveResult(
        Tsf=Tsf_f, zTsn=zTsn_f, zTin=zTin_f, zqsn=zqsn_f, zqin=zqin_f,
        phi=phi_f, fsensn=fsens_f, flatn=flat_f, flwoutn=flwout_f,
        fsurfn=fsurf_f, fcondtopn=fct_f, fcondbot=fcb_f,
        converged=conv_f, zSin=zSin_f, fadvheat=fadv_f, w=w)


# -- snow-ice formation (flooding) ------------------------------------------

class FloodResult(NamedTuple):
    zqsn: jnp.ndarray      # regridded snow enthalpy [*B, ns]
    zqin: jnp.ndarray      # regridded ice enthalpy [*B, ni]
    zSin: jnp.ndarray      # regridded bulk salinity [*B, ni]
    phi: jnp.ndarray       # regridded liquid fraction [*B, ni]
    hilyr: jnp.ndarray     # new ice layer thickness [*B]
    hslyr: jnp.ndarray     # new snow layer thickness [*B]
    snoice: jnp.ndarray    # snow-ice formed (m) [*B]
    eadded: jnp.ndarray    # ocean energy used (W/m^2) [*B]
    wadded: jnp.ndarray    # ocean water mass used (kg/m^2/s) [*B]
    sadded: jnp.ndarray    # ocean salt used (kg/m^2/s) [*B]


def _overlap_regrid(trc, hlyr1, hlyr2, shift):
    """Conservative overlap regrid of equal-thickness layers: new cell
    k2 = [k2 h2, (k2+1) h2), old cell k1 = [k1 h1 + shift, ...). The
    reference's double loop (update_vertical_tracers_* :3562-3703)
    becomes one dense [new, old] overlap matrix contraction."""
    nl = trc.shape[-1]
    k = jnp.arange(nl, dtype=trc.dtype)
    z2a = k * hlyr2[..., None]
    z2b = (k + 1.0) * hlyr2[..., None]
    z1a = k * hlyr1[..., None] + shift[..., None]
    z1b = (k + 1.0) * hlyr1[..., None] + shift[..., None]
    ov = jnp.maximum(
        jnp.minimum(z1b[..., None, :], z2b[..., :, None]) -
        jnp.maximum(z1a[..., None, :], z2a[..., :, None]), 0.0)
    return (ov * trc[..., None, :]).sum(-1)


def update_vertical_tracers_snow(trc, hlyr1, hlyr2):
    """Regrid snow layers after snow-ice loss (reference :3562-3624)."""
    return _overlap_regrid(trc, hlyr1, hlyr2,
                           jnp.zeros_like(hlyr1)) / \
        jnp.maximum(hlyr2, c.PUNY)[..., None]


def update_vertical_tracers_ice(trc, hlyr1, hlyr2, h1, h2, trc0):
    """Regrid ice layers with a new snow-ice band [0, h2-h1) of value
    trc0 on top (reference :3628-3703)."""
    nl = trc.shape[-1]
    out = _overlap_regrid(trc, hlyr1, hlyr2, (h2 - h1))
    k = jnp.arange(nl, dtype=trc.dtype)
    z2a = k * hlyr2[..., None]
    z2b = (k + 1.0) * hlyr2[..., None]
    ov0 = jnp.maximum(
        jnp.minimum((h2 - h1)[..., None], z2b) - jnp.maximum(0.0, z2a),
        0.0)
    out = out + ov0 * trc0[..., None]
    return out / jnp.maximum(hlyr2, c.PUNY)[..., None]


def enthalpy_snow_snowice(dh, hsn, zqsn):
    """Mean enthalpy of the snow converted to snow ice — the bottom
    dh of the snow pack (reference enthalpy_snow_snowice :3516-3558:
    full bottom layers plus the partially-converted one)."""
    ns = zqsn.shape[-1]
    safe_h = jnp.maximum(hsn, c.PUNY)
    rnlyr = (dh / safe_h) * ns
    nlyr = jnp.minimum(jnp.floor(rnlyr), float(ns - 1))
    k = jnp.arange(ns, dtype=zqsn.dtype)
    full = k >= (ns - nlyr[..., None])          # bottom nlyr layers
    safe_rn = jnp.maximum(rnlyr, c.PUNY)
    q = jnp.where(full, zqsn, 0.0).sum(-1) / safe_rn
    part = (k == (ns - 1.0 - nlyr[..., None]))
    q = q + ((rnlyr - nlyr) / safe_rn) * \
        jnp.where(part, zqsn, 0.0).sum(-1)
    return jnp.where((hsn > c.PUNY) & (dh > 0.0), q, 0.0)


def flood_ice(dt, hsn, hin, hslyr, hilyr, zqsn, zqin, zSin, phi,
              Sbr, sss, qocn) -> FloodResult:
    """Snow-ice formation when the snow load pushes the surface below
    sea level (reference flood_ice, ice_therm_mushy.F90:3342-3512):
    the flooded snow becomes mush with liquid fraction 1 - rhos/rhoi
    filled with ocean brine, layers regrid conservatively, and the
    ocean water/energy/salt used are returned for the coupler budget
    (fadvheat -= eadded in the reference)."""
    puny = c.PUNY
    rho_ocn = density_brine(sss)
    ice_density = jnp.minimum(
        phi * density_brine(Sbr) + (1.0 - phi) * c.RHOI,
        rho_ocn[..., None])
    ice_mass = ice_density.sum(-1) * hilyr
    snow_mass = c.RHOS * hsn
    freeboard_density = jnp.maximum(
        ice_mass + snow_mass - hin * rho_ocn, 0.0)
    flooded = (hsn > puny) & (freeboard_density > 0.0)

    phi_si = 1.0 - c.RHOS / c.RHOI
    rho_si = phi_si * rho_ocn + (1.0 - phi_si) * c.RHOI
    dh = freeboard_density / jnp.maximum(rho_ocn - rho_si + c.RHOS,
                                         puny)
    dh = jnp.where(flooded, jnp.clip(dh, 0.0, hsn), 0.0)

    qsn_si = enthalpy_snow_snowice(dh, hsn, zqsn)
    ni = zqin.shape[-1]
    ns = zqsn.shape[-1]
    hin2 = hin + dh
    hsn2 = hsn - dh
    hilyr2 = hin2 / ni
    hslyr2 = hsn2 / ns

    zSin_si = phi_si * sss
    zqin_si = phi_si * qocn + qsn_si

    zqsn2 = update_vertical_tracers_snow(zqsn, hslyr, hslyr2)
    zqin2 = update_vertical_tracers_ice(zqin, hilyr, hilyr2, hin,
                                        hin2, zqin_si)
    zSin2 = update_vertical_tracers_ice(zSin, hilyr, hilyr2, hin,
                                        hin2, zSin_si * jnp.ones_like(
                                            sss))
    phi2 = update_vertical_tracers_ice(phi, hilyr, hilyr2, hin, hin2,
                                       phi_si * jnp.ones_like(sss))

    fl = flooded[..., None]
    hadded = dh * phi_si / dt
    wadded = hadded * c.RHOI
    return FloodResult(
        zqsn=jnp.where(fl, zqsn2, zqsn),
        zqin=jnp.where(fl, zqin2, zqin),
        zSin=jnp.where(fl, zSin2, zSin),
        phi=jnp.where(fl, phi2, phi),
        hilyr=jnp.where(flooded, hilyr2, hilyr),
        hslyr=jnp.where(flooded, hslyr2, hslyr),
        snoice=dh,
        eadded=jnp.where(flooded, hadded * qocn, 0.0),
        wadded=jnp.where(flooded, wadded, 0.0),
        sadded=jnp.where(flooded,
                         wadded * c.ICE_REF_SALINITY * 1.0e-3, 0.0))
