"""Mechanical redistribution (ridging).

JAX re-design of `ice_mechred.F90` (`ridge_ice` :80-597,
`ridge_prep` :640, `ridge_itd` :741, `ridge_shift` :1030): the
per-cell ridging iteration becomes a fixed-count masked loop over all
cells, with the category loops unrolled (static ncat).

Scheme constants (reference ice_mechred.F90:52-61): Cs=0.25,
fsnowrdg=0.5, Gstar=0.15, astar=0.05, maxraft=1, Hstar=25.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import jax.numpy as jnp

from . import constants as c

CS = 0.25          # shear energy fraction contributing to ridging
FSNOWRDG = 0.5     # snow fraction surviving ridging
GSTAR = 0.15
ASTAR = 0.05
MAXRAFT = 1.0
HSTAR = 25.0
NITER_RIDGE = 3    # fixed iteration count (reference iterates <=20,
                   # converging in 1-2 typical)

# Tracers destroyed by ridging: the donor loses them but the new ridge
# receives none (reference ridge_shift, ice_mechred.F90:1488-1498 --
# "Tracers associated with level ice ... are not transferred. We assume
# that all pond water is lost from ridging ice.")
NO_TRANSFER_TRACERS = frozenset({
    "levelIceArea", "levelIceVolume",
    "pondArea", "pondDepth", "pondLidThickness"})


def asum_and_participation(aicen, aice0):
    return aice0 + aicen.sum(-1)


def ridge_shift_coeffs(aicen, vicen, aice0, hin_max,
                       krdg_partic: int = 1, krdg_redist: int = 1,
                       mu_rdg: float = 4.0):
    """Participation and redistribution coefficients (reference
    ridge_itd, ice_mechred.F90:741-1012).

    Returns (apartic [*B, ncat+1] with slot 0 = open water,
    hrmin, hrexp [*B, ncat], krdg [*B, ncat], aksum [*B])."""
    ncat = aicen.shape[-1]
    puny = c.PUNY
    # cumulative area distribution G (open water first)
    gs = [jnp.zeros_like(aice0),
          jnp.where(aice0 > puny, aice0, 0.0)]
    for n in range(ncat):
        gs.append(gs[-1] + jnp.where(aicen[..., n] > puny,
                                     aicen[..., n], 0.0))
    total = jnp.maximum(gs[-1], puny)
    gs = [g / total for g in gs]

    apartic = []
    if krdg_partic == 0:      # Thorndike et al. 1975
        gstari = 1.0 / GSTAR
        for n in range(ncat + 1):
            g0, g1 = gs[n], gs[n + 1]
            a_full = gstari * (g1 - g0) * (2.0 - gstari * (g0 + g1))
            a_part = gstari * (GSTAR - g0) * (2.0 - gstari *
                                              (GSTAR + g0))
            a = jnp.where(g1 < GSTAR, a_full,
                          jnp.where(g0 < GSTAR, a_part, 0.0))
            apartic.append(jnp.maximum(a, 0.0))
    else:                     # exponential (Lipscomb et al. 2007)
        astari = 1.0 / ASTAR
        norm = 1.0 / (1.0 - np.exp(-astari))
        e = [jnp.exp(-g * astari) * norm for g in gs]
        for n in range(ncat + 1):
            apartic.append(jnp.maximum(e[n] - e[n + 1], 0.0))
    apartic = jnp.stack(apartic, axis=-1)     # [*B, ncat+1]

    has = aicen > puny
    hi = jnp.where(has, vicen / jnp.where(has, aicen, 1.0), puny)
    hi = jnp.maximum(hi, puny)
    hrmin = jnp.where(has, jnp.minimum(2.0 * hi, hi + MAXRAFT), 0.0)
    if krdg_redist == 0:
        hrmax = jnp.where(has, jnp.maximum(2.0 * jnp.sqrt(HSTAR * hi),
                                           hrmin + puny), 0.0)
        hrexp = hrmax          # reuse slot: hrmax for Hibler 1980
        krdg = jnp.where(has, 0.5 * (hrmin + hrmax) / hi, 1.0)
    else:
        hrexp = jnp.where(has, mu_rdg * jnp.sqrt(hi), 0.0)
        krdg = jnp.where(has, (hrmin + hrexp) / hi, 1.0)

    aksum = apartic[..., 0] + (
        apartic[..., 1:] * (1.0 - 1.0 / krdg)).sum(-1)
    return apartic, hrmin, hrexp, krdg, aksum


class RidgeResult(NamedTuple):
    aicen: jnp.ndarray
    vicen: jnp.ndarray
    vsnon: jnp.ndarray
    aice0: jnp.ndarray
    area_tracers: Dict[str, jnp.ndarray]
    ice_tracers: Dict[str, jnp.ndarray]
    snow_tracers: Dict[str, jnp.ndarray]
    dardg1dt: jnp.ndarray     # area ridged / s
    dardg2dt: jnp.ndarray     # new ridge area / s
    dvirdgdt: jnp.ndarray     # volume ridged / s
    opening: jnp.ndarray      # opening rate / s
    msnow_mlt: jnp.ndarray    # snow mass to ocean (kg/m^2)
    esnow_mlt: jnp.ndarray    # snow energy to ocean (J/m^2)


def ridge_ice(dt, hin_max: np.ndarray, rdg_conv, rdg_shear,
              aicen, vicen, vsnon,
              area_tracers: Dict[str, jnp.ndarray],
              ice_tracers: Dict[str, jnp.ndarray],
              snow_tracers: Dict[str, jnp.ndarray],
              krdg_partic: int = 1, krdg_redist: int = 1,
              mu_rdg: float = 4.0) -> RidgeResult:
    """Ridging driver (reference ridge_ice, ice_mechred.F90:80-597)."""
    ncat = aicen.shape[-1]
    puny = c.PUNY
    hmax = np.array(hin_max, float).copy()
    hmax[ncat] = 1.0e8      # reference ridge_prep: top bound -> big

    aice0 = jnp.maximum(1.0 - aicen.sum(-1), 0.0)

    # conserved tracer quantities
    def conserved(trc, base):
        return {k: v * (base if v.ndim == base.ndim else base[..., None])
                for k, v in trc.items()}

    at = conserved(area_tracers, aicen)
    it_ = conserved(ice_tracers, vicen)
    st = conserved(snow_tracers, vsnon)

    # net closing rate (ridge_prep :640-722)
    asum = aice0 + aicen.sum(-1)
    closing_net = CS * rdg_shear + rdg_conv
    divu_adv = (1.0 - asum) / dt
    closing_net = jnp.where(divu_adv < 0.0,
                            jnp.maximum(closing_net, -divu_adv),
                            closing_net)
    opning = closing_net + divu_adv

    ardg1 = jnp.zeros_like(aice0)
    ardg2 = jnp.zeros_like(aice0)
    virdg = jnp.zeros_like(aice0)
    aopen = jnp.zeros_like(aice0)
    msnow_mlt = jnp.zeros_like(aice0)
    esnow_mlt = jnp.zeros_like(aice0)

    for _ in range(NITER_RIDGE):
        apartic, hrmin, hrexp, krdg, aksum = ridge_shift_coeffs(
            aicen, vicen, aice0, hmax, krdg_partic, krdg_redist, mu_rdg)

        closing_gross = closing_net / jnp.maximum(aksum, puny)
        # don't remove more than exists (ridge_shift :1160-1190)
        wk = apartic[..., 0] * closing_gross * dt
        tmpfac = jnp.where(wk > aice0,
                           aice0 / jnp.maximum(wk, puny), 1.0)
        closing_gross = closing_gross * tmpfac
        opning_l = opning * tmpfac
        for n in range(ncat):
            wk = apartic[..., n + 1] * closing_gross * dt
            a_n = aicen[..., n]
            need = (a_n > puny) & (apartic[..., n + 1] > 0.0) & (wk > a_n)
            tmpfac = jnp.where(need, a_n / jnp.maximum(wk, puny), 1.0)
            closing_gross = closing_gross * tmpfac
            opning_l = opning_l * tmpfac

        aice0 = jnp.maximum(
            aice0 - apartic[..., 0] * closing_gross * dt +
            opning_l * dt, 0.0)
        aopen = aopen + opning_l * dt

        # per-donor-category shift
        aicen_init = aicen
        vicen_init = vicen
        vsnon_init = vsnon
        at_init = dict(at)
        it_init = dict(it_)
        st_init = dict(st)
        for n in range(ncat):
            act = ((aicen_init[..., n] > puny) &
                   (apartic[..., n + 1] > 0.0) & (closing_gross > 0.0))
            ardg1n = jnp.where(
                act, jnp.minimum(aicen_init[..., n],
                                 apartic[..., n + 1] * closing_gross *
                                 dt), 0.0)
            ardg2n = ardg1n / jnp.maximum(krdg[..., n], puny)
            afrac = ardg1n / jnp.maximum(aicen_init[..., n], puny)
            virdgn = vicen_init[..., n] * afrac
            vsrdgn = vsnon_init[..., n] * afrac
            aicen = aicen.at[..., n].add(-ardg1n)
            vicen = vicen.at[..., n].add(-virdgn)
            vsnon = vsnon.at[..., n].add(-vsrdgn)
            ardg1 = ardg1 + ardg1n
            ardg2 = ardg2 + ardg2n
            virdg = virdg + virdgn
            msnow_mlt = msnow_mlt + c.RHOS * vsrdgn * (1.0 - FSNOWRDG)
            if "snowEnthalpy" in snow_tracers:
                qs = snow_tracers["snowEnthalpy"]
                esnow_mlt = esnow_mlt + (
                    vsrdgn * qs[..., n, :].mean(-1) * (1.0 - FSNOWRDG))

            # remove tracer quantities from the donor category
            for k2 in at:
                t = area_tracers[k2]
                val = t[..., n] if t.ndim == ardg1n.ndim + 1 else \
                    t[..., n, :]
                amt = ardg1n if t.ndim == ardg1n.ndim + 1 else \
                    ardg1n[..., None]
                if t.ndim == ardg1n.ndim + 1:
                    at[k2] = at[k2].at[..., n].add(-amt * val)
                else:
                    at[k2] = at[k2].at[..., n, :].add(-amt * val)
            for k2 in it_:
                t = ice_tracers[k2]
                val = t[..., n, :] if t.ndim == ardg1n.ndim + 2 else \
                    t[..., n]
                amt = virdgn[..., None] if t.ndim == ardg1n.ndim + 2 \
                    else virdgn
                if t.ndim == ardg1n.ndim + 2:
                    it_[k2] = it_[k2].at[..., n, :].add(-amt * val)
                else:
                    it_[k2] = it_[k2].at[..., n].add(-amt * val)
            for k2 in st:
                t = snow_tracers[k2]
                val = t[..., n, :] if t.ndim == ardg1n.ndim + 2 else \
                    t[..., n]
                amt = vsrdgn[..., None] if t.ndim == ardg1n.ndim + 2 \
                    else vsrdgn
                if t.ndim == ardg1n.ndim + 2:
                    st[k2] = st[k2].at[..., n, :].add(-amt * val)
                else:
                    st[k2] = st[k2].at[..., n].add(-amt * val)

            # distribute the new ridge over receiver categories
            for nr in range(ncat):
                if krdg_redist == 0:
                    dhr = jnp.maximum(hrexp[..., n] - hrmin[..., n],
                                      puny)
                    dhr2 = jnp.maximum(hrexp[..., n] ** 2 -
                                       hrmin[..., n] ** 2, puny)
                    hL = jnp.maximum(hrmin[..., n], hmax[nr])
                    hR = jnp.minimum(hrexp[..., n], hmax[nr + 1])
                    ok = (hrmin[..., n] < hmax[nr + 1]) & \
                        (hrexp[..., n] > hmax[nr])
                    farea = jnp.where(ok, (hR - hL) / dhr, 0.0)
                    fvol = jnp.where(ok, (hR ** 2 - hL ** 2) / dhr2,
                                     0.0)
                else:
                    hi1 = hrmin[..., n]
                    hexp = jnp.maximum(hrexp[..., n], puny)
                    if nr < ncat - 1:
                        ok = hi1 < hmax[nr + 1]
                        hL = jnp.maximum(hi1, hmax[nr])
                        hR = hmax[nr + 1]
                        expL = jnp.exp(-(hL - hi1) / hexp)
                        expR = jnp.exp(-(hR - hi1) / hexp)
                        farea = jnp.where(ok, expL - expR, 0.0)
                        fvol = jnp.where(
                            ok, ((hL + hexp) * expL -
                                 (hR + hexp) * expR) /
                            jnp.maximum(hi1 + hexp, puny), 0.0)
                    else:
                        hL = jnp.maximum(hi1, hmax[nr])
                        expL = jnp.exp(-(hL - hi1) / hexp)
                        farea = expL
                        fvol = (hL + hexp) * expL / jnp.maximum(
                            hi1 + hexp, puny)
                farea = jnp.where(act, farea, 0.0)
                fvol = jnp.where(act, fvol, 0.0)
                aicen = aicen.at[..., nr].add(farea * ardg2n)
                vicen = vicen.at[..., nr].add(fvol * virdgn)
                vsnon = vsnon.at[..., nr].add(fvol * vsrdgn * FSNOWRDG)
                for k2 in at:
                    if k2 in NO_TRANSFER_TRACERS:
                        continue
                    t = area_tracers[k2]
                    if t.ndim == ardg1n.ndim + 1:
                        at[k2] = at[k2].at[..., nr].add(
                            farea * ardg2n * t[..., n])
                    else:
                        at[k2] = at[k2].at[..., nr, :].add(
                            (farea * ardg2n)[..., None] * t[..., n, :])
                for k2 in it_:
                    if k2 in NO_TRANSFER_TRACERS:
                        continue
                    t = ice_tracers[k2]
                    if t.ndim == ardg1n.ndim + 2:
                        it_[k2] = it_[k2].at[..., nr, :].add(
                            (fvol * virdgn)[..., None] * t[..., n, :])
                    else:
                        it_[k2] = it_[k2].at[..., nr].add(
                            fvol * virdgn * t[..., n])
                for k2 in st:
                    t = snow_tracers[k2]
                    if t.ndim == ardg1n.ndim + 2:
                        st[k2] = st[k2].at[..., nr, :].add(
                            (fvol * vsrdgn * FSNOWRDG)[..., None] *
                            t[..., n, :])
                    else:
                        st[k2] = st[k2].at[..., nr].add(
                            fvol * vsrdgn * FSNOWRDG * t[..., n])

        # recover tracer means for the next iteration.  Divide wherever
        # the base is POSITIVE (not just > puny): a receiver category
        # can hold a sub-puny sliver of snow whose enthalpy must stay
        # physical — zeroing it leaves vsnon > 0 with qs = 0 ("snow"
        # above the melting point) and the thermo solver cannot close
        # that column's energy budget (matches itd.py recover).
        def recover(store, base, trc):
            out = {}
            for k2, v in store.items():
                b = base if v.ndim == base.ndim else base[..., None]
                out[k2] = jnp.where(b > 0.0, v /
                                    jnp.where(b == 0, 1.0, b), 0.0)
            return out

        area_tracers = recover(at, aicen, area_tracers)
        ice_tracers = recover(it_, vicen, ice_tracers)
        snow_tracers = recover(st, vsnon, snow_tracers)

        # iterate if the total area still deviates from 1
        asum = aice0 + aicen.sum(-1)
        closing_net = jnp.where(jnp.abs(asum - 1.0) > puny,
                                (1.0 - asum) / dt, 0.0)
        opning = jnp.zeros_like(opning)

    return RidgeResult(
        aicen=aicen, vicen=vicen, vsnon=vsnon, aice0=aice0,
        area_tracers=area_tracers, ice_tracers=ice_tracers,
        snow_tracers=snow_tracers,
        dardg1dt=ardg1 / dt, dardg2dt=ardg2 / dt, dvirdgdt=virdg / dt,
        opening=aopen / dt,
        msnow_mlt=msnow_mlt, esnow_mlt=esnow_mlt)
