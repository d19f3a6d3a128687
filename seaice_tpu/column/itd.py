"""Ice thickness distribution: category bounds, aggregation, linear
remapping between categories, small-ice cleanup, and ice strength.

JAX re-design of `ice_itd.F90` (aggregation/shift/cleanup) and
`linear_itd`/`fit_line` (`/root/reference/src/column/ice_therm_itd.F90:
69-760`, Lipscomb 2001 linear remapping): the per-cell category-shift
logic becomes masked dense updates unrolled over the static category
count, vectorized over all cells.

State convention here: aicen, vicen, vsnon [*B, nCat]; layered tracers
[*B, nCat, nLayers]; surface temperature [*B, nCat].
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import jax.numpy as jnp

from . import constants as c

P333 = 1.0 / 3.0
P666 = 2.0 / 3.0
HI_MIN = 0.01


def category_boundaries(ncat: int, kcatbound: int = 0,
                        kitd: int = 1) -> np.ndarray:
    """hin_max[0..ncat] (reference colpkg_init_itd,
    ice_colpkg.F90:85-240)."""
    h = np.zeros(ncat + 1)
    if kcatbound == -1:
        h[1:] = 100.0
        return h
    if kcatbound == 0:
        if kitd == 1:
            cc1 = 3.0 / ncat
            cc2 = 15.0 * cc1
            cc3 = 3.0
            h[0] = 0.0
        else:
            cc1 = max(1.1 / ncat, HI_MIN)
            cc2 = 25.0 * cc1
            cc3 = 2.25
            h[0] = HI_MIN
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            h[n] = h[n - 1] + cc1 + cc2 * (1.0 + np.tanh(cc3 * (x1 - 1.0)))
        return h
    if kcatbound == 1:
        d1 = 3.0 / ncat
        d2 = 0.5 / ncat
        for n in range(1, ncat + 1):
            h[n] = n * (d1 + (n - 1) * d2)
        return h
    if kcatbound == 2 and ncat == 5:       # WMO standard
        h[1:] = [0.30, 0.70, 1.20, 2.00, 999.0]
        return h
    raise NotImplementedError(f"kcatbound={kcatbound}, ncat={ncat}")


def aggregate_area(aicen):
    """aice, aice0 (reference aggregate_area, ice_itd.F90:53-81)."""
    aice = aicen.sum(axis=-1)
    return aice, jnp.maximum(1.0 - aice, 0.0)


def aggregate_state(aicen, vicen, vsnon):
    aice = aicen.sum(axis=-1)
    return aice, vicen.sum(axis=-1), vsnon.sum(axis=-1)


def _fit_line(aicen, hice, hbL, hbR):
    """Linear g(h) fit over a category (reference fit_line,
    ice_therm_itd.F90:697-760). Returns (g0, g1, hL, hR)."""
    ok = (aicen > c.PUNY) & (hbR - hbL > c.PUNY)
    hL = hbL
    hR = hbR
    h13 = P333 * (2.0 * hL + hR)
    h23 = P333 * (hL + 2.0 * hR)
    hR = jnp.where(hice < h13, 3.0 * hice - 2.0 * hL, hR)
    hL = jnp.where(hice > h23, 3.0 * hice - 2.0 * hR, hL)
    dhr = 1.0 / jnp.maximum(hR - hL, c.PUNY)
    wk1 = 6.0 * aicen * dhr
    wk2 = (hice - hL) * dhr
    g0 = jnp.where(ok, wk1 * (P666 - wk2), 0.0)
    g1 = jnp.where(ok, 2.0 * dhr * wk1 * (wk2 - 0.5), 0.0)
    hL = jnp.where(ok, hL, 0.0)
    hR = jnp.where(ok, hR, 0.0)
    return g0, g1, hL, hR


def linear_itd_remap(hin_max: np.ndarray,
                     aicen_init, vicen_init,
                     aicen, vicen, vsnon,
                     area_tracers: Dict[str, jnp.ndarray],
                     ice_tracers: Dict[str, jnp.ndarray],
                     snow_tracers: Dict[str, jnp.ndarray]):
    """Remap the ITD after vertical thermo growth/melt
    (reference linear_itd, ice_therm_itd.F90:69-685).

    aicen_init/vicen_init: state before vertical thermo.
    area/ice/snow_tracers: dicts of per-category tracers keyed by name,
    conserved as a*T, v*T, vs*T respectively. Layered tracers have a
    trailing layer axis. Returns updated (aicen, vicen, vsnon, tracers...).
    """
    ncat = aicen.shape[-1]
    puny = c.PUNY

    def cat(x, n):
        return x[..., n]

    has_i = aicen_init > puny
    hicen_init = jnp.where(has_i, vicen_init /
                           jnp.where(has_i, aicen_init, 1.0), 0.0)
    has = aicen > puny
    hicen = jnp.where(has, vicen / jnp.where(has, aicen, 1.0), 0.0)
    dhicen = jnp.where(has, hicen - hicen_init, 0.0)

    # new boundary positions hbnew[n], n = 1..ncat-1 (:229-262)
    hbnew = [jnp.full(aicen.shape[:-1], hin_max[0], aicen.dtype)]
    remap_flag = jnp.ones(aicen.shape[:-1], bool)
    for n in range(ncat - 1):
        hi_n = cat(hicen_init, n)
        hi_n1 = cat(hicen_init, n + 1)
        both = (hi_n > puny) & (hi_n1 > puny)
        only_n = (hi_n > puny) & ~both
        only_n1 = (hi_n1 > puny) & ~both
        slope = (cat(dhicen, n + 1) - cat(dhicen, n)) / \
            jnp.where(both, hi_n1 - hi_n, 1.0)
        hb = jnp.where(
            both,
            hin_max[n + 1] + cat(dhicen, n) + slope * (hin_max[n + 1] -
                                                       hi_n),
            jnp.where(only_n, hin_max[n + 1] + cat(dhicen, n),
                      jnp.where(only_n1,
                                hin_max[n + 1] + cat(dhicen, n + 1),
                                hin_max[n + 1])))
        # consistency checks: violations disable remapping this step
        remap_flag = remap_flag & ~(
            (cat(aicen, n) > puny) & (cat(hicen, n) >= hb))
        remap_flag = remap_flag & ~(
            (cat(aicen, n + 1) > puny) & (cat(hicen, n + 1) <= hb))
        remap_flag = remap_flag & (hb <= hin_max[n + 2])
        remap_flag = remap_flag & (hb >= hin_max[n])
        hbnew.append(hb)
    hb_top = jnp.where(cat(aicen, ncat - 1) > puny,
                       3.0 * cat(hicen, ncat - 1) - 2.0 * hbnew[ncat - 1],
                       hin_max[ncat])
    hbnew.append(jnp.maximum(hb_top, hin_max[ncat - 1]))

    # thin-end adjustment of category 1 (:400-425)
    g0, g1, hL, hR = _fit_line(cat(aicen, 0), cat(hicen_init, 0),
                               hbnew[0], jnp.full_like(hbnew[0],
                                                       hin_max[1]))
    a1 = cat(aicen, 0)
    h1 = cat(hicen, 0)
    dh0 = cat(dhicen, 0)
    shrink = (a1 > puny) & (dh0 < 0.0) & remap_flag
    dh0m = jnp.minimum(-dh0, hin_max[1])
    etamax = jnp.minimum(dh0m, hR) - hL
    pos = shrink & (etamax > 0.0)
    x1 = etamax
    x2 = 0.5 * etamax * etamax
    da0 = g1 * x2 + g0 * x1
    damax = a1 * (1.0 - h1 / jnp.where(cat(hicen_init, 0) > 0,
                                       cat(hicen_init, 0), 1.0))
    da0 = jnp.where(pos, jnp.minimum(da0, jnp.maximum(damax, 0.0)), 0.0)
    h1_new = jnp.where(pos, h1 * a1 / jnp.maximum(a1 - da0, puny), h1)
    a1_new = jnp.where(pos, a1 - da0, a1)
    aicen = aicen.at[..., 0].set(a1_new)
    hicen = hicen.at[..., 0].set(h1_new)
    grow0 = (a1 > puny) & (dh0 >= 0.0)
    hbnew[0] = jnp.where(grow0 & remap_flag,
                         jnp.minimum(dh0, hin_max[1]), hbnew[0])

    # fit g(h) in every category with the new boundaries (:427-434)
    G0, G1, HL, HR = [], [], [], []
    for n in range(ncat):
        g0, g1, hL, hR = _fit_line(cat(aicen, n), cat(hicen, n),
                                   hbnew[n], hbnew[n + 1])
        G0.append(g0)
        G1.append(g1)
        HL.append(hL)
        HR.append(hR)

    # transfers across each boundary (:436-476)
    donor_is_n = []
    daice = []
    dvice = []
    for n in range(ncat - 1):
        from_n = hbnew[n + 1] > hin_max[n + 1]
        etamin = jnp.where(from_n,
                           jnp.maximum(hin_max[n + 1], HL[n]) - HL[n],
                           0.0)
        etamax = jnp.where(from_n,
                           jnp.minimum(hbnew[n + 1], HR[n]) - HL[n],
                           jnp.minimum(hin_max[n + 1], HR[n + 1]) -
                           HL[n + 1])
        g0d = jnp.where(from_n, G0[n], G0[n + 1])
        g1d = jnp.where(from_n, G1[n], G1[n + 1])
        hLd = jnp.where(from_n, HL[n], HL[n + 1])
        ok = (etamax > etamin) & remap_flag
        x1 = etamax - etamin
        x2 = 0.5 * (etamax ** 2 - etamin ** 2)
        x3 = P333 * (etamax ** 3 - etamin ** 3)
        da = jnp.where(ok, g1d * x2 + g0d * x1, 0.0)
        dv = jnp.where(ok, g1d * x3 + g0d * x2 + da * hLd, 0.0)
        a_d = jnp.where(from_n, cat(aicen, n), cat(aicen, n + 1))
        v_d = jnp.where(from_n, cat(vicen, n), cat(vicen, n + 1))
        zero = (da < a_d * puny) | (dv < v_d * puny)
        da = jnp.where(zero, 0.0, da)
        dv = jnp.where(zero, 0.0, dv)
        all_of_it = (da > a_d * (1.0 - puny)) | (dv > v_d * (1.0 - puny))
        da = jnp.where(all_of_it & ~zero, a_d, da)
        dv = jnp.where(all_of_it & ~zero, v_d, dv)
        donor_is_n.append(from_n)
        daice.append(da)
        dvice.append(dv)

    # shift ice + tracers between categories (ice_itd.F90 shift_ice
    # :347-665), with the snow-enthalpy offset trick (+rhos*Lfresh) so
    # the transferred quantity is sign-definite
    snow_off = {k: v + c.RHOS * c.LFRESH if k == "snowEnthalpy" else v
                for k, v in snow_tracers.items()}

    def conserved(trc, base):
        out = {}
        for k, v in trc.items():
            b = base if v.ndim == base.ndim else base[..., None]
            out[k] = v * b
        return out

    at = conserved(area_tracers, aicen)
    it_ = conserved(ice_tracers, vicen)
    st = conserved(snow_off, vsnon)

    for n in range(ncat - 1):
        from_n = donor_is_n[n]
        da = daice[n]
        dv = dvice[n]
        a_d = jnp.where(from_n, cat(aicen, n), cat(aicen, n + 1))
        vs_d = jnp.where(from_n, cat(vsnon, n), cat(vsnon, n + 1))
        worka = da / jnp.maximum(a_d, puny)
        workb = dv / jnp.maximum(
            jnp.where(from_n, cat(vicen, n), cat(vicen, n + 1)), puny)
        dvs = vs_d * worka

        def shift(x, n_from, n_to, amount):
            x = x.at[..., n_from].add(-amount)
            x = x.at[..., n_to].add(amount)
            return x

        sgn_da = jnp.where(from_n, da, -da)
        sgn_dv = jnp.where(from_n, dv, -dv)
        sgn_dvs = jnp.where(from_n, dvs, -dvs)
        aicen = shift(aicen, n, n + 1, sgn_da)
        vicen = shift(vicen, n, n + 1, sgn_dv)
        vsnon = shift(vsnon, n, n + 1, sgn_dvs)

        def shift_tracers(trc, frac_from_n, frac_from_n1):
            out = {}
            for k, x in trc.items():
                if x.ndim == from_n.ndim + 2:
                    f_n = frac_from_n[..., None]
                    f_n1 = frac_from_n1[..., None]
                    fn_mask = from_n[..., None]
                else:
                    f_n, f_n1 = frac_from_n, frac_from_n1
                    fn_mask = from_n
                amt = jnp.where(fn_mask, x[..., n, :] * f_n
                                if x.ndim == from_n.ndim + 2
                                else x[..., n] * f_n,
                                -(x[..., n + 1, :] * f_n1
                                  if x.ndim == from_n.ndim + 2
                                  else x[..., n + 1] * f_n1))
                if x.ndim == from_n.ndim + 2:
                    x = x.at[..., n, :].add(-amt)
                    x = x.at[..., n + 1, :].add(amt)
                else:
                    x = x.at[..., n].add(-amt)
                    x = x.at[..., n + 1].add(amt)
                out[k] = x
            return out

        wa_n = jnp.where(from_n, worka, 0.0)
        wa_n1 = jnp.where(from_n, 0.0, worka)
        wv_n = jnp.where(from_n, workb, 0.0)
        wv_n1 = jnp.where(from_n, 0.0, workb)
        at = shift_tracers(at, wa_n, wa_n1)
        it_ = shift_tracers(it_, wv_n, wv_n1)
        st = shift_tracers(st, wa_n, wa_n1)   # snow moves with area frac

    # recover tracer means (colpkg_compute_tracers analog)
    def recover(trc, base):
        out = {}
        for k, v in trc.items():
            b = base if v.ndim == base.ndim else base[..., None]
            out[k] = jnp.where(b > 0.0, v / jnp.where(b == 0, 1.0, b),
                               0.0)
        return out

    area_tracers = recover(at, aicen)
    ice_tracers = recover(it_, vicen)
    snow_tracers = recover(st, vsnon)
    snow_tracers = {
        k: (v - c.RHOS * c.LFRESH if k == "snowEnthalpy" else v)
        for k, v in snow_tracers.items()}
    # snowEnthalpy of empty categories must stay 0, not -rhos*Lfresh
    if "snowEnthalpy" in snow_tracers:
        se = snow_tracers["snowEnthalpy"]
        snow_tracers["snowEnthalpy"] = jnp.where(
            vsnon[..., None] > 0.0, se, 0.0)

    # enforce hi_min on category 1 (:496-508)
    a1 = cat(aicen, 0)
    h1 = jnp.where(a1 > puny, cat(vicen, 0) / jnp.maximum(a1, puny), 0.0)
    thin = (a1 > puny) & (h1 < HI_MIN) & (h1 > 0.0)
    da0 = jnp.where(thin, a1 * (1.0 - h1 / HI_MIN), 0.0)
    aicen = aicen.at[..., 0].add(-da0)

    return aicen, vicen, vsnon, area_tracers, ice_tracers, snow_tracers


def cleanup_small_ice(aicen, vicen, vsnon, area_tracers, ice_tracers,
                      snow_tracers):
    """Zap categories with negligible area/volume, returning the melt
    water/heat implicitly to the ocean (simplified zap_small_areas,
    reference ice_itd.F90:1029-1336). Returns updated state plus the
    zapped (dfresh, dfhocn) per-cell fluxes' raw sums (kg/m^2, J/m^2)."""
    small = (aicen < c.PUNY) | (vicen < c.PUNY * 1e-3)
    dfresh = ((c.RHOI * vicen + c.RHOS * vsnon) * small).sum(axis=-1)
    e_ice = ice_tracers.get("iceEnthalpy")
    dheat = jnp.zeros_like(dfresh)
    if e_ice is not None:
        ni = e_ice.shape[-1]
        dheat = ((e_ice.mean(axis=-1) * vicen) * small).sum(axis=-1)
        del ni
    zap = lambda x: jnp.where(small, 0.0, x)  # noqa: E731
    aicen, vicen, vsnon = zap(aicen), zap(vicen), zap(vsnon)

    def zap_tr(trc):
        return {k: jnp.where(small[..., None] if v.ndim > small.ndim
                             else small, 0.0, v)
                for k, v in trc.items()}

    return (aicen, vicen, vsnon, zap_tr(area_tracers),
            zap_tr(ice_tracers), zap_tr(snow_tracers), dfresh, dheat)


def ice_strength_hibler(aice, vice):
    """P = P* h exp(-C(1-a)) (Hibler 1979; reference ice_mechred.F90
    kstrength=0)."""
    return 2.75e4 * vice * jnp.exp(-20.0 * (1.0 - aice))


def ice_strength_rothrock(aicen, vicen, aice, aice0,
                          hin_max: np.ndarray, Cf: float = 17.0,
                          krdg_partic: int = 1, krdg_redist: int = 1,
                          mu_rdg: float = 4.0):
    """Energetics-based strength (Rothrock 1975; reference
    colpkg_ice_strength, ice_colpkg.F90:3548-3598): potential-energy
    change of the ridging distribution, strength =
    Cf*Cp*sum_n apartic(n)*(-hi^2 + h2rdg/krdg) / aksum."""
    from .ridging import ridge_shift_coeffs
    Cp = 0.5 * c.GRAVIT * (c.RHOW - c.RHOI) * c.RHOI / c.RHOW
    apartic, hrmin, hrexp, krdg, aksum = ridge_shift_coeffs(
        aicen, vicen, aice0, hin_max, krdg_partic, krdg_redist, mu_rdg)
    ncat = aicen.shape[-1]
    strength = jnp.zeros_like(aice)
    for n in range(ncat):
        has = aicen[..., n] > c.PUNY
        hi = jnp.where(has, vicen[..., n] /
                       jnp.maximum(aicen[..., n], c.PUNY), 0.0)
        if krdg_redist == 0:    # Hibler 1980: hrexp slot holds hrmax
            hrmax = hrexp[..., n]
            h2rdg = (hrmax ** 3 - hrmin[..., n] ** 3) / \
                (3.0 * jnp.maximum(hrmax - hrmin[..., n], c.PUNY))
        else:                   # exponential (Lipscomb et al. 2007)
            h2rdg = hrmin[..., n] ** 2 + 2.0 * hrmin[..., n] * \
                hrexp[..., n] + 2.0 * hrexp[..., n] ** 2
        strength = strength + jnp.where(
            has & (apartic[..., n + 1] > 0.0),
            apartic[..., n + 1] * (-hi ** 2 + h2rdg / jnp.maximum(
                krdg[..., n], c.PUNY)), 0.0)
    return Cp * Cf * jnp.maximum(strength, 0.0) / \
        jnp.maximum(aksum, c.PUNY)
