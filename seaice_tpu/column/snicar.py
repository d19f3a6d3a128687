"""SNICAR 5-band delta-Eddington shortwave (use_snicar).

JAX re-design of `compute_dEdd_5bd`
(`/root/reference/src/column/ice_shortwave.F90:3955-5407`, activated by
config_use_snicar_ad): the snow-covered fraction of each category is
solved in FIVE spectral bands (visible + 4 near-IR) with snow
single-scattering properties (SSPs) from the SNICAR tables — distinct
for direct and diffuse incidents — while bare and ponded ice reuse the
3-band machinery of `dedd.py`.

Band weights are the reference's exact constants (:4527-4539); the
5-band sea-ice SSL/DL/interior IOPs are the embedded parameters of the
reference (:4458-4482).  Snow SSPs come from the SNICAR optics file
(`snicar_optics_5bnd_snow_and_aerosols.nc`, the reference's pkgSnicar
input stream, Registry.xml:2111-2146) when available via
`load_snicar_ssp`; otherwise a compact embedded geometric-optics
fallback table (Qext=2 mass extinction, band-resolved co-albedo growing
as sqrt(r)) keeps the scheme functional with albedos in the published
SNICAR ranges.  The reference obtains these tables from external input
files too — they are data, not code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from . import constants as c
from .dedd import (ALBOCN_DF, ALBOCN_DR, HS_SSL, HI_SSL, HS_MIN_SW,
                   HPMIN, _mix_aerosol, _tune_iops, FP_ICE, FM_ICE,
                   solve_dedd_column, shortwave_dedd)

# 5-band -> 3-band aerosol-table mapping (vis; NIR split) used until
# exact 5-band aerosol optics (kaer_tab_5bd etc. from the SNICAR file)
# are installed via set_aerosol_optics_5bd
_AER_BAND3 = (0, 1, 1, 2, 2)
_AER5 = None                     # (kaer, waer, gaer) [5, n_species]


def set_aerosol_optics_5bd(kaer, waer, gaer):
    """Install exact 5-band aerosol optics (kaer_tab_5bd /
    waer_tab_5bd / gaer_tab_5bd from the SNICAR optics file,
    shape [5, n_species]); replaces the 3-band band-mapping."""
    global _AER5
    _AER5 = (np.asarray(kaer), np.asarray(waer), np.asarray(gaer))


def _mix_aerosol_5bd(tau, w0, g, mp, band):
    """5-band aerosol mixing: exact tables when installed, else the
    3-band tables mapped onto the 5 bands."""
    if _AER5 is None:
        return _mix_aerosol(tau, w0, g, mp, _AER_BAND3[band])
    kaer, waer, gaer = _AER5
    n_sp = mp.shape[-1]
    k_t = jnp.asarray(kaer[band, :n_sp], mp.dtype)
    w_t = jnp.asarray(waer[band, :n_sp], mp.dtype)
    g_t = jnp.asarray(gaer[band, :n_sp], mp.dtype)
    taer = (mp * k_t).sum(-1)
    wa = (mp * k_t * w_t).sum(-1)
    ga = (mp * k_t * w_t * g_t).sum(-1)
    from . import constants as _c
    g_new = (g * w0 * tau + ga) / jnp.maximum(w0 * tau + wa, _c.PUNY)
    w_new = (w0 * tau + wa) / jnp.maximum(tau + taer, _c.PUNY)
    return tau + taer, w_new, jnp.where(taer > 0.0, g_new, g)

NSPINT_5BD = 5

# 5-band spectral weights (reference :4527-4539); band 1 is visible,
# bands 2-5 partition the NIR differently for direct/diffuse skies
WGHT_DRC = np.array([1.0, 0.49352158521175, 0.18099494230665,
                     0.12094898498813,
                     1.0 - (0.49352158521175 + 0.18099494230665 +
                            0.12094898498813)])
WGHT_DFS = np.array([1.0, 0.58581507618433, 0.20156903770812,
                     0.10917889346386,
                     1.0 - (0.58581507618433 + 0.20156903770812 +
                            0.10917889346386)])

# 5-band sea ice IOPs (reference :4458-4482)
KI_SSL_5 = np.array([1000.1, 1003.7, 1003.7, 7042.0, 7042.0])
WI_SSL_5 = np.array([0.9999, 0.9963, 0.9963, 0.9088, 0.9088])
GI_SSL_5 = np.full(5, 0.94)
KI_DL_5 = np.array([100.2, 107.7, 107.7, 1309.0, 1309.0])
WI_DL_5 = np.array([0.9980, 0.9287, 0.9287, 0.0305, 0.0305])
GI_DL_5 = np.full(5, 0.94)
KI_INT_5 = np.array([20.2, 27.7, 27.7, 1445.0, 1445.0])
WI_INT_5 = np.array([0.9901, 0.7223, 0.7223, 0.0277, 0.0277])
GI_INT_5 = np.full(5, 0.94)

RSNW_SNICAR_MIN = 30.0
RSNW_SNICAR_MAX = 1629.0


class SnicarSSP(NamedTuple):
    """Snow single-scattering properties vs grain radius, per band and
    sky type.  radii [nR]; ext (mass extinction, m^2/kg), ssa, asm:
    [2(sky: drc,dfs), 5, nR]."""
    radii: np.ndarray
    ext: np.ndarray
    ssa: np.ndarray
    asm_: np.ndarray


def _fallback_ssp() -> SnicarSSP:
    """Embedded geometric-optics fallback SSP table (used when the
    SNICAR optics NetCDF is not provided).  Mass extinction from
    Qext=2 spheres; band co-albedo grows ~sqrt(r) with per-band
    magnitudes matching SNICAR's published behavior (Flanner & Zender
    2006); diffuse sky slightly more absorptive in the NIR."""
    radii = np.array([30.0, 50.0, 100.0, 200.0, 400.0, 800.0, 1200.0,
                      RSNW_SNICAR_MAX])
    r_m = radii * 1e-6
    ext = 3.0 * 2.0 / (4.0 * 917.0 * r_m)          # [nR] m^2/kg
    ext = np.tile(ext, (2, NSPINT_5BD, 1))
    co_alb = np.array([5.0e-6, 1.0e-4, 6.0e-4, 6.0e-3, 3.0e-2])
    sq = np.sqrt(radii)[None, :]
    ssa_drc = np.clip(1.0 - co_alb[:, None] * sq, 0.45, 1.0 - 1e-7)
    ssa_dfs = np.clip(1.0 - 1.12 * co_alb[:, None] * sq, 0.45,
                      1.0 - 1e-7)
    ssa = np.stack([ssa_drc, ssa_dfs])
    g0 = 0.885 + 0.012 * np.arange(NSPINT_5BD)[:, None] / 4.0
    asm_ = np.clip(g0 + 0.01 * np.log10(radii / 100.0)[None, :],
                   0.84, 0.96)
    asm_ = np.stack([asm_, asm_ + 0.002])
    return SnicarSSP(radii=radii, ext=ext, ssa=ssa, asm_=asm_)


_ACTIVE_SSP: SnicarSSP = _fallback_ssp()


def load_snicar_ssp(path: str) -> SnicarSSP:
    """Load the reference's SNICAR optics NetCDF
    (snicar_optics_5bnd_snow_and_aerosols.nc: ss_alb_ice_drc/dfs,
    asm_prm_ice_drc/dfs, ext_cff_mss_ice_drc/dfs over 1471 radii) and
    make it the active table."""
    global _ACTIVE_SSP
    try:
        import netCDF4
        ds = netCDF4.Dataset(path)
    except ImportError:
        from scipy.io import netcdf_file
        ds = netcdf_file(path)

    def v(name):
        return np.asarray(ds.variables[name][:], np.float64)

    ext = np.stack([v("ext_cff_mss_ice_drc"), v("ext_cff_mss_ice_dfs")])
    ssa = np.stack([v("ss_alb_ice_drc"), v("ss_alb_ice_dfs")])
    asm_ = np.stack([v("asm_prm_ice_drc"), v("asm_prm_ice_dfs")])
    n_r = ext.shape[-1]
    radii = np.arange(RSNW_SNICAR_MIN, RSNW_SNICAR_MIN + n_r)
    _ACTIVE_SSP = SnicarSSP(radii=radii, ext=ext, ssa=ssa, asm_=asm_)
    return _ACTIVE_SSP


def snow_ssp(grain_radius, band: int, sky: int,
             ssp: Optional[SnicarSSP] = None):
    """Interpolated (ext, ssa, asm) for a grain-radius array."""
    t = ssp or _ACTIVE_SSP
    r = jnp.clip(grain_radius, t.radii[0], t.radii[-1])
    rt = jnp.asarray(t.radii)
    idx = jnp.clip(jnp.searchsorted(rt, r) - 1, 0, len(t.radii) - 2)
    r0, r1 = rt[idx], rt[idx + 1]
    w = (r - r0) / jnp.maximum(r1 - r0, 1e-12)

    def interp(tab):
        a = jnp.asarray(tab[sky, band])
        return (1.0 - w) * a[idx] + w * a[idx + 1]

    return interp(t.ext), interp(t.ssa), interp(t.asm_)


def shortwave_snicar(aicen, vicen, vsnon, Tsfcn, coszen,
                     swvdr, swvdf, swidr, swidf,
                     n_ice_layers: int, n_snow_layers: int = 1,
                     apnd=None, hpnd=None, rsnw=None,
                     aero_mp_snow=None, aero_mp_ice=None,
                     R_ice: float = 0.0, R_pnd: float = 0.0,
                     rhos_eff=None):
    """5-band SNICAR shortwave for the snow-covered fraction, blended
    with the 3-band dEdd solution for bare/ponded ice (the reference's
    run_dEdd dispatch: compute_dEdd_5bd for fs, compute_dEdd for
    fi/fp).  Interface identical to shortwave_dedd.
    rhos_eff: optional effective snow density [*B, nCat, ns]
    (snow mass tracers); default rhos."""
    from .shortwave import ShortwaveResult

    ni, ns_l = n_ice_layers, n_snow_layers
    dtype = aicen.dtype
    has = aicen > c.PUNY
    safe_a = jnp.where(has, aicen, 1.0)
    hi = jnp.maximum(jnp.where(has, vicen / safe_a, 0.0), 1e-4)
    hs = jnp.where(has, vsnon / safe_a, 0.0)
    l_snow = hs >= HS_MIN_SW

    mu = jnp.maximum(coszen, 0.01)
    if mu.ndim == aicen.ndim - 1:
        mu = mu[..., None] * jnp.ones_like(aicen)

    fs = jnp.where(l_snow, 1.0, 0.0)
    if apnd is not None:
        hp = jnp.maximum(hpnd, 0.0)
        fp = jnp.where(hp >= HPMIN, jnp.clip(apnd, 0.0, 1.0), 0.0)
        fs = jnp.minimum(fs, 1.0 - fp)

    # bare/pond fractions via the 3-band solver with the snow rows
    # suppressed (vsnon -> 0): base = (1-fp)*bare + fp*pond.  The final
    # blend replaces fs of the bare part with the 5-band snow solution:
    #   final = base + fs * (snow5 - bare3)
    base = shortwave_dedd(aicen, vicen, jnp.zeros_like(vsnon), Tsfcn,
                          coszen, swvdr, swvdf, swidr, swidf, ni, ns_l,
                          apnd=apnd, hpnd=hpnd,
                          aero_mp_ice=aero_mp_ice, R_ice=R_ice,
                          R_pnd=R_pnd)
    bare3 = shortwave_dedd(aicen, vicen, jnp.zeros_like(vsnon), Tsfcn,
                           coszen, swvdr, swvdf, swidr, swidf, ni, ns_l,
                           aero_mp_ice=aero_mp_ice, R_ice=R_ice,
                           R_pnd=R_pnd) \
        if apnd is not None else base

    # snow grain radius rows (tracer, else the SNICAR fresh radius)
    if rsnw is not None:
        r_rows = [jnp.clip(rsnw[..., 0], RSNW_SNICAR_MIN,
                           RSNW_SNICAR_MAX)] * 2 + \
            [jnp.clip(rsnw[..., k], RSNW_SNICAR_MIN, RSNW_SNICAR_MAX)
             for k in range(1, ns_l)]
    else:
        r_rows = [jnp.full_like(aicen, 100.0)] * (ns_l + 1)
    rhos_rows = [jnp.full_like(aicen, c.RHOS)] * (ns_l + 1)
    if rhos_eff is not None:
        rhos_rows = [rhos_eff[..., 0]] * 2 + \
            [rhos_eff[..., k] for k in range(1, ns_l)]

    # layer thicknesses (same geometry as compute_dEdd)
    dz_s = hs / ns_l
    dzs_rows = [jnp.minimum(HS_SSL, dz_s / 2.0)]
    dzs_rows.append(dz_s - dzs_rows[0])
    for _ in range(ns_l - 1):
        dzs_rows.append(dz_s)
    dz_i = hi / ni
    dzi_ssl = jnp.minimum(jnp.minimum(HI_SSL, hi / 30.0), dz_i / 2.0)
    dzi_dl = dz_i - dzi_ssl
    fs_dl = 0.25 / ni
    kfrsnl = ns_l + 2
    K = ns_l + ni + 2

    def bsc(x):
        return x[..., None] * jnp.ones_like(aicen) if \
            x.ndim == aicen.ndim - 1 else x

    # per-band incident fluxes (visible band carries all the visible,
    # NIR bands split swidr/swidf with sky-specific weights)
    sw_b_dr = [bsc(swvdr)] + [bsc(swidr) * WGHT_DRC[b]
                              for b in range(1, 5)]
    sw_b_df = [bsc(swvdf)] + [bsc(swidf) * WGHT_DFS[b]
                              for b in range(1, 5)]

    zero = jnp.zeros_like(aicen)
    abs_srf = zero
    abs_int = zero
    Iswabs = jnp.zeros(aicen.shape + (ni,), dtype)
    Sswabs = jnp.zeros(aicen.shape + (ns_l,), dtype)
    fswthru = zero
    alvdr = alvdf = alidr = alidf = zero

    for b in range(NSPINT_5BD):
        ki_ssl, wi_ssl = _tune_iops(KI_SSL_5[b], WI_SSL_5[b], R_ice,
                                    FP_ICE, FM_ICE)
        ki_dl, wi_dl = _tune_iops(KI_DL_5[b], WI_DL_5[b], R_ice,
                                  FP_ICE, FM_ICE)
        ki_int, wi_int = _tune_iops(KI_INT_5[b], WI_INT_5[b], R_ice,
                                    FP_ICE, FM_ICE)
        for sky, fdr_b, fdf_b in ((0, sw_b_dr[b], zero),
                                  (1, zero, sw_b_df[b])):
            taus, w0s, gls = [], [], []
            for k in range(ns_l + 1):
                ks, ws_s, gs_s = snow_ssp(r_rows[k], b, sky)
                taus.append(jnp.where(
                    l_snow, ks * rhos_rows[k] * dzs_rows[k], 0.0))
                w0s.append(jnp.where(l_snow, ws_s, 0.0))
                gls.append(jnp.where(l_snow, gs_s, 0.0))
            taus += [ki_ssl * dzi_ssl, ki_dl * dzi_dl * fs_dl]
            w0s += [jnp.full_like(aicen, wi_ssl),
                    jnp.full_like(aicen, wi_dl)]
            gls += [jnp.full_like(aicen, GI_SSL_5[b]),
                    jnp.full_like(aicen, GI_DL_5[b])]
            for k in range(ni - 1):
                if b == 0 and k == ni - 2:
                    # bottom-algae absorption, visible band (fixed
                    # kalg*0.5 m optical depth; see dedd.KALG)
                    from .dedd import KALG
                    kabs = ki_int * (1.0 - wi_int) + \
                        KALG * 0.5 / dz_i
                    sig = ki_int * wi_int
                    taus.append((kabs + sig) * dz_i)
                    w0s.append(jnp.broadcast_to(
                        sig / (sig + kabs), aicen.shape))
                    gls.append(jnp.full_like(aicen, GI_INT_5[b]))
                else:
                    taus.append(ki_int * dz_i)
                    w0s.append(jnp.full_like(aicen, wi_int))
                    gls.append(jnp.full_like(aicen, GI_INT_5[b]))

            # bulk aerosol mixing (reference compute_dEdd_5bd aerosol
            # sections; 3-band tables mapped onto the 5 bands)
            if aero_mp_snow is not None:
                mps = jnp.where(l_snow[..., None],
                                aero_mp_snow[..., 0], 0.0)
                mpb = jnp.where(l_snow[..., None],
                                aero_mp_snow[..., 1], 0.0) / ns_l
                taus[0], w0s[0], gls[0] = _mix_aerosol_5bd(
                    taus[0], w0s[0], gls[0], mps, b)
                for k in range(1, ns_l + 1):
                    taus[k], w0s[k], gls[k] = _mix_aerosol_5bd(
                        taus[k], w0s[k], gls[k], mpb, b)
            if aero_mp_ice is not None:
                mpi_s = aero_mp_ice[..., 0]
                mpi_b = aero_mp_ice[..., 1] / ni
                taus[ns_l + 1], w0s[ns_l + 1], gls[ns_l + 1] = \
                    _mix_aerosol_5bd(taus[ns_l + 1], w0s[ns_l + 1],
                                     gls[ns_l + 1], mpi_s, b)
                for k in range(ns_l + 2, K):
                    taus[k], w0s[k], gls[k] = _mix_aerosol_5bd(
                        taus[k], w0s[k], gls[k], mpi_b, b)

            sol = solve_dedd_column(taus, w0s, gls, mu, kfrsnl,
                                    ALBOCN_DR[min(b, 2)],
                                    ALBOCN_DF[min(b, 2)])
            F = [sol["net_dn_dir"][k] * fdr_b +
                 sol["net_dn_dif"][k] * fdf_b for k in range(K + 1)]
            # snow-covered booking: ksrf = 1 (snow SSL to surface,
            # snow body to Sswabs, ice SSL+DL to Iswabs(1))
            abs_srf = abs_srf + fs * (F[0] - F[1])
            abs_int = abs_int + fs * (F[1] - F[K])
            fswthru = fswthru + fs * F[K]
            for k in range(ns_l):
                Sswabs = Sswabs.at[..., k].add(
                    fs * (F[k + 1] - F[k + 2]))
            Iswabs = Iswabs.at[..., 0].add(
                fs * (F[ns_l + 1] - F[ns_l + 3]))
            for k in range(ni - 1):
                Iswabs = Iswabs.at[..., k + 1].add(
                    fs * (F[ns_l + 3 + k] - F[ns_l + 4 + k]))
            a_sky = sol["albedo_dr"] if sky == 0 else sol["albedo_df"]
            if b == 0:
                if sky == 0:
                    alvdr = alvdr + fs * a_sky
                else:
                    alvdf = alvdf + fs * a_sky
            else:
                if sky == 0:
                    alidr = alidr + fs * a_sky * WGHT_DRC[b]
                else:
                    alidf = alidf + fs * a_sky * WGHT_DFS[b]

    def z(x):
        return jnp.where(has, x, 0.0)

    def blend(snow5_x, base_x, bare3_x, extra_axis=False):
        f = fs[..., None] if extra_axis else fs
        return snow5_x + base_x - f * bare3_x

    return ShortwaveResult(
        alvdr=z(blend(alvdr, base.alvdr, bare3.alvdr)),
        alvdf=z(blend(alvdf, base.alvdf, bare3.alvdf)),
        alidr=z(blend(alidr, base.alidr, bare3.alidr)),
        alidf=z(blend(alidf, base.alidf, bare3.alidf)),
        fswsfc=z(blend(abs_srf, base.fswsfc, bare3.fswsfc)),
        fswint=z(blend(abs_int, base.fswint, bare3.fswint)),
        fswthru=z(blend(fswthru, base.fswthru, bare3.fswthru)),
        Iswabs=jnp.where(
            has[..., None],
            jnp.maximum(blend(Iswabs, base.Iswabs, bare3.Iswabs,
                              extra_axis=True), 0.0), 0.0),
        Sswabs=jnp.where(has[..., None], jnp.maximum(Sswabs, 0.0), 0.0),
        albin=z(alvdr), albsn=z(alvdf))
