"""Brine height dynamics (tr_brine / hbrine).

JAX re-design of the reference's `src/column/ice_brine.F90`:
`preflushing_changes` (:46-130), `compute_microS_mushy` (:139-324),
`prepare_hbrine` (:328-448), `update_hbrine` (:463-581) and
`calculate_drho` (:843-945).  The brine-height tracer fbri = hbr/hin
tracks the brine surface relative to the ice bottom; its dynamics
(growth/melt forcing, Darcy relaxation toward sea level through the
permeable mush) feed the vertical salinity/bio transport
diffusivities.  All per-cell scalar code becomes dense [*B, nCat]
selects; the vertical bio grid (nblyr layers) is a static dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from . import constants as c

# reference ice_brine.F90:22-31
MAXHBR = 1.25
VISCOS = 2.1e-6
A1, A2, A3 = -21.4, -0.886, -0.012     # brine_sal(T) cubic
B1, B2 = 1000.0, 0.8                   # brine_rho(S) linear
# reference ice_zbgc_shared.F90:114-133
EXP_H = 3.0
K_O = 3.0e-8
THINS = 0.05
VISCOS_DYNAMIC = 2.2
DM_MOLECULAR = 1.0e-9
RA_C = 0.05
L_SK = 7.0                # skeletal scale length (m^-1; namelist l_sk)
RHOSI = 940.0             # reference ice_colpkg_shared.F90:459
MIN_SALIN = 0.1
DH_MIN = 0.001


def bio_grids(nblyr: int):
    """The nondimensional bio grids (reference colpkg_init_hbrine,
    ice_colpkg.F90:5825-5842): bgrid [nblyr+2] midpoints with
    boundary rows, igrid [nblyr+1] interfaces."""
    zspace = 1.0 / max(1, nblyr)
    bgrid = np.zeros(nblyr + 2)
    bgrid[-1] = 1.0
    for k in range(1, nblyr + 1):
        bgrid[k] = zspace * (k - 0.5)
    igrid = np.zeros(nblyr + 1)
    igrid[-1] = 1.0
    for k in range(1, nblyr):
        igrid[k] = 0.5 * (bgrid[k + 1] + bgrid[k])
    return bgrid, igrid


class PreflushResult(NamedTuple):
    hin: jnp.ndarray
    hsn: jnp.ndarray
    hin_old: jnp.ndarray
    dhice: jnp.ndarray
    dhbr_top: jnp.ndarray
    dhbr_bot: jnp.ndarray
    hbr_old: jnp.ndarray


def preflushing_changes(aicen, vicen, vsnon, meltb, meltt, congel,
                        snoice, hice_old, fbri) -> PreflushResult:
    """Brine-surface forcing from this step's growth/melt
    (reference preflushing_changes :46-130)."""
    has = aicen > c.PUNY
    safe = jnp.where(has, aicen, 1.0)
    hin = jnp.where(has, vicen / safe, 0.0)
    hsn = jnp.where(has, vsnon / safe, 0.0)
    hin_old = jnp.maximum(0.0, hin + meltb + meltt - congel - snoice)
    dhice = hin_old - hice_old           # sublimation/condensation
    dhbr_top = meltt - snoice - dhice
    dhbr_bot = congel - meltb
    hbr_old = fbri * hice_old
    return PreflushResult(hin=hin, hsn=hsn, hin_old=hin_old,
                          dhice=dhice, dhbr_top=dhbr_top,
                          dhbr_bot=dhbr_bot, hbr_old=hbr_old)


def remap_profile_to_bgrid(profile, src_pts: np.ndarray,
                           dst_pts: np.ndarray, surface_value):
    """Map a CICE-grid vertical profile onto the bio grid by linear
    interpolation in normalized depth (reference remap_zbgc with equal
    heights).  profile [*B, nSrc]; returns [*B, nDst]."""
    src = np.asarray(src_pts)
    dst = np.asarray(dst_pts)
    n_src = len(src)
    out = []
    for zd in dst:
        i1 = int(np.searchsorted(src, zd))
        if i1 == 0:
            # above the top source point: blend toward surface value
            w = zd / max(src[0], 1e-12)
            out.append((1.0 - w) * surface_value + w * profile[..., 0])
        elif i1 >= n_src:
            out.append(profile[..., n_src - 1])
        else:
            w = (zd - src[i1 - 1]) / max(src[i1] - src[i1 - 1], 1e-12)
            out.append((1.0 - w) * profile[..., i1 - 1] +
                       w * profile[..., i1])
    return jnp.stack(out, axis=-1)


class MicroSResult(NamedTuple):
    bSin: jnp.ndarray        # [*B, nblyr+2] bulk salinity on bgrid
    bTin: jnp.ndarray        # temperature on bgrid
    bphin: jnp.ndarray       # porosity on bgrid
    brine_sal: jnp.ndarray   # equilibrium brine salinity
    brine_rho: jnp.ndarray   # brine density
    iphin: jnp.ndarray       # [*B, nblyr+1] porosity on igrid
    iTin: jnp.ndarray
    ibrine_sal: jnp.ndarray
    ibrine_rho: jnp.ndarray
    kperm: jnp.ndarray       # [*B] harmonic average permeability
    bphi_min: jnp.ndarray    # [*B] surface porosity
    sice_rho: jnp.ndarray    # [*B] mean ice density
    iDin: jnp.ndarray        # [*B, nblyr+1] diffusivity / h^2 (1/s)


def _prepare_hbrine(bSin, bTin, igrid):
    """Brine salinity/density/porosity/permeability from the bulk state
    (reference prepare_hbrine :328-448).  bSin/bTin [*B, nblyr+2]
    (rows 1..nblyr are interior; row 0 mirrors row 1; last row is the
    ocean)."""
    nblyr = bSin.shape[-1] - 2
    ig = jnp.asarray(igrid, bSin.dtype)
    brine_sal = A1 * bTin + A2 * bTin ** 2 + A3 * bTin ** 3
    brine_rho = B1 + B2 * brine_sal
    bphin = jnp.clip(bSin * RHOSI /
                     jnp.maximum(brine_sal * brine_rho, c.PUNY),
                     c.PUNY, 1.0)
    # ocean row
    brine_rho = brine_rho.at[..., -1].set(c.RHOW)
    bphin = bphin.at[..., -1].set(1.0)

    kin = K_O * bphin ** EXP_H                      # [*B, nblyr+2]
    # mean ice density over the interior rows, weighted by igrid spacing
    dig = jnp.asarray(np.diff(np.concatenate([[0.0], igrid[1:]])),
                      bSin.dtype)
    interior = bphin[..., 1:nblyr + 2]
    rho_rows = (c.RHOI * (1.0 - interior[..., :nblyr + 1]) +
                brine_rho[..., 1:nblyr + 2] * interior[..., :nblyr + 1])
    sice_rho = (rho_rows[..., :len(dig)] * dig).sum(-1)

    # interface values (igrid-weighted means of adjacent rows)
    def iface(b):
        out = [b[..., 1]]
        for k in range(1, nblyr):
            igrp = igrid[k + 1] - igrid[k]
            igrm = igrid[k] - igrid[k - 1]
            rigr = 1.0 / (igrid[k + 1] - igrid[k - 1])
            out.append((b[..., k + 1] * igrp + b[..., k] * igrm) * rigr)
        out.append(b[..., nblyr])
        return jnp.stack(out, axis=-1)

    ibrine_sal = iface(brine_sal)
    ibrine_sal = ibrine_sal.at[..., -1].set(brine_sal[..., -1])
    ibrine_rho = iface(brine_rho)
    ibrine_rho = ibrine_rho.at[..., -1].set(brine_rho[..., -1])
    iTin = iface(bTin)
    iphin = jnp.clip(iface(bphin), c.PUNY, 1.0)

    # harmonic mean permeability over interior layers 2..nblyr+1
    k_int = kin[..., 1:nblyr + 1]
    k_min = k_int.min(-1)
    kperm = jnp.where(k_min > 0.0,
                      nblyr / jnp.maximum(
                          (1.0 / jnp.maximum(k_int, 1e-30)).sum(-1),
                          c.PUNY), 0.0)
    bphi_min = bphin[..., 0]
    return (brine_sal, brine_rho, bphin, iphin, iTin, ibrine_sal,
            ibrine_rho, kperm, bphi_min, sice_rho)


def _calculate_drho(brine_rho, ibrine_rho, bgrid, igrid):
    """Unstable brine density difference about each interface
    (reference calculate_drho :843-945): destabilizing density excess
    of the column above each interface relative to below — the driver
    of gravity drainage."""
    nblyr = ibrine_rho.shape[-1] - 1
    ig = np.asarray(igrid)
    bg = np.asarray(bgrid)
    # rho_a[k]: mean brine density above igrid[k] (cumulative trapezoid)
    rho_a = [brine_rho[..., 1]]
    acc = brine_rho[..., 1] * bg[1] + \
        (ibrine_rho[..., 1] + brine_rho[..., 1]) * 0.5 * (ig[1] - bg[1])
    rho_a.append(acc / max(ig[1], 1e-12))
    for k in range(2, nblyr):
        acc = rho_a[-1] * ig[k - 1] + \
            (ibrine_rho[..., k - 1] + brine_rho[..., k]) * 0.5 * \
            (bg[k] - ig[k - 1]) + \
            (ibrine_rho[..., k] + brine_rho[..., k]) * 0.5 * \
            (ig[k] - bg[k])
        rho_a.append(acc / max(ig[k], 1e-12))
    acc = rho_a[-1] * ig[nblyr - 1] + \
        (ibrine_rho[..., nblyr - 1] + brine_rho[..., nblyr]) * 0.5 * \
        (bg[nblyr] - ig[nblyr - 1]) + \
        brine_rho[..., nblyr] * (ig[nblyr] - bg[nblyr])
    rho_a.append(acc / max(ig[nblyr], 1e-12))
    rho_a = jnp.stack(rho_a[:nblyr + 1], axis=-1)   # [*B, nblyr+1]

    # rho_2a[k]: mean density over twice the depth (reference mstop
    # logic: rho_a at 2k-1 if inside the ice, else blend with ocean)
    rows = []
    for k in range(nblyr + 1):
        if k == 0:
            rows.append(rho_a[..., 0])
        else:
            m = 2 * k
            if m < nblyr + 1:
                rows.append(rho_a[..., m])
            else:
                rows.append((rho_a[..., nblyr] + c.RHOW *
                             (2.0 * ig[k] - 1.0)) * 0.5 /
                            max(ig[k], 1e-12))
    rho_2a = jnp.stack(rows, axis=-1)
    rho_b = jnp.concatenate(
        [brine_rho[..., 1:2], brine_rho[..., 1:nblyr + 1]], axis=-1)
    rho_2b = brine_rho[..., 1:nblyr + 2]
    drho = jnp.maximum(
        rho_b - rho_2b,
        jnp.maximum(0.0, jnp.maximum(
            2.0 * (rho_a - rho_2a),
            2.0 * (brine_rho[..., :nblyr + 1] -
                   brine_rho[..., 1:nblyr + 2]) / nblyr)))
    return drho


def compute_micro_s_mushy(zqin, zSin, sss, sst, hbr_old,
                          nblyr: int) -> MicroSResult:
    """Brine microstructure from the mushy thermodynamic state
    (reference compute_microS_mushy :139-324): remap S/q onto the bio
    grid, mushy T/phi relations, brine salinity/density, interface
    values, permeability and the gravity-drainage diffusivity iDin."""
    from .mushy import liquid_fraction, temperature_mush
    ni = zqin.shape[-1]
    bgrid, igrid = bio_grids(nblyr)
    cgrid = np.array([(k - 0.5) / ni for k in range(1, ni + 1)])

    bS_int = remap_profile_to_bgrid(zSin, cgrid, bgrid[1:nblyr + 1],
                                    MIN_SALIN)
    bq_int = remap_profile_to_bgrid(zqin, cgrid, bgrid[1:nblyr + 1],
                                    0.0)
    bS_int = jnp.maximum(0.01, bS_int)
    bq_int = jnp.minimum(0.0, bq_int)
    bT_int = temperature_mush(bq_int, bS_int)
    ones = jnp.ones_like(bS_int[..., :1])
    bSin = jnp.concatenate([bS_int[..., :1], bS_int,
                            sss[..., None] * ones], axis=-1)
    bTin = jnp.concatenate([bT_int[..., :1], bT_int,
                            sst[..., None] * ones], axis=-1)

    (brine_sal, brine_rho, bphin, iphin, iTin, ibrine_sal, ibrine_rho,
     kperm, bphi_min, sice_rho) = _prepare_hbrine(bSin, bTin, igrid)

    drho = _calculate_drho(brine_rho, ibrine_rho, bgrid, igrid)
    ikin = K_O * iphin ** EXP_H
    hbr2 = jnp.maximum(hbr_old, c.PUNY)[..., None] ** 2
    iDin = iphin * DM_MOLECULAR / hbr2
    convect = (hbr_old >= RA_C)[..., None]
    iDin = iDin + jnp.where(
        convect,
        L_SK * ikin * c.GRAVIT / VISCOS_DYNAMIC * drho / hbr2, 0.0)
    # top interface has no flux
    iDin = iDin.at[..., 0].set(0.0)

    return MicroSResult(
        bSin=bSin, bTin=bTin, bphin=bphin, brine_sal=brine_sal,
        brine_rho=brine_rho, iphin=iphin, iTin=iTin,
        ibrine_sal=ibrine_sal, ibrine_rho=ibrine_rho, kperm=kperm,
        bphi_min=bphi_min, sice_rho=sice_rho, iDin=iDin)


class HbrineResult(NamedTuple):
    hbr: jnp.ndarray
    fbri: jnp.ndarray
    darcy_v: jnp.ndarray
    dhS_top: jnp.ndarray
    dhS_bottom: jnp.ndarray
    dh_direct: jnp.ndarray   # surface flooding (<0) or runoff (>0)


def update_hbrine(dt, meltb, meltt, melts, hin, hsn, hin_old,
                  hbr_old, snoice, dhS_bottom, kperm, bphin_top,
                  aice0) -> HbrineResult:
    """Advance the brine height (reference update_hbrine :463-581):
    top/bottom forcing from melt/growth, then exponential Darcy
    relaxation of the brine surface toward sea level through the
    permeable column."""
    h_ocn = RHOSI / c.RHOW * hin + c.RHOS / c.RHOW * hsn
    thick = (hbr_old > THINS) & (hin_old > THINS) & (hin > THINS)

    # --- thick branch ---
    dhS_top_t = -jnp.maximum(
        0.0, jnp.minimum(hin_old - hbr_old, meltt)) * c.RHOI / c.RHOW
    dhS_top_t = dhS_top_t - jnp.maximum(0.0, melts) * c.RHOS / c.RHOW
    dhbr = dhS_bottom - dhS_top_t
    hbr_t = jnp.maximum(c.PUNY, hbr_old + dhbr)
    hbrocn = hbr_t - h_ocn
    darcy_coeff = jnp.maximum(
        0.0, kperm * c.GRAVIT /
        (VISCOS * jnp.maximum(hbr_old, c.PUNY)))
    bphi = jnp.maximum(bphin_top, c.PUNY)
    decay = jnp.exp(-darcy_coeff / bphi * dt)

    # brine above sea level: runoff + drainage
    above = (hbrocn > 0.0) & (hbr_t > THINS)
    dhrunoff = -dhS_top_t * aice0
    hbrocn_a = jnp.maximum(0.0, hbrocn - dhrunoff)
    hbrocn_new_a = hbrocn_a * decay
    hbr_a = jnp.maximum(THINS, h_ocn + hbrocn_new_a)
    hbrocn_new_a = hbr_a - h_ocn
    darcy_a = -jnp.sign(hbrocn) * (hbrocn_a - hbrocn_new_a) / dt * bphi
    dhS_top_a = dhS_top_t - darcy_a * dt / bphi + dhrunoff

    # brine below sea level: flooding
    below = (hbrocn < 0.0) & (hbr_t > THINS)
    hbrocn_new_b = hbrocn * decay
    dhflood = jnp.maximum(0.0, hbrocn_new_b - hbrocn) * aice0
    hbr_b = jnp.maximum(THINS, h_ocn + hbrocn_new_b)
    darcy_b = -jnp.sign(hbrocn) * \
        (hbrocn - hbrocn_new_b + dhflood) / dt * bphi
    dhS_top_b = dhS_top_t - darcy_b * dt / bphi - dhflood

    hbr_thick = jnp.where(above, hbr_a, jnp.where(below, hbr_b, hbr_t))
    darcy_thick = jnp.where(above, darcy_a,
                            jnp.where(below, darcy_b, 0.0))
    dhS_top_thick = jnp.where(above, dhS_top_a,
                              jnp.where(below, dhS_top_b, dhS_top_t))
    dh_direct = jnp.where(above, dhrunoff,
                          jnp.where(below, -dhflood, 0.0))

    # --- thin branch (:561-576) ---
    hbrmin = jnp.minimum(THINS, hin)
    hbr_thin = jnp.maximum(hbrmin, hbr_old + dhS_bottom - dhS_top_t)
    dhbr_hin = hbr_thin - h_ocn
    hbr_thin = jnp.where(
        jnp.abs(dhbr_hin) > DH_MIN,
        jnp.maximum(hbrmin, h_ocn + jnp.sign(dhbr_hin) * DH_MIN),
        hbr_thin)
    dhS_top_thin = hbr_old - hbr_thin + dhS_bottom

    hbr = jnp.where(thick, hbr_thick, hbr_thin)
    darcy_v = jnp.where(thick, darcy_thick, 0.0)
    dhS_top = jnp.where(thick, dhS_top_thick, dhS_top_thin)
    dh_dir = jnp.where(thick, dh_direct, 0.0)
    fbri = hbr / jnp.maximum(hin, c.PUNY)
    return HbrineResult(hbr=hbr, fbri=fbri, darcy_v=darcy_v,
                        dhS_top=dhS_top, dhS_bottom=dhS_bottom,
                        dh_direct=dh_dir)
