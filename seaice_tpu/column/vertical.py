"""Vertical thermodynamics: growth/melt and the per-category driver.

JAX re-design of `thermo_vertical`
(`/root/reference/src/column/ice_therm_vertical.F90:53-471`) and its
stages: `init_vertical_profile` (:652), `thickness_changes` (:1026),
`freeboard` (:1755), `adjust_enthalpy`, `frzmlt_bottom_lateral` (:482).
The sequential consume-energy-through-layers loops are unrolled over the
static layer count, fully vectorized over the [nCells, nCategories]
batch.  The temperature solver is dispatched on `ktherm` exactly as the
reference does (`ice_therm_vertical.F90:286-335`):

  * ktherm=0 — Semtner zero-layer (`ice_therm_0layer.F90`),
  * ktherm=1 — BL99 heat solve (`ice_therm_bl99.F90`),
  * ktherm=2 — mushy-layer Picard solve with gravity drainage, pond
    flushing and snow-ice flooding (`ice_therm_mushy.F90`:
    temperature_changes_salinity :35-341, flush_pond :3302,
    flood_ice :3342).

`thickness_changes` carries the reference's ktherm==2 branches
(melt enthalpies relative to enthalpy_of_melting, mushy bottom-growth
enthalpy/salinity, internal snow melt, no freeboard — flooding happens
in flood_ice) and the optional snow mass tracers smice/smliq + grain
radius rsnw (tr_snow/tr_rsnw paths of the reference).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from . import constants as c
from .bl99 import temperature_changes
from .thermo_shared import (ice_enthalpy_from_temperature,
                            ice_temperature_from_enthalpy,
                            melting_temperature,
                            snow_enthalpy_from_temperature,
                            snow_temperature_from_enthalpy)

QBOTMAX = -0.5 * c.RHOI * c.LFRESH
PHI_I_MUSHY = 0.85       # solid fraction of new bottom mush (colpkg default)


def frzmlt_bottom_lateral(dt, aice, frzmlt, sst, Tf, strocnxT, strocnyT,
                          etot, tun=None):
    """Ocean-ice bottom heat flux and lateral-melt fraction
    (reference frzmlt_bottom_lateral, ice_therm_vertical.F90:482-641).

    etot: total column energy sum over categories [B] (J/m^2, < 0).
    Returns (Tbot, fbot, rside)."""
    if tun is None:
        from .tuning import DEFAULT as tun
    floediam = 300.0
    floeshape = 0.66
    m1, m2 = 1.6e-6, 1.36

    can_melt = (aice > c.PUNY) & (frzmlt < 0.0)
    Tbot = Tf
    deltaT = jnp.maximum(sst - Tbot, 0.0)
    ustar = jnp.sqrt(jnp.sqrt(strocnxT ** 2 + strocnyT ** 2) / c.RHOW)
    ustar = jnp.maximum(ustar, tun.min_friction_velocity)
    cpchr = -c.CP_OCN * c.RHOW * 0.006
    fbot = cpchr * deltaT * ustar
    fbot = jnp.maximum(fbot, frzmlt)
    fbot = jnp.where(can_melt, fbot, 0.0)

    wlat = m1 * deltaT ** m2
    rside = wlat * dt * c.PI / (floeshape * floediam)
    rside = jnp.clip(rside, 0.0, 1.0)
    rside = jnp.where(can_melt, rside, 0.0)

    # limit fbot and rside so that heat extracted <= frzmlt
    # (reference :600-630): fside = etot*rside/dt <= 0
    fside = etot * rside / dt
    xtmp = frzmlt / jnp.minimum(fbot + fside, -c.PUNY)
    xtmp = jnp.clip(xtmp, 0.0, 1.0)
    fbot = fbot * xtmp
    rside = rside * xtmp
    return Tbot, fbot, rside


def adjust_enthalpy(dz_old, h_new_layer, h_total, q):
    """Conservative remap of layer quantity q from unequal layers dz_old
    to equal layers of thickness h_new_layer (reference adjust_enthalpy).
    dz_old, q: [*B, n]; h_new_layer, h_total: [*B]."""
    n = q.shape[-1]
    z1 = jnp.cumsum(jnp.concatenate(
        [jnp.zeros_like(dz_old[..., :1]), dz_old], axis=-1), axis=-1)
    # new interfaces
    k = jnp.arange(n + 1, dtype=q.dtype)
    z2 = h_new_layer[..., None] * k
    z2 = jnp.concatenate([z2[..., :n], h_total[..., None]], axis=-1)
    hq = []
    for k2 in range(n):
        top = z2[..., k2]
        bot = z2[..., k2 + 1]
        acc = 0.0
        for k1 in range(n):
            ov = jnp.maximum(
                0.0, jnp.minimum(z1[..., k1 + 1], bot) -
                jnp.maximum(z1[..., k1], top))
            acc = acc + ov * q[..., k1]
        hq.append(acc)
    hq = jnp.stack(hq, axis=-1)
    return jnp.where(h_new_layer[..., None] > c.PUNY,
                     hq / jnp.maximum(h_new_layer[..., None], c.PUNY),
                     q)


class ThicknessResult(NamedTuple):
    hin: jnp.ndarray
    hsn: jnp.ndarray
    zqin: jnp.ndarray
    zqsn: jnp.ndarray
    zSin: jnp.ndarray
    efinal: jnp.ndarray
    fhocnn: jnp.ndarray
    evapn: jnp.ndarray
    meltt: jnp.ndarray
    melts: jnp.ndarray
    meltb: jnp.ndarray
    congel: jnp.ndarray
    snoice: jnp.ndarray
    hsn_new: jnp.ndarray
    dsnow: jnp.ndarray
    meltsliq: jnp.ndarray       # liquid leaving the snowpack (kg/m^2)
    smice: Optional[jnp.ndarray]
    smliq: Optional[jnp.ndarray]
    rsnw: Optional[jnp.ndarray]


def thickness_changes(dt, hin, hsn, zqin, zqsn, zSin,
                      fbot, Tbot, flatn, fsurfn, fcondtopn, fcondbot,
                      fsnow, frain=None, ktherm: int = 1, sss=None,
                      smice=None, smliq=None, rsnw=None,
                      tun=None) -> ThicknessResult:
    """Growth and melt at the surfaces + layer re-gridding (reference
    thickness_changes, ice_therm_vertical.F90:1026-1744, including the
    ktherm==2 mushy branches and the tr_snow smice/smliq bookkeeping).

    smice/smliq: optional snow mass tracers [*B, ns] (kg/m^3).
    rsnw: optional snow grain radius [*B, ns] (um).
    """
    ni = zqin.shape[-1]
    ns = zqsn.shape[-1]
    hilyr = hin / ni
    hslyr = hsn / ns
    hslyr0 = hslyr
    if tun is None:
        from .tuning import DEFAULT as tun
    tr_snow = smice is not None
    dzi = [hilyr for _ in range(ni)]
    dzs = [hslyr for _ in range(ns)]
    zqin_l = [zqin[..., k] for k in range(ni)]
    zqsn_l = [zqsn[..., k] for k in range(ns)]
    zSin_l = [zSin[..., k] for k in range(ni)]
    if tr_snow:
        smicetot = [dzs[k] * smice[..., k] for k in range(ns)]
        smliqtot = [dzs[k] * smliq[..., k] for k in range(ns)]
    meltt = jnp.zeros_like(hin)
    melts = jnp.zeros_like(hin)
    meltb = jnp.zeros_like(hin)
    emlt_atm = jnp.zeros_like(hin)
    emlt_ocn = jnp.zeros_like(hin)

    # melt enthalpies: qmlt = enthalpy_of_melting for mushy, else 0
    # (reference :1197-1206); qm = zqin - qmlt drives melt energetics
    if ktherm == 2:
        from .mushy import enthalpy_of_melting, enthalpy_mush
        qmlt_l = [enthalpy_of_melting(zSin_l[k]) for k in range(ni)]
    else:
        qmlt_l = [jnp.zeros_like(hin) for _ in range(ni)]
    qm_l = [zqin_l[k] - qmlt_l[k] for k in range(ni)]

    # energy budgets (reference :1240-1255)
    wk1 = -flatn * dt
    esub = jnp.maximum(wk1, 0.0)
    econ = jnp.minimum(wk1, 0.0)
    wk1 = (fsurfn - fcondtopn) * dt
    etop_mlt = jnp.maximum(wk1, 0.0)
    wk1 = (fcondbot - fbot) * dt
    ebot_mlt = jnp.maximum(wk1, 0.0)
    ebot_gro = jnp.minimum(wk1, 0.0)

    # condensation (:1257-1290)
    has_snow = hsn > c.PUNY
    dhs = jnp.where(has_snow, econ / (zqsn_l[0] - c.RHOS * c.LVAP), 0.0)
    dhi = jnp.where(has_snow, 0.0, econ / (qm_l[0] - c.RHOI * c.LVAP))
    emlt_atm = emlt_atm - jnp.where(has_snow, 0.0, qmlt_l[0] * dhi)
    if tr_snow:
        smicetot[0] = smicetot[0] + dhs * c.RHOS
    dzs[0] = dzs[0] + dhs
    dzi[0] = dzi[0] + dhi
    evapn = dhs * c.RHOS + dhi * c.RHOI

    # bottom growth (:1292-1345)
    if ktherm == 2:
        qbotm = enthalpy_mush(Tbot, sss)
        qbotp = -c.LFRESH * c.RHOI * \
            (1.0 - tun.congelation_ice_porosity)
        qbot0 = qbotm - qbotp
        dhi = ebot_gro / qbotp
        hqtot = dzi[ni - 1] * zqin_l[ni - 1] + dhi * qbotm
        hstot = dzi[ni - 1] * zSin_l[ni - 1] + dhi * sss
        emlt_ocn = emlt_ocn - qbot0 * dhi
    else:
        Tmlts_b = -zSin_l[ni - 1] * c.DEPRESST
        qbot = -c.RHOI * (c.CP_ICE * (Tmlts_b - Tbot) +
                          c.LFRESH * (1.0 - Tmlts_b /
                                      jnp.minimum(Tbot, -c.PUNY)) -
                          c.CP_OCN * Tmlts_b)
        qbot = jnp.minimum(qbot, QBOTMAX)
        dhi = ebot_gro / qbot
        hqtot = dzi[ni - 1] * zqin_l[ni - 1] + dhi * qbot
        hstot = None
    grew = (dzi[ni - 1] + dhi) > c.PUNY
    dzi[ni - 1] = dzi[ni - 1] + dhi
    zqin_l[ni - 1] = jnp.where(grew,
                               hqtot / jnp.maximum(dzi[ni - 1], c.PUNY),
                               zqin_l[ni - 1])
    if ktherm == 2:
        zSin_l[ni - 1] = jnp.where(
            grew, hstot / jnp.maximum(dzi[ni - 1], c.PUNY),
            zSin_l[ni - 1])
        qmlt_l[ni - 1] = enthalpy_of_melting(zSin_l[ni - 1])
    qm_l[ni - 1] = zqin_l[ni - 1] - qmlt_l[ni - 1]
    congel = dhi

    # internal snow melt for mushy (zqsn above fresh melting; :1346-1358)
    if ktherm == 2:
        for k in range(ns):
            warm = zqsn_l[k] > -c.RHOS * c.LFRESH
            dhs = jnp.where(
                warm,
                jnp.maximum(-dzs[k],
                            -((zqsn_l[k] + c.RHOS * c.LFRESH) /
                              (c.RHOS * c.LFRESH)) * dzs[k]), 0.0)
            if tr_snow:
                moved = jnp.where(jnp.abs(dzs[k]) > c.PUNY,
                                  smicetot[k] / jnp.maximum(
                                      dzs[k], c.PUNY) * dhs, 0.0)
                smicetot[k] = jnp.maximum(0.0, smicetot[k] + moved)
                smliqtot[k] = jnp.maximum(0.0, smliqtot[k] - moved)
            dzs[k] = dzs[k] + dhs
            zqsn_l[k] = jnp.where(warm, -c.RHOS * c.LFRESH, zqsn_l[k])
            melts = melts - dhs

    # snow: sublimation then top melt (:1360-1392)
    for k in range(ns):
        qsub = zqsn_l[k] - c.RHOS * c.LVAP
        dhs = jnp.maximum(-dzs[k], esub / qsub)
        if tr_snow:
            moved = jnp.where(jnp.abs(dzs[k]) > c.PUNY,
                              dhs * smicetot[k] /
                              jnp.maximum(dzs[k], c.PUNY), 0.0)
            smicetot[k] = jnp.maximum(0.0, smicetot[k] + moved)
        dzs[k] = dzs[k] + dhs
        esub = jnp.maximum(esub - dhs * qsub, 0.0)
        evapn = evapn + dhs * c.RHOS
        dhs = jnp.maximum(-dzs[k],
                          etop_mlt / jnp.minimum(zqsn_l[k], -c.PUNY))
        if tr_snow:
            moved = jnp.where(jnp.abs(dzs[k]) > c.PUNY,
                              smicetot[k] / jnp.maximum(
                                  dzs[k], c.PUNY) * dhs, 0.0)
            smicetot[k] = jnp.maximum(0.0, smicetot[k] + moved)
            smliqtot[k] = jnp.maximum(0.0, smliqtot[k] - moved)
        dzs[k] = dzs[k] + dhs
        etop_mlt = jnp.maximum(etop_mlt - dhs * zqsn_l[k], 0.0)
        melts = melts - dhs

    # ice: sublimation then top melt, top-down (:1394-1428)
    for k in range(ni):
        qsub = qm_l[k] - c.RHOI * c.LVAP
        dhi = jnp.maximum(-dzi[k], esub / qsub)
        dzi[k] = dzi[k] + dhi
        esub = jnp.maximum(esub - dhi * qsub, 0.0)
        evapn = evapn + dhi * c.RHOI
        emlt_ocn = emlt_ocn - qmlt_l[k] * dhi
        neg_q = qm_l[k] < 0.0
        dhi = jnp.where(neg_q,
                        jnp.maximum(-dzi[k], etop_mlt /
                                    jnp.minimum(qm_l[k], -c.PUNY)),
                        -dzi[k])
        qm_eff = jnp.where(neg_q, qm_l[k], 0.0)
        emlt_ocn = emlt_ocn - jnp.maximum(zqin_l[k], qmlt_l[k]) * dhi
        dzi[k] = dzi[k] + dhi
        etop_mlt = jnp.maximum(etop_mlt - dhi * qm_eff, 0.0)
        meltt = meltt - dhi

    # ice: bottom melt, bottom-up (:1430-1450)
    for k in range(ni - 1, -1, -1):
        neg_q = qm_l[k] < 0.0
        dhi = jnp.where(neg_q,
                        jnp.maximum(-dzi[k], ebot_mlt /
                                    jnp.minimum(qm_l[k], -c.PUNY)),
                        -dzi[k])
        qm_eff = jnp.where(neg_q, qm_l[k], 0.0)
        emlt_ocn = emlt_ocn - jnp.maximum(zqin_l[k], qmlt_l[k]) * dhi
        dzi[k] = dzi[k] + dhi
        ebot_mlt = jnp.maximum(ebot_mlt - dhi * qm_eff, 0.0)
        meltb = meltb - dhi

    # snow: bottom melt after all ice gone (:1452-1468)
    for k in range(ns - 1, -1, -1):
        dhs = jnp.maximum(-dzs[k],
                          ebot_mlt / jnp.minimum(zqsn_l[k], -c.PUNY))
        if tr_snow:
            moved = jnp.where(jnp.abs(dzs[k]) > c.PUNY,
                              smicetot[k] / jnp.maximum(
                                  dzs[k], c.PUNY) * dhs, 0.0)
            smicetot[k] = jnp.maximum(0.0, smicetot[k] + moved)
            smliqtot[k] = jnp.maximum(0.0, smliqtot[k] - moved)
        dzs[k] = dzs[k] + dhs
        ebot_mlt = jnp.maximum(ebot_mlt - dhs * zqsn_l[k], 0.0)
        melts = melts - dhs

    fhocnn = fbot + (esub + etop_mlt + ebot_mlt) / dt

    # new snowfall (:1481-1540)
    hsn_new = fsnow / c.RHOS * dt
    hstot_s = dzs[0] + hsn_new
    zq_new = -c.RHOS * c.LFRESH
    zqsn_l[0] = jnp.where(
        hstot_s > 0.0,
        jnp.minimum((dzs[0] * zqsn_l[0] + hsn_new * zq_new) /
                    jnp.maximum(hstot_s, c.PUNY), -c.RHOS * c.LFRESH),
        zqsn_l[0])
    if rsnw is not None:
        # incorporate fresh snow in the top-layer grain radius
        # (reference add_new_snow_radius)
        rsnw_l = [rsnw[..., k] for k in range(ns)]
        rsnw_l[0] = jnp.where(
            hstot_s > c.PUNY,
            (dzs[0] * rsnw_l[0] + hsn_new * tun.fallen_snow_radius) /
            jnp.maximum(hstot_s, c.PUNY), rsnw_l[0])
    if tr_snow:
        smicetot[0] = smicetot[0] + hsn_new * c.RHOS
        # rain adds to the top-layer liquid tracer (:1542)
        if frain is not None:
            smliqtot[0] = smliqtot[0] + frain * dt
    dzs[0] = jnp.where(hstot_s > 0.0, hstot_s, dzs[0])

    hin = sum(dzi)
    hsn = sum(dzs)
    dsnow = hsn - ns * hslyr0

    # freeboard: convert snow to ice if below waterline (:1565,1780-1860);
    # mushy flooding is handled by flood_ice instead
    snoice = jnp.zeros_like(hin)
    if ktherm != 2:
        wk1 = hsn - hin * (c.RHOW - c.RHOI) / c.RHOS
        below = (wk1 > c.PUNY) & (hsn > c.PUNY)
        dhsn_total = jnp.where(below,
                               jnp.minimum(wk1 * c.RHOI / c.RHOW, hsn),
                               0.0)
        dhin = dhsn_total * c.RHOS / c.RHOI
        hqs = jnp.zeros_like(hin)
        dhsn = dhsn_total
        for k in range(ns - 1, -1, -1):
            act = dhin > c.PUNY
            dhs = jnp.where(act, jnp.minimum(dhsn, dzs[k]), 0.0)
            if tr_snow:
                fracgone = jnp.where(jnp.abs(dzs[k]) > c.PUNY,
                                     dhs / jnp.maximum(dzs[k], c.PUNY),
                                     0.0)
                smicetot[k] = jnp.maximum(
                    0.0, smicetot[k] * (1.0 - fracgone))
                smliqtot[k] = jnp.maximum(
                    0.0, smliqtot[k] * (1.0 - fracgone))
            hsn = hsn - dhs
            dsnow = dsnow - dhs
            dzs[k] = dzs[k] - dhs
            dhsn = jnp.maximum(dhsn - dhs, 0.0)
            hqs = hqs + dhs * zqsn_l[k]
        act = dhin > c.PUNY
        wk1 = dzi[0] + dhin
        hin = jnp.where(act, hin + dhin, hin)
        zqin_l[0] = jnp.where(
            act, (dzi[0] * zqin_l[0] + hqs) / jnp.maximum(wk1, c.PUNY),
            zqin_l[0])
        dzi[0] = jnp.where(act, wk1, dzi[0])
        snoice = jnp.where(act, dhin, 0.0)

    # snow mass tracers back to densities; collect liquid of vanished
    # layers as meltsliq (reference :1585-1600)
    meltsliq = jnp.zeros_like(hin)
    if tr_snow:
        smice_l, smliq_l = [], []
        for k in range(ns):
            gone = dzs[k] <= c.PUNY
            meltsliq = meltsliq + jnp.where(gone, smliqtot[k], 0.0)
            smice_l.append(jnp.where(gone, 0.0, smicetot[k] /
                                     jnp.maximum(dzs[k], c.PUNY)))
            smliq_l.append(jnp.where(gone, 0.0, smliqtot[k] /
                                     jnp.maximum(dzs[k], c.PUNY)))

    # re-grid to equal layers (:1620-1700)
    hin = jnp.maximum(hin, 0.0)
    hsn = jnp.maximum(hsn, 0.0)
    hilyr = hin / ni
    hslyr = hsn / ns
    dzi_a = jnp.stack([jnp.maximum(d, 0.0) for d in dzi], axis=-1)
    dzs_a = jnp.stack([jnp.maximum(d, 0.0) for d in dzs], axis=-1)
    zqin_a = jnp.stack(zqin_l, axis=-1)
    zqsn_a = jnp.stack(zqsn_l, axis=-1)
    zSin_a = jnp.stack(zSin_l, axis=-1)
    if ktherm == 0:
        # zero-heat-capacity ice: enthalpies pinned at the fresh values
        # (reference :1652-1656)
        zqin_a = jnp.full_like(zqin_a, -c.RHOI * c.LFRESH)
        zqsn_a = jnp.full_like(zqsn_a, -c.RHOS * c.LFRESH)
    else:
        zqin_a = adjust_enthalpy(dzi_a, hilyr, hin, zqin_a)
        if ktherm == 2:
            zSin_a = adjust_enthalpy(dzi_a, hilyr, hin, zSin_a)
        if ns > 1:
            zqsn_a = adjust_enthalpy(dzs_a, hslyr, hsn, zqsn_a)
    smice_out = smliq_out = rsnw_out = None
    if ns > 1 and ktherm != 0:
        if rsnw is not None:
            rsnw_out = adjust_enthalpy(
                dzs_a, hslyr, hsn, jnp.stack(rsnw_l, axis=-1))
        if tr_snow:
            smice_out = adjust_enthalpy(
                dzs_a, hslyr, hsn, jnp.stack(smice_l, axis=-1))
            smliq_out = adjust_enthalpy(
                dzs_a, hslyr, hsn, jnp.stack(smliq_l, axis=-1))
    else:
        if rsnw is not None:
            rsnw_out = jnp.stack(rsnw_l, axis=-1)
        if tr_snow:
            smice_out = jnp.stack(smice_l, axis=-1)
            smliq_out = jnp.stack(smliq_l, axis=-1)

    # remove very thin snow (ktherm=2; :1700-1720)
    if ktherm == 2:
        thin = hsn <= c.PUNY
        fhocnn = fhocnn + jnp.where(
            thin, zqsn_a.sum(-1) * hsn / (ns * dt), 0.0)
        zqsn_a = jnp.where(thin[..., None], -c.RHOS * c.LFRESH, zqsn_a)
        if tr_snow:
            meltsliq = meltsliq + jnp.where(
                thin, sum(smicetot), 0.0)
            smice_out = jnp.where(thin[..., None], 0.0, smice_out)
            smliq_out = jnp.where(thin[..., None], 0.0, smliq_out)
        hslyr = jnp.where(thin, 0.0, hslyr)
        hsn = jnp.where(thin, 0.0, hsn)

    efinal = -evapn * c.LVAP + \
        (hslyr[..., None] * zqsn_a).sum(-1) + \
        (hilyr[..., None] * zqin_a).sum(-1)
    evapn = evapn / dt
    if ktherm == 2:
        # melt water is not zero-enthalpy with mushy thermo (:1735-1742)
        fhocnn = fhocnn + emlt_ocn / dt
        efinal = efinal + emlt_atm

    return ThicknessResult(
        hin=hin, hsn=hsn, zqin=zqin_a, zqsn=zqsn_a, zSin=zSin_a,
        efinal=efinal, fhocnn=fhocnn, evapn=evapn, meltt=meltt,
        melts=melts, meltb=meltb, congel=congel, snoice=snoice,
        hsn_new=hsn_new, dsnow=dsnow, meltsliq=meltsliq,
        smice=smice_out, smliq=smliq_out, rsnw=rsnw_out)


class ThermoVerticalResult(NamedTuple):
    Tsf: jnp.ndarray
    hin: jnp.ndarray
    hsn: jnp.ndarray
    zqin: jnp.ndarray
    zqsn: jnp.ndarray
    zSin: jnp.ndarray
    fsensn: jnp.ndarray
    flatn: jnp.ndarray
    flwoutn: jnp.ndarray
    fsurfn: jnp.ndarray
    fcondtopn: jnp.ndarray
    fhocnn: jnp.ndarray
    freshn: jnp.ndarray
    fsaltn: jnp.ndarray
    evapn: jnp.ndarray
    meltt: jnp.ndarray
    melts: jnp.ndarray
    meltb: jnp.ndarray
    congel: jnp.ndarray
    snoice: jnp.ndarray
    converged: jnp.ndarray
    dsnow: jnp.ndarray
    hsn_new: jnp.ndarray             # new snowfall depth this step (m)
    meltsliq: jnp.ndarray
    hpond: Optional[jnp.ndarray]     # updated pond depth (mushy flushing)
    smice: Optional[jnp.ndarray]
    smliq: Optional[jnp.ndarray]
    rsnw: Optional[jnp.ndarray]


LAMBDA_POND = 1.0 / (10.0 * 24.0 * 3600.0)
HPOND0 = 0.01


def flush_pond(dt, w, hpond, apond):
    """Drain melt ponds by mushy Darcy flushing + exponential decay
    (reference flush_pond, ice_therm_mushy.F90:3302-3338)."""
    act = (apond > 0.0) & (hpond > 0.0)
    h = hpond - w * dt / jnp.maximum(apond, c.PUNY)
    h = jnp.maximum(h, 0.0)
    h = h - LAMBDA_POND * dt * (h + HPOND0)
    h = jnp.maximum(h, 0.0)
    return jnp.where(act, h, hpond)


def thermo_vertical(dt, aicen, vicen, vsnon, Tsf, zqin, zqsn, zSin,
                    flw, potT, Qa, rhoa, fsnow,
                    fbot, Tbot, fswsfc, fswint, Sswabs, Iswabs,
                    shcoef, lhcoef, *, ktherm: int = 1, sss=None,
                    frain=None, apond=None, hpond=None,
                    smice=None, smliq=None,
                    rsnw=None, tun=None,
                    prescribed_sfc_fluxes=None) -> ThermoVerticalResult:
    """Per-category vertical thermodynamics driver (reference
    thermo_vertical, ice_therm_vertical.F90:53-471) with the ktherm
    dispatch of the reference (:286-335).

    All inputs [*B] or [*B, nLayers]; category masking (aicen > puny)
    must be applied by the caller; columns with no ice still produce
    finite no-op results.

    ktherm=2 extras: sss (required), apond/hpond (pond fraction of
    category area + depth, for flushing; optional), and the updated
    zSin/hpond are returned.  smice/smliq/rsnw: optional snow mass /
    grain-radius tracers, updated through the melt/regrid bookkeeping.

    prescribed_sfc_fluxes: calc_Tsfc=False coupled mode — a dict with
    'fsurf', 'fcondtop', 'flat', 'fsens' per-category fluxes from the
    atmosphere model (reference set_sfcflux,
    ice_flux_colpkg.F90:174-288, dispatched at
    ice_colpkg.F90:2196-2207).  The surface temperature is not
    re-solved; the thermo uses the know_Tsfc boundary condition.
    Unsupported for ktherm=2 (the reference hard-errors too,
    mpas_seaice_column.F:9259-9263).
    """
    ni = zqin.shape[-1]
    ns = zqsn.shape[-1]
    if ktherm == 2 and sss is None:
        raise ValueError("mushy thermodynamics (ktherm=2) requires sss")
    if prescribed_sfc_fluxes is not None and ktherm == 2:
        raise ValueError(
            "calc_Tsfc=False is incompatible with mushy thermodynamics "
            "(reference check_column_package_configs, "
            "mpas_seaice_column.F:9259-9263)")
    has = aicen > c.PUNY
    safe_a = jnp.where(has, aicen, 1.0)
    hin = jnp.where(has, vicen / safe_a, 0.1)
    hsn = jnp.where(has, vsnon / safe_a, 0.0)
    hin0, hsn0 = hin, hsn          # worki/works (reference :276)
    hilyr = jnp.maximum(hin, c.PUNY) / ni
    hslyr = hsn / ns

    fadvocn = jnp.zeros_like(Tsf)
    snoice_flood = jnp.zeros_like(Tsf)
    hpond_out = hpond

    if ktherm == 2:
        from .mushy import (enthalpy_brine, liquidus_brine_salinity,
                            liquid_fraction, temperature_mush)
        from .mushy_solver import flood_ice, temperature_changes_mushy
        res = temperature_changes_mushy(
            dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
            fswsfc, fswint, Sswabs, Iswabs,
            hilyr, hslyr, zqin, zSin, zqsn, Tsf, Tbot,
            sss=sss, hpond=hpond, apond=apond, tun=tun)
        zqin2, zqsn2, zSin2 = res.zqin, res.zqsn, res.zSin
        fadvocn = res.fadvheat
        # pond flushing (reference :327)
        if hpond is not None:
            hpond_out = flush_pond(dt, res.w, hpond, apond)
        # snow-ice flooding (reference :330)
        phi = liquid_fraction(temperature_mush(zqin2, zSin2), zSin2)
        Sbr = liquidus_brine_salinity(res.zTin)
        fr = flood_ice(dt, hsn, jnp.maximum(hin, c.PUNY), hslyr, hilyr,
                       zqsn2, zqin2, zSin2, phi, Sbr, sss,
                       enthalpy_brine(Tbot))
        zqsn2, zqin2, zSin2 = fr.zqsn, fr.zqin, fr.zSin
        hilyr, hslyr = fr.hilyr, fr.hslyr
        snoice_flood = fr.snoice
        fadvocn = fadvocn - fr.eadded
        converged = res.converged
        solver_fluxes = res
    elif ktherm == 0:
        if prescribed_sfc_fluxes is not None:
            # know_Tsfc zero-layer: fcondbot = fcondtop (reference
            # ice_therm_vertical.F90:355-365); all surface fluxes are
            # the coupler's
            from .zerolayer import ZeroLayerResult
            pf = prescribed_sfc_fluxes
            res = ZeroLayerResult(
                Tsf=Tsf, fsensn=pf["fsens"], flatn=pf["flat"],
                flwoutn=jnp.zeros_like(Tsf), fsurfn=pf["fsurf"],
                fcondtopn=pf["fcondtop"], fcondbot=pf["fcondtop"],
                converged=jnp.ones(Tsf.shape, bool))
        else:
            from .zerolayer import zerolayer_temperature
            res = zerolayer_temperature(
                dt, rhoa, flw, potT, Qa, shcoef, lhcoef, fswsfc,
                hilyr * ni, hslyr * ns, Tsf, Tbot)
        zqin2 = jnp.full_like(zqin, -c.RHOI * c.LFRESH)
        zqsn2 = jnp.full_like(zqsn, -c.RHOS * c.LFRESH)
        zSin2 = zSin
        converged = res.converged
        solver_fluxes = res
    else:
        # initial temperatures from enthalpies (init_vertical_profile)
        Tmlt = -zSin * c.DEPRESST
        zTin = ice_temperature_from_enthalpy(zqin, Tmlt)
        l_snow = hslyr > c.HS_MIN / ns
        zTsn = jnp.where(l_snow[..., None],
                         jnp.minimum(snow_temperature_from_enthalpy(zqsn),
                                     0.0), 0.0)
        zqsn0 = jnp.where(l_snow[..., None], zqsn,
                          snow_enthalpy_from_temperature(0.0) *
                          jnp.ones_like(zqsn))
        einit = (hilyr[..., None] * zqin).sum(-1) + \
            (hslyr[..., None] * zqsn0).sum(-1)
        pf = prescribed_sfc_fluxes
        res = temperature_changes(
            dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
            fswsfc, fswint, Sswabs, Iswabs,
            hilyr, hslyr, zqin, zTin, zqsn0, zTsn, zSin,
            Tsf, Tbot, einit,
            calc_tsfc=pf is None,
            fsurfn_f=None if pf is None else pf["fsurf"],
            fcondtopn_f=None if pf is None else pf["fcondtop"],
            flatn_f=None if pf is None else pf["flat"],
            fsensn_f=None if pf is None else pf["fsens"])
        zqin2, zqsn2, zSin2 = res.zqin, res.zqsn, zSin
        converged = res.converged
        solver_fluxes = res

    th = thickness_changes(
        dt, hilyr * ni, hslyr * ns, zqin2, zqsn2, zSin2,
        fbot, Tbot, solver_fluxes.flatn, solver_fluxes.fsurfn,
        solver_fluxes.fcondtopn, solver_fluxes.fcondbot, fsnow,
        frain=frain, ktherm=ktherm, sss=sss,
        smice=smice, smliq=smliq, rsnw=rsnw, tun=tun)

    snoice_tot = th.snoice + snoice_flood

    # freshwater and salt fluxes to the ocean from the total thickness
    # change (reference :430-448: dhi = hin - worki,
    # dhs = hsn - works - hsn_new; evapn included)
    dhi = th.hin - hin0
    dhs = th.hsn - hsn0 - th.hsn_new
    freshn = jnp.where(
        has, aicen * (th.evapn - (c.RHOI * dhi + c.RHOS * dhs) / dt),
        0.0)
    fsaltn = jnp.where(
        has, -aicen * c.RHOI * dhi * c.ICE_REF_SALINITY * 1e-3 / dt,
        0.0)
    fhocnn = th.fhocnn + fadvocn

    def m(x, extra=0):
        h = has.reshape(has.shape + (1,) * extra)
        return jnp.where(h, x, 0.0)

    def ml(x, default):
        return jnp.where(has[..., None], x, default) \
            if x is not None else None

    return ThermoVerticalResult(
        Tsf=jnp.where(has, res.Tsf, Tsf),
        hin=m(th.hin), hsn=m(th.hsn),
        zqin=jnp.where(has[..., None], th.zqin, zqin),
        zqsn=jnp.where(has[..., None], th.zqsn, zqsn),
        zSin=jnp.where(has[..., None], th.zSin, zSin),
        fsensn=m(solver_fluxes.fsensn), flatn=m(solver_fluxes.flatn),
        flwoutn=m(solver_fluxes.flwoutn),
        fsurfn=m(solver_fluxes.fsurfn),
        fcondtopn=m(solver_fluxes.fcondtopn),
        fhocnn=m(fhocnn), freshn=freshn, fsaltn=fsaltn,
        evapn=m(th.evapn),
        meltt=m(th.meltt), melts=m(th.melts), meltb=m(th.meltb),
        congel=m(th.congel), snoice=m(snoice_tot),
        converged=converged | ~has,
        dsnow=m(th.dsnow), hsn_new=m(th.hsn_new),
        meltsliq=m(th.meltsliq),
        hpond=(jnp.where(has, hpond_out, hpond)
               if hpond is not None else None),
        smice=ml(th.smice, smice), smliq=ml(th.smliq, smliq),
        rsnw=ml(th.rsnw, rsnw))


def thermo_vertical_noop(aicen, vicen, vsnon, tsfc, zqin, zqsn, zSin
                         ) -> ThermoVerticalResult:
    """Identity ThermoVerticalResult (config_use_column_vertical_
    thermodynamics=false: the timestep skips therm1; state passes
    through unchanged, all tendencies/fluxes zero)."""
    a_ok = aicen > c.PUNY
    safe = jnp.where(a_ok, aicen, 1.0)
    z = jnp.zeros_like(aicen)
    return ThermoVerticalResult(
        Tsf=tsfc,
        hin=jnp.where(a_ok, vicen / safe, 0.0),
        hsn=jnp.where(a_ok, vsnon / safe, 0.0),
        zqin=zqin, zqsn=zqsn, zSin=zSin,
        fsensn=z, flatn=z, flwoutn=z, fsurfn=z, fcondtopn=z,
        fhocnn=z, freshn=z, fsaltn=z, evapn=z,
        meltt=z, melts=z, meltb=z, congel=z, snoice=z,
        converged=jnp.ones_like(aicen, bool), dsnow=z, hsn_new=z,
        meltsliq=z, hpond=None, smice=None, smliq=None, rsnw=None)
