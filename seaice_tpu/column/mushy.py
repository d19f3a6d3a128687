"""Mushy-layer thermodynamic relations (ktherm=2 foundation).

JAX re-design of `ice_mushy_physics.F90` (the reference default
thermodynamics, config_thermodynamics_type='mushy'): the liquidus
relation (two-branch rational fit with break at Tb=-7.636 C /
Sb=123.667 ppt), liquid fraction, mush enthalpy/temperature inversions,
and conductivity. All functions are elementwise jnp over arbitrary
batch shapes. The full mushy vertical solver (Newton temperature solve
with brine drainage; `ice_therm_mushy.F90`) builds on these and is
tracked for round 2 — BL99 (ktherm=1) is the operational solver in
round 1.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import constants as c

# two-branch liquidus coefficients (reference ice_mushy_physics.F90:25-115)
AZ1 = -18.48
BZ1 = 0.0
AZ2 = -10.3085
BZ2 = 62.4
TB = -7.6362968855167352      # liquidus break temperature (C)
SB = 123.66702800276086       # liquidus break salinity (ppt)
AZ1P = AZ1 / 1000.0
BZ1P = BZ1 / 1000.0
AZ2P = AZ2 / 1000.0
BZ2P = BZ2 / 1000.0

J1 = BZ1 / AZ1
K1 = 1.0 / 1000.0
L1 = (1.0 + BZ1P) / AZ1
J2 = BZ2 / AZ2
K2 = 1.0 / 1000.0
L2 = (1.0 + BZ2P) / AZ2

M1, N1, O1 = AZ1, -AZ1P, -BZ1 / AZ1
M2, N2, O2 = AZ2, -AZ2P, -BZ2 / AZ2

_CW = c.CP_OCN * c.RHOW
_CI = c.CP_ICE * c.RHOI
_LI = c.LFRESH * c.RHOI

AS1 = AZ1P * (_CW - _CI)
AC1 = _CI * AZ1
BS1 = (1.0 + BZ1P) * (_CW - _CI) + _LI * AZ1P
BQ1 = -AZ1
BC1 = _CI * BZ1 - _LI * AZ1
CS1 = _LI * (1.0 + BZ1P)
CQ1 = -BZ1
CC1 = -_LI * BZ1

AS2 = AZ2P * (_CW - _CI)
AC2 = _CI * AZ2
BS2 = (1.0 + BZ2P) * (_CW - _CI) + _LI * AZ2P
BQ2 = -AZ2
BC2 = _CI * BZ2 - _LI * AZ2
CS2 = _LI * (1.0 + BZ2P)
CQ2 = -BZ2
CC2 = -_LI * BZ2

D_LIQ = ((1.0 + AZ1P * TB + BZ1P) / (AZ1 * TB + BZ1)) * \
    ((_CW - _CI) * TB + _LI)
E_LIQ = _CI * TB - _LI
F1 = (-1000.0 * _CW) / AZ1
G1 = -1000.0
H1 = (-BZ1 * _CW) / AZ1
F2 = (-1000.0 * _CW) / AZ2
G2 = -1000.0
H2 = (-BZ2 * _CW) / AZ2
I_LIQ = 1.0 / _CW

KI_MUSH = 2.3        # fresh ice conductivity (W/m/K)
KB_MUSH = 0.5375     # brine conductivity


def liquidus_brine_salinity(zTin):
    """Equilibrium brine salinity S_br(T) (reference :237-260)."""
    t_high = zTin > TB
    s1 = (zTin + J1) / (K1 * zTin + L1)
    s2 = (zTin + J2) / (K2 * zTin + L2)
    s = jnp.where(t_high, s1, s2)
    return jnp.where(zTin <= 0.0, s, 0.0)


def liquidus_temperature(Sbr):
    """Equilibrium temperature T(S_br) (reference :264-283)."""
    t_high = Sbr <= SB
    t1 = Sbr / (M1 + N1 * Sbr) + O1
    t2 = Sbr / (M2 + N2 * Sbr) + O2
    return jnp.where(t_high, t1, t2)


def liquid_fraction(zTin, zSin):
    """phi = S / max(S_br(T), S) (reference :liquid_fraction)."""
    sbr = jnp.maximum(liquidus_brine_salinity(zTin), c.PUNY)
    return zSin / jnp.maximum(sbr, zSin)


def enthalpy_mush(zTin, zSin):
    """q(T, S) for mushy ice (reference :287-306)."""
    phi = liquid_fraction(zTin, zSin)
    return phi * (_CW - _CI) * zTin + _CI * zTin - \
        (1.0 - phi) * _LI


def enthalpy_of_melting(zSin):
    """Enthalpy at which the mush is fully melted (reference)."""
    return _CW * liquidus_temperature(zSin)


def enthalpy_brine(zTin):
    return _CW * zTin


def temperature_mush(zqin, zSin):
    """Invert q(T, S): quadratic per liquidus branch with fully-melted
    short-circuit (reference :temperature_mush)."""
    s_low = zSin < SB
    q0 = jnp.where(s_low, F1 * zSin / (G1 + zSin) + H1,
                   F2 * zSin / (G2 + zSin) + H2)
    q_melt = zqin > q0
    qb = D_LIQ * zSin + E_LIQ
    t_high = zqin > qb
    A = jnp.where(t_high, AS1 * zSin + AC1, AS2 * zSin + AC2)
    B = jnp.where(t_high, BS1 * zSin + BQ1 * zqin + BC1,
                  BS2 * zSin + BQ2 * zqin + BC2)
    C = jnp.where(t_high, CS1 * zSin + CQ1 * zqin + CC1,
                  CS2 * zSin + CQ2 * zqin + CC2)
    t = (-B + jnp.sqrt(jnp.maximum(B * B - 4.0 * A * C, c.PUNY))) / \
        (2.0 * A)
    return jnp.where(q_melt, zqin * I_LIQ, t)


def density_brine(Sbr):
    return 1000.3 + 0.78237 * Sbr + 2.8008e-4 * Sbr ** 2


def conductivity_mush(zqin, zSin):
    """phi-weighted conductivity (reference heat_conductivity via
    conductivity_mush_array)."""
    T = temperature_mush(zqin, zSin)
    phi = liquid_fraction(T, zSin)
    return KI_MUSH * c.RHOI / 917.0 * (1.0 - phi) + KB_MUSH * phi


def enthalpy_mush_liquid_fraction(zTin, phi):
    """Mush enthalpy from temperature and a FIXED liquid fraction
    (reference enthalpy_mush_liquid_fraction,
    ice_mushy_physics.F90:310-324) — the form consistent with the
    frozen-phi Picard heat matrix."""
    return phi * (_CW - _CI) * zTin + _CI * zTin - \
        (1.0 - phi) * _LI
