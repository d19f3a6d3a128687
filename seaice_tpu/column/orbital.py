"""Solar zenith angle for the radiation schemes.

JAX stand-in for the reference's orbital machinery
(`ice_orbital.F90` wrapping shr_orb_mod: Berger 1978 orbital
parameters -> declination + eccentricity factor -> cosine zenith,
used by compute_coszen for the dEdd shortwave). Here the declination
and Earth-sun distance factor come from the Spencer (1971) Fourier
series — within ~0.01 rad of the Berger series for the modern epoch —
so the whole computation is a handful of trig ops, jit/vmap friendly.
"""

from __future__ import annotations

import jax.numpy as jnp

SECONDS_PER_DAY = 86400.0


def solar_declination(day_of_year):
    """Solar declination delta (radians) and inverse-square distance
    factor (Spencer 1971)."""
    g = 2.0 * jnp.pi * (day_of_year - 1.0) / 365.0
    decl = (0.006918 - 0.399912 * jnp.cos(g) + 0.070257 * jnp.sin(g)
            - 0.006758 * jnp.cos(2 * g) + 0.000907 * jnp.sin(2 * g)
            - 0.002697 * jnp.cos(3 * g) + 0.001480 * jnp.sin(3 * g))
    eccf = (1.000110 + 0.034221 * jnp.cos(g) + 0.001280 * jnp.sin(g)
            + 0.000719 * jnp.cos(2 * g) + 0.000077 * jnp.sin(2 * g))
    return decl, eccf


def compute_coszen(lat, lon, day_of_year, seconds_today):
    """Cosine of the solar zenith angle, clipped at 0 (night), as the
    dEdd shortwave expects (reference compute_coszen,
    ice_orbital.F90 / shr_orb_decl use in mpas_seaice_column.F).

    lat/lon radians (arrays ok); day_of_year 1-based; seconds_today
    UTC seconds since midnight. Returns (coszen, eccentricity_factor).
    """
    decl, eccf = solar_declination(day_of_year)
    hour_angle = (2.0 * jnp.pi * seconds_today / SECONDS_PER_DAY -
                  jnp.pi) + lon
    cosz = (jnp.sin(lat) * jnp.sin(decl) +
            jnp.cos(lat) * jnp.cos(decl) * jnp.cos(hour_angle))
    return jnp.maximum(cosz, 0.0), eccf
