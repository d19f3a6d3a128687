"""Pinned-output regression test.

The analog of the reference's regression.py (dev checkout vs base
checkout, bitwise restart comparison): the 12-hour box-test trajectory
and a 3-step full-physics sphere trajectory are pinned in
tests/data_regression_{box,sphere}.npz; any numerics change that alters
the solution beyond tight tolerances must consciously regenerate the
baselines (seaice_tpu/testcases/pinned.py says how).  `chip_smoke.py`
replays the same trajectories on the card.
"""

import numpy as np

from seaice_tpu.testcases import pinned


def _compare(name, got):
    ref = pinned.pinned(name)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-10,
                                   atol=1e-12, err_msg=key)


def test_box_12h_regression():
    _compare("box", pinned.box_12h())


def test_box_50min_regression():
    """The well-conditioned prefix of the box run, which the card is
    held to (pinned.py says why the 12 h end state cannot be)."""
    _compare("box_50min", pinned.box_50min())


def test_sphere_full_physics_regression():
    """Guards the spherical kernels, the panel layout, and the mesh
    generator against silent numerics drift."""
    _compare("sphere", pinned.sphere_full_physics())
