"""Driver entry points (__graft_entry__.py) must stay importable and
executable on the CPU mesh (megakernel phases in interpret mode)."""

import jax
import numpy as np
import pytest


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128, 128, 3)
    assert np.all(np.isfinite(np.asarray(out)))


def test_dryrun_multichip_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import __graft_entry__ as g

    g.dryrun_multichip(8, interpret=True)


def test_dryrun_multichip_2():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    import __graft_entry__ as g

    g.dryrun_multichip(2, interpret=True)
