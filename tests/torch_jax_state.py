"""Isolation of the JAX reference from state an earlier test left.

``repro.launch.steps`` installs a module-global activation constrainer
(``repro.models.common.set_constrainer``) and nothing resets it, so a
JAX test that builds a plan leaves one behind in its worker; the JAX
RWKV6 and SSM layers then put sharding constraints on a 1 x 1 mesh's
Explicit axes and raise. A port test file that runs the JAX models
imports ``no_jax_constrainer``, an autouse fixture that runs each test
without it and restores it after.
"""
import pytest

from repro.models import common as j_common


@pytest.fixture(autouse=True)
def no_jax_constrainer():
    saved = j_common._CONSTRAINER
    j_common.set_constrainer(None)
    yield
    j_common.set_constrainer(saved)
