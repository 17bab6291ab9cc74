"""Shared fixtures.  NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the single real CPU device; only
repro.launch.dryrun sets up the 512 placeholder devices (in its own
process).

Tiering: heavyweight system / arch-zoo tests are marked ``slow`` and
deselected from a plain ``pytest -q`` (tier-1, fast); run them with
``pytest -m slow`` (or any explicit ``-m`` expression, which disables
the default deselection).
"""

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight system/arch-zoo test; deselected from plain "
        "runs, select with -m slow")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips without one, select with -m gpu")


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m") or config.getoption("-k"):
        return  # explicit -m/-k expression: user controls selection
    if any("::" in a for a in config.invocation_params.args):
        return  # explicit node id: run exactly what was asked for
    skip = pytest.mark.skip(reason="slow — run with `pytest -m slow`")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
