"""The chip_smoke.py phases as tests, for a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Elsewhere each test skips with its reason (the decision is made inside
the fixture, never while the module is imported)."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def state():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX's default backend here is "
                    f"{jax.default_backend()}")
    return {"device": None}


def test_device_phase(state):
    assert "native" in chip_smoke.phase_device(state)
    assert state["device"]["platform"] == "gpu"


def test_ra_decode_phase(state):
    assert "8/8 hashes" in chip_smoke.phase_ra_decode(state)


def test_ai_decode_phase(state):
    assert "2/2 hashes" in chip_smoke.phase_ai_decode(state)


def test_encode_phase(state):
    assert "byte-identical" in chip_smoke.phase_encode(state)
