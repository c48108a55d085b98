"""The port's public API holds the JAX package's: the top-level names and
the state's shape properties."""

import pytest

import pic1dp_tpu
import pic1dp_tpu.config as jcfg
import pic1dp_tpu_torch
import pic1dp_tpu_torch.config as tcfg
from _torch_port import CASES, WIDE_CASES, to_port
from pic1dp_tpu.core.state import SimState as JaxSimState
from pic1dp_tpu_torch.core.state import SimState


def test_every_name_of_the_jax_package_is_exported():
    missing = set(pic1dp_tpu.__all__) - set(pic1dp_tpu_torch.__all__)
    assert not missing, sorted(missing)
    for name in pic1dp_tpu.__all__:
        assert getattr(pic1dp_tpu_torch, name) is not None
    assert pic1dp_tpu_torch.SpeciesConfig is tcfg.SpeciesConfig
    assert pic1dp_tpu_torch.MarkerLoading is tcfg.MarkerLoading
    assert pic1dp_tpu_torch.ParticleShape is tcfg.ParticleShape


@pytest.mark.parametrize("name", ["bot_nonlinear_deltaf", "two_species_maxwellian",
                                  "landau_9_species"])
def test_state_shape_properties_match_the_jax_state(name):
    cases = {**CASES, **WIDE_CASES}
    jstate = JaxSimState.zeros(cases[name](jcfg, "float64"))
    state = SimState.zeros(cases[name](tcfg, "float64"), "cpu")
    assert (state.nspecies, state.nparticle_max) == (jstate.nspecies, jstate.nparticle_max)
    moved = to_port(jstate)
    assert (moved.nspecies, moved.nparticle_max) == (jstate.nspecies, jstate.nparticle_max)
    assert state.nspecies == cases[name](tcfg, "float64").nspecies
