"""repro_torch's engine on jamba (hybrid: Mamba + attention + MoE) against
repro.runtime: the canonical scenario (tests/conftest.py, sampled) on every
backend the reference runs for it (slot, paged, paged with sharing), and on
the store and two-phase modes, whose leaf handling is generic, with the
same tokens, stats, channel counters, audit and page tables. The other
families' rows are in tests/test_torch_families_serving.py."""

import pytest

from test_torch_families_serving import CONFIGS, _models
from test_torch_sampled_serving import Side, _canonical, assert_same_run

ARCH = "jamba-v0.1-52b"
SERVED = ("slot", "paged", "paged-sharing", "paged-store", "paged-2plan")


@pytest.mark.parametrize("arch,config", [(ARCH, c) for c in SERVED],
                         ids=[f"{ARCH}-{c}" for c in SERVED])
def test_canonical_scenario_matches_reference(arch, config):
    kw = CONFIGS[config]
    t = _canonical(Side(True, _models(arch)), **kw)
    assert_same_run(_canonical(Side(False, _models(arch)), **kw), t)
