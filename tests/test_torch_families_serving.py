"""repro_torch's engine over the model families against repro.runtime, on
the smoke configs with the port's weights converted 1:1 from the
reference's: the canonical scenario (tests/conftest.py, sampled) replays on
every backend the reference runs for each family, and on the store and
two-phase modes, with the same tokens, stats, channel counters, audit and
page tables; on the families without MoE every request also equals its
solo run. jamba's rows are in tests/test_torch_families_serving_hybrid.py
(a file of its own, so the two halves run on two workers);
tests/test_torch_families_sealing.py holds the refusals, the sealed names
and blobs, the pause freeze, the fleet and the launcher."""


import jax
import numpy as np
import pytest

from conftest import CANONICAL_ENGINE, canonical_requests
from repro.configs import smoke_config
from repro.models import build_model as jbuild
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from test_torch_sampled_serving import (Side, _canonical, _spec_gen,
                                        assert_same_run)

CONFIGS = {
    "slot": dict(kv_backend="slot"),
    "paged": dict(kv_backend="paged", page_size=8),
    "paged-sharing": dict(kv_backend="paged", page_size=8,
                          prefix_sharing=True),
    "paged-kernel": dict(kv_backend="paged", page_size=8, kv_decode="kernel"),
    "paged-store": dict(kv_backend="paged", page_size=8, prefix_sharing=True,
                        page_store=True),
    "paged-2plan": dict(kv_backend="paged", page_size=8,
                        prefill_plan="dedicated"),
}
# what the reference runs for each family but jamba (a MoE or MLA model has
# no kernel decode; rwkv6 has no length leaf to page)
SERVED = ([(a, c) for a in ("chameleon-34b", "dbrx-132b", "deepseek-v3-671b")
           for c in ("slot", "paged", "paged-sharing")]
          + [("chameleon-34b", "paged-kernel"), ("rwkv6-3b", "slot")])
# families without MoE: a request's tokens are a function of its own prompt
SOLO_EQUAL = ("chameleon-34b", "rwkv6-3b")

_MODELS = {}


def _models(arch):
    """(reference model, params, port model, converted params) per family,
    built once for the module."""
    if arch not in _MODELS:
        jm = jbuild(smoke_config(arch))
        jp = jm.init_params(jax.random.key(0))
        tm = tbuild(tsmoke(arch), device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def _solo(arch):
    """Each canonical request served alone on a port slot engine, once per
    family for the module."""
    if ("solo", arch) not in _MODELS:
        port = Side(True, _models(arch))
        eng = port.engine(**CANONICAL_ENGINE)
        low, high = canonical_requests()
        _MODELS["solo", arch] = [eng.generate(_spec_gen(port, s)).tokens
                                 for s in low + high]
    return _MODELS["solo", arch]


@pytest.mark.parametrize("arch,config", SERVED,
                         ids=[f"{a}-{c}" for a, c in SERVED])
def test_canonical_scenario_matches_reference(arch, config):
    kw = CONFIGS[config]
    t = _canonical(Side(True, _models(arch)), **kw)
    assert_same_run(_canonical(Side(False, _models(arch)), **kw), t)
    if arch in SOLO_EQUAL:
        assert [list(r.output) for r in t[0]] == _solo(arch)
