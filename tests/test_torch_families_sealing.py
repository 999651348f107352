"""repro_torch's engine over the model families against repro.runtime
(the smoke configs, the port's weights converted 1:1 from the
reference's), beside tests/test_torch_families_serving.py: where the
reference refuses (the paged backend on a model with nothing to page,
kernel decode on anything but one uniform attn+swiglu block) the port
refuses with the same message; sealed names and headers equal the
reference's; a Mamba state row and an MLA page sealed by either package
unseal in the other; a paused jamba row's recurrent state stays frozen bit
for bit while its mate steps; a fleet kill on jamba equals the
reference's; and the launcher prints the reference's report lines for
each decoder family and refuses the encoder-decoder as it does."""

import re
import sys

import numpy as np
import pytest
import torch

from conftest import CANONICAL_ENGINE, canonical_requests
from repro.core import sealing as jsealing
from repro.launch import serve as jserve
from repro_torch.core import sealing as tsealing
from repro_torch.launch import serve as tserve
from test_torch_engine import _report
from test_torch_families_serving import CONFIGS, _models
from test_torch_fleet import Pkg, _assert_same_fleet_run, _kill_run
from test_torch_sampled_serving import Side, _spec_gen
from test_torch_sealing import to_jax_blob, to_torch_blob

RAISES = [("rwkv6-3b", "paged"), ("rwkv6-3b", "paged-kernel"),
          ("dbrx-132b", "paged-kernel"), ("deepseek-v3-671b", "paged-kernel"),
          ("jamba-v0.1-52b", "paged-kernel")]


@pytest.mark.parametrize("arch,config", RAISES,
                         ids=[f"{a}-{c}" for a, c in RAISES])
def test_reference_value_errors(arch, config):
    """The port refuses what the reference refuses, with its message."""
    errors = []
    for port in (True, False):
        with pytest.raises(ValueError) as e:
            Side(port, _models(arch)).engine(**CANONICAL_ENGINE,
                                             **CONFIGS[config])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert ("no sequence-length KV leaves" in errors[0]
            or "supports the dense attention family only" in errors[0])


SEALED = [("jamba-v0.1-52b", "paged"), ("deepseek-v3-671b", "paged"),
          ("rwkv6-3b", "slot"), ("jamba-v0.1-52b", "slot"),
          ("chameleon-34b", "paged-kernel")]


def _sealed_after_steps(side, config, steps=3):
    eng = side.engine(**CANONICAL_ENGINE, **CONFIGS[config])
    low, _ = canonical_requests()
    eng.submit(_spec_gen(side, low[4]))
    for _ in range(steps):
        eng.step()
    sealed, _ = eng.seal_slot(0)
    return eng, sealed


@pytest.mark.parametrize("arch,config", SEALED,
                         ids=[f"{a}-{c}" for a, c in SEALED])
def test_sealed_names_equal_reference(arch, config):
    """A preempted slot seals under the reference's names, shapes and
    dtypes: pages of the length leaves, and the slot's [L, 1, ...] row of
    each recurrent-state leaf."""
    _, t = _sealed_after_steps(Side(True, _models(arch)), config)
    _, j = _sealed_after_steps(Side(False, _models(arch)), config)
    assert sorted(t) == sorted(j)
    for name in t:
        assert t[name].header() == j[name].header(), name
    if arch == "jamba-v0.1-52b" and config == "paged":
        assert "kvslot/0/0['groups']['slot_0']['ssm']" in t
        assert t["kvslot/0/0['groups']['slot_0']['ssm']"].dtype == "float32"


def _raw(x) -> np.ndarray:
    """A tensor's or array's bytes."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("arch,leaf", [
    ("jamba-v0.1-52b", "['groups']['slot_3']['ssm']"),
    ("jamba-v0.1-52b", "['groups']['slot_3']['conv']"),
    ("deepseek-v3-671b", "['moe_layers']['slot_0']['ckv']/p1"),
], ids=["jamba-ssm-row", "jamba-conv-row", "deepseek-ckv-page"])
def test_blobs_unseal_across_packages(arch, leaf):
    """A recurrent-state row and an MLA page, sealed by either package,
    unseal in the other to the sealing package's own plaintext."""
    teng, t = _sealed_after_steps(Side(True, _models(arch)), "paged")
    jeng, j = _sealed_after_steps(Side(False, _models(arch)), "paged")
    name = f"kvslot/0/0{leaf}"
    tkey, jkey = teng.td.sealing_key, jeng.td.sealing_key
    assert (tkey.key, tkey.mac_key) == (jkey.key, jkey.mac_key)
    mine = tsealing.unseal_tensor(tkey, t[name])
    assert np.array_equal(
        _raw(jsealing.unseal_tensor(jkey, to_jax_blob(t[name]))), _raw(mine))
    theirs = jsealing.unseal_tensor(jkey, j[name])
    assert np.array_equal(
        _raw(tsealing.unseal_tensor(tkey, to_torch_blob(j[name]))),
        _raw(theirs))


def test_hybrid_pause_freezes_recurrent_state():
    """tests/test_paged_kv.py's hybrid case on the port: a decode step that
    a paused slot sits out (write_slots excludes it) leaves its
    recurrent-state rows bit-identical while the stepping mate's move, and
    both requests then finish with the reference's tokens."""
    outs = []
    for port in (True, False):
        side = Side(port, _models("jamba-v0.1-52b"))
        eng = side.engine(kv_backend="paged", page_size=8)
        low = eng.submit(side.gen(np.arange(1, 9), max_new_tokens=10))
        mate = eng.submit(side.gen(np.full(8, 3), max_new_tokens=10))
        for _ in range(3):
            eng.step()
        if port:
            dense = eng.kv._dense
            assert dense, "a hybrid model has recurrent-state leaves"
            before = {k: v[:, 0].clone() for k, v in dense.items()}
            mate_before = {k: v[:, 1].clone() for k, v in dense.items()}
            eng.kv.decode(eng.params, eng._last_token, None, 0,
                          write_slots=[1])
            for k, v in dense.items():
                assert torch.equal(v[:, 0], before[k]), k
            assert any(not torch.equal(v[:, 1], mate_before[k])
                       for k, v in dense.items())
        else:
            eng.kv.decode(eng.params, eng._last_token, None, 0,
                          write_slots=[1])
        eng.run()
        assert low.finished and mate.finished
        outs.append((list(low.output), list(mate.output)))
    assert outs[0] == outs[1]


def test_fleet_kill_on_jamba_matches_reference_kill_run():
    """A worker dies mid-decode on the hybrid model: its migrants' sealed
    pages and Mamba state rows restore on the survivor, and the run equals
    the reference's kill run (tokens, FleetStats, channel totals, the
    migrate audit lines)."""
    models = _models("jamba-v0.1-52b")
    t = _kill_run(Pkg(True, models))
    j = _kill_run(Pkg(False, models))
    _assert_same_fleet_run(t, j)
    assert t[1].stats.migrations > 0


LAUNCH = ["chameleon-34b", "dbrx-132b", "deepseek-v3-671b", "jamba-v0.1-52b",
          "rwkv6-3b"]


@pytest.mark.parametrize("arch", LAUNCH)
def test_launcher_serves_each_decoder_family(arch, monkeypatch):
    """``serve.py --arch <family> --smoke`` prints the reference launcher's
    report lines, with equal counts and boundary traffic (the weights are
    each package's own random ones, so tokens differ)."""
    backend = ["--kv-backend", "slot" if arch == "rwkv6-3b" else "paged",
               "--page-size", "8"]
    argv = ["--arch", arch, "--smoke", "--requests", "3",
            "--max-new-tokens", "4", "--slots", "2"] + backend
    jlines = _report(jserve.main, argv, monkeypatch)
    tlines = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    label = re.compile(r"^[^0-9(]*")
    assert [label.match(l).group(0) for l in tlines] == \
        [label.match(l).group(0) for l in jlines]
    for prefix in ("boundary:", "frame coalescing:"):
        assert [l for l in tlines if l.startswith(prefix)] == \
            [l for l in jlines if l.startswith(prefix)]
    assert [l.split(" in ")[0] for l in tlines if l.startswith("served")] == \
        ["served 3 requests / 12 tokens"]


def test_launcher_refuses_the_encoder_decoder(monkeypatch):
    for main, extra in ((jserve.main, []),
                        (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper-small",
                                          "--smoke"] + extra)
        with pytest.raises(SystemExit, match="decoder-family"):
            main()
