"""The client loop driven end to end at a smoke size on the CPU through
the test-only entry (``runner.run_cell`` with ``device="cpu"``), the
faults it must catch, and the run command's refusal without a card."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from teebench import runner

import smoke

HERE = Path(__file__).resolve().parents[1]


def _run(seed, traced=False, fault=None, device="cpu", mix=None,
         control=False, **changes):
    bench, cell, cfg, mix = smoke.setup(mix, **changes)
    return runner.run_cell(bench, "smoke", seed,
                           smoke.window_s(traced=traced), traced,
                           device=device,
                           t_process0=time.perf_counter(), cell=cell,
                           cfg=cfg, mix=mix, model_cfg=smoke.model_cfg(),
                           fault=fault, control=control)


def test_a_run_serves_and_checks():
    res = _run(2 ** 33 + 5)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 5
    assert set(res["metrics"]) == {"setup_s", "output_tok_s", "ttft_p90_ms",
                                   "itl_p95_ms"}
    assert res["metrics"]["output_tok_s"]["value"] > 0
    assert list(res)[-2:] == ["checks", "_info"]
    assert res["_info"]["check"]["tokens_compared"] >= 20


@pytest.mark.parametrize("fault", ["token", "kv_state"])
def test_a_broken_timed_path_is_not_correct(fault):
    res = _run(41, fault=fault)
    assert res["correct"] is False
    assert res["checks"]["max_logit_gap"]["value"] > 1e-3


def test_the_control_through_the_check_is_not_correct():
    """The fp8 control judged in the served tokens' place, on the same
    run's sample, fails the limit the program's own tokens meet."""
    res = _run(2 ** 34 + 3, control=True)
    cmp = res["_info"]["check"]
    assert cmp["max_logit_gap"] <= 1e-3
    assert res["correct"] is False
    assert res["checks"]["max_logit_gap"]["value"] == \
        cmp["control_max_logit_gap"] > 1e-3


def test_a_closed_loop_run():
    res = _run(9, mix={"arrival": "closed", "coalesce": 4},
               arrivals={"clients": 4, "requests_per_client": 6})
    assert res["correct"] is True


def test_a_traced_run_reports_per_layer_metrics():
    res = _run(13, traced=True)
    assert res["correct"] is True
    # the port's spans over the traced stretch reach their readers
    assert {"weights_seal_s", "decode_step_ms.chat", "prefill_ms.chat",
            "decode_launch_ms.chat"} <= set(res["metrics"])
    assert "breakdown" in res and res["device"]["window_s"] > 0


@pytest.mark.parametrize("decode,held", [("kernel", True),
                                          ("gather", False)])
def test_b3_launches_are_held_on_the_kernel_path_only(decode, held):
    cmp = {"max_logit_gap": 0.0, "tokens_compared": 30,
           "requests_compared": 4}
    chk = smoke.CELL["check"]
    checks = runner.judge(cmp, chk, 0, 0, decode=decode)
    assert ("b3_launches" in checks) is held
    assert all(c["ok"] for c in checks.values()) is not held
    assert "b3_launches" not in runner.judge(cmp, chk, 0, None, decode=decode)


def test_the_run_command_needs_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "ds7b-chat", "--seed", str(2 ** 35), "--seconds",
                        "1"], capture_output=True, text=True, env=env,
                       timeout=120, cwd=tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_no_result_once_the_jax_package_is_loaded(monkeypatch, capsys):
    """A module of JAX or the JAX package that arrives after the window (a
    reader's or the check's import) still stops the result."""
    sys.path.insert(0, str(HERE))
    import run

    def late_import(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "repro.core", sys)
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(runner, "run_cell", late_import)
    assert run.main(["--workload", "ds7b-chat", "--seed", "1",
                     "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "repro.core" in out.err


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_the_smoke_cell_on_the_card(card):
    """The kernel decode path (B3) at a smoke size on the card."""
    res = _run(17, device="cuda:0")
    assert res["correct"] is True and res["checks"]["b3_launches"]["value"]
    json.dumps({k: v for k, v in res.items() if k != "_info"})
