"""repro_torch's cost model and roofline against repro.costs and
repro.roofline: tests/test_costs.py's cases on the port, every cost
function float for float over every SKU and a grid of workloads, and the
roofline's terms, model FLOPs, HLO parsing and report tables on the same
inputs. The port's roofline constants are the H100's; where a result
depends on them, the test sets them to the reference's (the v5e's) first,
and then asks for equal floats."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro.costs.model as jcost
import repro.roofline.analysis as jroof
import repro.roofline.report as jreport
import repro_torch.core.overheads as t_over
import repro_torch.costs.model as tcost
import repro_torch.roofline.analysis as troof
import repro_torch.roofline.report as treport
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.costs.pricing import SKUS as J_SKUS
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.costs.pricing import SKUS

ROOT = Path(__file__).resolve().parents[1]

SYNTHETIC_HLO = """
  %all-reduce.1 = f32[32,256]{1,0} all-reduce(%dot), channel_id=1, replica_groups=[2,4]<=[8], use_global_device_ids=true, to_apply=%add
  %ag = bf16[64,64]{1,0} all-gather(%x), channel_id=2, replica_groups=[4,2]<=[8], dimensions={0}
  %rs = f32[8,8]{1,0} reduce-scatter(%y), channel_id=3, replica_groups=[1,8]<=[8], to_apply=%add
  %cp = f32[16]{0} collective-permute(%z), channel_id=4, source_target_pairs={{0,1}}
  %a2a = (f32[4,4], bf16[2,2]) all-to-all(%w), replica_groups={{0,1,2,3}}
  %ag0 = bf16[64]{0} all-gather-start(%x), channel_id=5, replica_groups=[4,2]<=[8]
  %ag1 = bf16[64]{0} all-gather-done(%ag0)
"""


@pytest.fixture
def reference_rates(monkeypatch):
    """The port's roofline constants set to the reference's."""
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BYTES", jroof.HBM_BYTES)
    monkeypatch.setattr(t_over, "HBM_BYTES_PER_S", jroof.HBM_BW)
    monkeypatch.setattr(t_over, "LINK_BYTES_PER_S", jroof.ICI_BW)


@pytest.fixture
def w7b():
    return tcost.Workload(n_params=6.7e9, batch=1, in_tokens=128,
                          out_tokens=128)


def test_catalog_is_the_reference_catalog():
    assert list(SKUS) == list(J_SKUS)
    for name in SKUS:
        assert dataclasses.asdict(SKUS[name]) == \
            dataclasses.asdict(J_SKUS[name])


class TestCostModelCases:
    """tests/test_costs.py's cases, on the port."""

    def test_cpu_tee_cheaper_at_batch_1(self, w7b):
        cpu = tcost.best_cpu_cost(w7b, "emr-amx-tdx")
        gpu = tcost.usd_per_mtok(w7b, "h100-cc")
        assert gpu / cpu > 1.5

    def test_crossover_exists_and_in_band(self, w7b):
        x = tcost.crossover_batch(w7b, "emr-amx-tdx", "h100-cc",
                                  [1, 2, 4, 8, 16, 32, 64, 128, 256, 512])
        assert x is not None and 16 <= x <= 256

    def test_vcpu_throughput_plateaus(self, w7b):
        w = dataclasses.replace(w7b, batch=64)
        sweep = tcost.vcpu_sweep(w, "emr-amx-tdx", [8, 16, 32, 64])
        gain_8_16 = sweep[16]["tokens_per_s"] / sweep[8]["tokens_per_s"]
        gain_32_64 = sweep[64]["tokens_per_s"] / sweep[32]["tokens_per_s"]
        assert gain_8_16 > gain_32_64

    def test_tee_costs_more_than_plain(self, w7b):
        assert (tcost.usd_per_mtok(w7b, "emr-amx-tdx", 32)
                > tcost.usd_per_mtok(w7b, "emr-amx", 32))
        assert tcost.usd_per_mtok(w7b, "h100-cc") >= \
            tcost.usd_per_mtok(w7b, "h100")

    def test_input_scaling_erodes_cpu_advantage(self, w7b):
        adv = {}
        for s in [128, 4096]:
            w = dataclasses.replace(w7b, batch=4, in_tokens=s)
            adv[s] = (tcost.usd_per_mtok(w, "h100-cc")
                      / tcost.best_cpu_cost(w, "emr-amx-tdx"))
        assert adv[4096] < adv[128] * 1.5

    def test_throughput_monotone_in_batch(self, w7b):
        tps = [tcost.tokens_per_second(dataclasses.replace(w7b, batch=b),
                                       SKUS["h100-cc"]) for b in [1, 8, 64]]
        assert tps[0] < tps[1] < tps[2]

    def test_tpu_rows_present(self, w7b):
        assert tcost.usd_per_mtok(w7b, "v5e-cc") > \
            tcost.usd_per_mtok(w7b, "v5e") > 0


@pytest.mark.parametrize("sku", list(J_SKUS))
def test_cost_functions_match_reference_float_for_float(sku):
    """Every cost function over a grid of workloads (params, batch, input
    length, bytes a param) on one SKU: equal floats."""
    for n_params in (1.1e9, 6.7e9, 70e9):
        for batch in (1, 4, 64, 512):
            for in_tokens in (128, 4096):
                for bpp in (2.0, 1.0):
                    kw = dict(n_params=n_params, batch=batch,
                              in_tokens=in_tokens, out_tokens=128,
                              bytes_per_param=bpp)
                    tw, jw = tcost.Workload(**kw), jcost.Workload(**kw)
                    for vcpus in (None, 8, 64, 96):
                        assert dataclasses.astuple(tcost.step_terms(
                            tw, SKUS[sku], vcpus)) == dataclasses.astuple(
                                jcost.step_terms(jw, J_SKUS[sku], vcpus))
                        assert tcost.tokens_per_second(tw, SKUS[sku], vcpus) \
                            == jcost.tokens_per_second(jw, J_SKUS[sku], vcpus)
                    assert tcost.usd_per_mtok(tw, sku, 16, 64.0) == \
                        jcost.usd_per_mtok(jw, sku, 16, 64.0)
                    if SKUS[sku].kind == "cpu":
                        assert tcost.best_cpu_cost(tw, sku) == \
                            jcost.best_cpu_cost(jw, sku)
                        assert tcost.vcpu_sweep(tw, sku, [4, 32]) == \
                            jcost.vcpu_sweep(jw, sku, [4, 32])
    base = dict(n_params=6.7e9, batch=1, in_tokens=128, out_tokens=128)
    batches = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512]
    for cpu in ("emr-amx", "emr-amx-tdx", "spr-amx"):
        assert tcost.crossover_batch(tcost.Workload(**base), cpu, sku,
                                     batches) == \
            jcost.crossover_batch(jcost.Workload(**base), cpu, sku, batches)


def test_port_constants_are_the_h100s():
    assert troof.PEAK_FLOPS == 989e12
    assert troof.HBM_BYTES == 80 * 10**9
    cell = troof.CellRoofline(
        arch="a", shape="s", mesh="1", n_chips=1, flops_per_dev=1e12,
        bytes_per_dev=1e9, collective_bytes_per_dev=1e8,
        collective_breakdown={}, arg_bytes=10**9, temp_bytes=0, out_bytes=0,
        model_flops=1e12)
    assert cell.memory_s == 1e9 / t_over.HBM_BYTES_PER_S
    assert cell.collective_s == 1e8 / t_over.LINK_BYTES_PER_S


@pytest.mark.parametrize("kw", [
    {}, dict(temp_bytes=17 * 1024**3), dict(flops_per_dev=1e9,
                                            bytes_per_dev=2e9),
    dict(collective_bytes_per_dev=1e12, collective_breakdown={"ag": 1e12}),
    dict(flops_per_dev=0.0, bytes_per_dev=0.0, collective_bytes_per_dev=0.0),
    dict(n_chips=1, out_bytes=5 * 10**9)],
    ids=["base", "spills", "decode", "collective", "zero", "one-chip"])
def test_cell_roofline_matches_reference(reference_rates, kw):
    base = dict(arch="a", shape="s", mesh="16x16", n_chips=256,
                flops_per_dev=1e12, bytes_per_dev=1e9,
                collective_bytes_per_dev=1e8, collective_breakdown={},
                arg_bytes=10**9, temp_bytes=10**9, out_bytes=0,
                model_flops=2e14)
    base.update(kw)
    t, j = troof.CellRoofline(**base), jroof.CellRoofline(**base)
    assert t.to_dict() == j.to_dict()
    assert dataclasses.astuple(t.terms) == dataclasses.astuple(j.terms)
    assert t.bound == j.bound


@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert list(SHAPES) == list(J_SHAPES)
    for name in SHAPES:
        assert troof.model_flops_for(cfg, SHAPES[name]) == \
            jroof.model_flops_for(jcfg, J_SHAPES[name])
    if cfg.family == "encdec":
        assert troof._encdec_split(cfg) == jroof._encdec_split(jcfg)


def test_hlo_parsing_matches_reference():
    for shape in ("f32[32,256]", "bf16[8,128]", "(f32[4,4], bf16[2,2])",
                  "pred[16]", "c128[2]", "u8[]", "token[]"):
        assert troof._shape_bytes(shape) == jroof._shape_bytes(shape)
    got = troof.parse_collectives(SYNTHETIC_HLO)
    want = jroof.parse_collectives(SYNTHETIC_HLO)
    assert [dataclasses.asdict(o) for o in got] == \
        [dataclasses.asdict(o) for o in want]
    assert len(got) == 6


def test_report_tables_match_reference(reference_rates, tmp_path):
    cells = [jroof.CellRoofline(
        arch=a, shape=s, mesh="16x16", n_chips=256, flops_per_dev=f,
        bytes_per_dev=b, collective_bytes_per_dev=c, collective_breakdown={},
        arg_bytes=10**9, temp_bytes=3 * 10**9, out_bytes=0,
        model_flops=2e14).to_dict()
        for a, s, f, b, c in [("llama2-7b", "train_4k", 1e12, 1e9, 1e8),
                              ("rwkv6-3b", "decode_32k", 1e9, 4e9, 0.0)]]
    cells[1]["bw_fraction"] = 0.0     # the table's fallback recomputes it
    cells.append({"arch": "whisper-small", "shape": "long_500k",
                  "skipped": True, "reason": "quadratic attention"})
    path = tmp_path / "results.json"
    path.write_text(json.dumps(cells))
    assert treport.table(str(path)) == jreport.table(str(path))
    perf = tmp_path / "perf_results.json"
    perf.write_text(json.dumps([dict(c, variant="chunk512")
                                for c in cells[:2]]))
    assert treport.perf_table(str(perf)) == jreport.perf_table(str(perf))
    assert treport.fmt_bytes(3.5 * 2**30) == jreport.fmt_bytes(3.5 * 2**30)


@pytest.mark.parametrize("args", [[], ["--params", "70e9", "--batch", "64",
                                       "--in-tokens", "2048"]],
                         ids=["defaults", "70b"])
def test_cost_planner_prints_reference_lines(args):
    def run(script):
        return subprocess.run(
            [sys.executable, str(ROOT / "examples" / script), *args],
            capture_output=True, text=True, check=True,
            env={"PYTHONPATH": str(ROOT / "src")}).stdout
    assert run("torch_cost_planner.py") == run("cost_planner.py")
