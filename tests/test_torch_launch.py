"""The port's launchers on the CPU: ``launch/analytic.py`` against the
reference's, and ``python -m repro_torch.launch.serve --device cpu``.

The analytic models are pure arithmetic on the config, so they are held
exactly equal to the reference's for every token-family config of the
registry (FULL and REDUCED) and each shape of ``SHAPES``, with each
config's own ``remat`` (five FULL configs set ``"block"``: a train step
counts the forward once more).
GNN configs have no block roles: the port's model raises on them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES, get_config as ref_config
from repro.launch import analytic as ref_analytic
from repro_torch.configs.base import SHAPES, ShapeSpec, get_config, list_configs
from repro_torch.kernels import build
from repro_torch.launch import analytic, serve
from repro_torch.models.api import model_init
from repro_torch.serve.engine import ServeEngine

LM_ARCHS = [a for a in list_configs() if get_config(a).family != "gnn"]
GNN_ARCHS = [a for a in list_configs() if get_config(a).family == "gnn"]


def test_shapes_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_analytic_report_equals_the_references(arch, reduced):
    pcfg = get_config(arch, reduced=reduced)
    rcfg = ref_config(arch, reduced=reduced)
    assert pcfg.remat == rcfg.remat
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        for chips in (1, 4):
            got = analytic.analytic_report(pcfg, shape, chips)
            assert got == ref_analytic.analytic_report(rcfg, ref_shape, chips), (name, chips)
        assert analytic.step_flops(pcfg, shape) == ref_analytic.step_flops(rcfg, ref_shape)


def test_analytic_train_step_counts_the_ssd_term():
    """At Mamba2-370M's training cell (B 4 x 2,048) the step counts 3x the
    forward, whose SSD terms (C Bᵀ and the weighted Xdt over a chunk of 256)
    6·N·D leaves out: the analytic step is above 6·N·D by at least them."""
    cfg = get_config("mamba2-370m")
    shape = ShapeSpec("train_cell", 2048, 4, "train")
    t = 4 * 2048
    ssd = 2 * t * cfg.ssm_chunk * (cfg.ssm_state + cfg.ssm_heads * cfg.ssm_headdim)
    assert analytic.step_flops(cfg, shape) >= analytic.model_flops(cfg, shape) + 3 * ssd * 48 * 0.9
    assert analytic.model_flops(cfg, shape) == 6.0 * cfg.param_count() * t


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_analytic_refuses_gnn_configs(arch):
    with pytest.raises(ValueError, match="not a token family"):
        analytic.step_flops(get_config(arch), SHAPES["train_4k"])


# ------------------------------------------------------------------ serve
def test_serve_lm_on_cpu_is_the_engines_generate(capsys):
    out = serve.main(["--arch", "smollm-360m", "--device", "cpu", "--tokens", "6",
                      "--batch", "2", "--prompt-len", "10"])
    text = capsys.readouterr().out
    assert "arch=smollm-360m batch=2 new_tokens=6" in text and "(cpu, reduced cfg)" in text
    cfg = get_config("smollm-360m", reduced=True)
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 10), generator=torch.Generator().manual_seed(1))
    want = ServeEngine(cfg, params, max_len=16, device="cpu").generate(prompts, max_new_tokens=6)
    assert torch.equal(out["tokens"], want)


def test_serve_ssm_on_cpu_runs_the_ssd_plain_version(capsys):
    build.reset_launch_counts()
    out = serve.main(["--arch", "mamba2-370m", "--device", "cpu", "--tokens", "3", "--batch", "2"])
    assert tuple(out["tokens"].shape) == (2, 16 + 3)
    assert build.launch_counts() == {}
    assert "arch=mamba2-370m" in capsys.readouterr().out


def test_serve_gnn_on_cpu_plans_once_per_structure(capsys):
    out = serve.main(["--arch", "ample-gcn", "--device", "cpu", "--nodes", "400",
                      "--requests", "3"])
    text = capsys.readouterr().out
    rs = out["responses"]
    assert [r.cache_hit for r in rs] == [False, True, True]
    assert all(np.array_equal(r.outputs, rs[0].outputs) for r in rs[1:])
    assert rs[0].outputs.shape == (400, get_config("ample-gcn", reduced=True).vocab_size)
    info = out["engine"].cache_info()
    assert info["planner_calls"] == 2  # the repeated graph once, the batch's union once
    assert info["cache_hits"] == 2
    assert "plan[hit ]" in text and "batched 3 graphs" in text


def test_serve_gnn_feature_budget_streams_bitwise(capsys):
    base = serve.main(["--arch", "ample-gcn", "--device", "cpu", "--nodes", "2000",
                       "--requests", "2"])
    out = serve.main(["--arch", "ample-gcn", "--device", "cpu", "--nodes", "2000",
                      "--requests", "2", "--feature-budget-mb", "0.1"])
    assert "streamed" in capsys.readouterr().out
    for r, b in zip(out["responses"], base["responses"]):
        assert r.streamed and r.bytes_streamed > 0 and not b.streamed
        assert np.array_equal(r.outputs, b.outputs)


def test_serve_gnn_continuous_batching(capsys):
    out = serve.main(["--arch", "ample-gcn", "--device", "cpu", "--nodes", "400",
                      "--continuous-batching"])
    text = capsys.readouterr().out
    cont = out["continuous"]
    assert len(cont["tickets"]) == 11 and all(t.done for t in cont["tickets"])
    assert cont["info"]["completed"] == 11
    assert "continuous batching: 11 requests" in text and "member-plan hit rate" in text


def test_serve_gnn_tenants_and_observability(capsys, tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.txt"
    out = serve.main(["--arch", "ample-gcn", "--device", "cpu", "--nodes", "400",
                      "--tenants", "gold:4:1,batch:1:0", "--trace-out", str(trace),
                      "--metrics-dump", str(metrics)])
    text = capsys.readouterr().out
    router = out["router"]
    assert router.stats["completed"] == 4 * (1 + 6) and out["rejected"] == 0
    snap = router.snapshot()["tenants"]
    assert snap["gold"]["completed"] == 4 and snap["batch"]["completed"] == 24
    assert "slo_hit=" in text and trace.stat().st_size > 0
    assert "gnn_router" in metrics.read_text()


def test_serve_parses_tenants_and_refuses_bad_entries():
    assert serve._parse_tenants("gold:4:1,batch") == [("gold", 4.0, 1, 0.0),
                                                      ("batch", 1.0, 0, 0.0)]
    with pytest.raises(SystemExit):
        serve._parse_tenants("a:1:2:3:4")
    with pytest.raises(SystemExit):
        serve._parse_tenants(" , ")


# ---------------------------------------------------------------- examples
def _example(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_on_cpu(capsys):
    build.reset_launch_counts()
    res = _example("quickstart_torch").run(device="cpu", nodes=300)
    text = capsys.readouterr().out
    assert "device cpu" in text and "metrics:" in text
    assert res["oracle_agreement"] >= 0.9 and res["oracle_rel_err"] < 0.08
    assert res["warm_equals_cold"] == 1.0 and res["gat_warm_equals_cold"] == 1.0
    assert res["outofcore_bitwise"] == 1.0 and res["sharded_drift"] < 1e-4
    assert res["tenant_completed"] == 7 and res["trace_spans"] > 0
    assert build.launch_counts() == {}  # the plain versions: no kernel on the CPU


def test_serve_lm_example_on_cpu(capsys):
    ex = _example("serve_lm_torch")
    out = ex.run(arch="smollm-360m", batch=2, prompt_len=8, tokens=6, device="cpu")
    assert tuple(out.shape) == (2, 14) and "tok/s" in capsys.readouterr().out
    cfg = get_config("smollm-360m", reduced=True)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    # the same engine the example builds, twice: the same tokens
    assert torch.equal(out, ex.run(arch="smollm-360m", batch=2, prompt_len=8, tokens=6,
                                   device="cpu"))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    assert np.array_equal(out[:, :8].numpy(), prompts)


def test_ample_simulation_example_matches_reference_simulator(capsys):
    from repro.core import simulator as ref_sim

    rows = _example("ample_simulation_torch").run(max_nodes=400, datasets=("cora", "pubmed"),
                                                  device="cpu")
    assert "cora" in capsys.readouterr().out
    for name, row in rows.items():
        ev = ref_sim.simulate_dataset(name, max_nodes=400)
        db = ref_sim.simulate_dataset(name, max_nodes=400,
                                      cfg=ref_sim.SimConfig(event_driven=False))
        assert row["event_driven"] == ev and row["double_buffered"] == db
