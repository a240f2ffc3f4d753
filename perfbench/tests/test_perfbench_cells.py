"""The harness on the CPU: BENCHMARK.json's cells found by name, every mix run
end to end at a tiny size with the plain kernels, and `correct` coming out
false when the timed path is broken underneath. The control at each cell's
own size runs on the card (`gpu`)."""
from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CPU_INFO = {"platform": "cpu", "kind": "cpu (not measured on a device)", "count": 1}


def tiny(name: str) -> harness.Cell:
    """The cell at a size the CPU holds: hidden 64, a few steps, f32 weights
    (the CPU runs the plain kernels, whose bf16 products the card does not
    share)."""
    c = harness.cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(hidden_dim=64, embed_dim=32, group_norm_groups=8, weights="fp32")
    c.config["zedo"].update(IPO_iterations=6, OIL_iterations=10)
    mix = dict(c.mix)
    if mix["driver"] == "batch_solve":
        mix.update(n=6, hypotheses=3)
        if "rows" in mix["check"]:
            mix["check"] = {"rows": 12}
    elif mix["driver"] == "serve":
        mix.update(bucket=4, largest=6, check={"requests": 3},
                   schedule={"IPO_iterations": 4, "OIL_iterations": 6})
    else:
        mix.update(rows=64, batch=16)
    c.mix = mix
    return c


def run_tiny(name: str) -> dict:
    return harness.execute(tiny(name), 2**31 + 12345, 0.3, False, torch.device("cpu"),
                           time.perf_counter(), lambda: dict(CPU_INFO))


def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
        assert harness.load_json(harness.ROOT / c["file"])["name"] == c["name"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.cell(w["name"])
        assert "setup_s" in [m["name"] for m in cell.end_to_end] and len(cell.end_to_end) >= 2
        assert cell.per_layer
        assert (harness.HERE / "drivers" / f"{cell.mix['driver']}.py").is_file()
        assert all(np.isfinite(v) and v < 1e6 for v in cell.limits.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and all(w in CELLS for w in m["workloads"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_on_the_cpu(name):
    result = run_tiny(name)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["device"]["kind"] == CPU_INFO["kind"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    want = {m["name"] for m in harness.cell(name).end_to_end}
    assert set(result["metrics"]) == want
    json.dumps(result)


def _moved(poses, fault: str):
    """An [N, S, j, 3] answer with the poses that `fault` breaks moved by
    5 cm: all of them ("answer"), the second half of the input poses
    ("half_rows"), or the last hypothesis of each ("one_slot")."""
    out = poses.clone() if isinstance(poses, torch.Tensor) else poses.copy()
    where = {"answer": np.s_[:], "half_rows": np.s_[len(poses) // 2:],
             "one_slot": np.s_[:, -1]}[fault]
    out[where] += 0.05
    return out


FAULTS = {
    "h36m.batch_886x50": ["answer", "half_rows", "one_slot"],
    "syrip.batch_500x20": ["answer", "half_rows", "one_slot"],
    "h36m.serve_lowlat_b32": ["answer", "half_rows", "one_slot", "best"],
    "h36m.train_50k": ["unchanged", "half_batch"],
}


def plant(monkeypatch, fault: str) -> None:
    """Break the timed path underneath the harness."""
    from zedo_tpu_torch import serving
    from zedo_tpu_torch.diffusion import losses
    from zedo_tpu_torch.zeroshot import infant, pipeline

    if fault in ("answer", "half_rows", "one_slot"):
        for module, fn in ((pipeline, "solve_jit"), (infant, "solve_infant_jit")):
            real = getattr(module, fn)

            def altered(*a, _real=real, **k):
                res = _real(*a, **k)
                return res._replace(poses=_moved(res.poses, fault))

            monkeypatch.setattr(module, fn, altered)
        real_predict = serving.ZeDOEstimator.predict

        def altered_predict(self, *a, **k):
            out = real_predict(self, *a, **k)
            return {**out, "poses": _moved(out["poses"], fault)}

        monkeypatch.setattr(serving.ZeDOEstimator, "predict", altered_predict)
    elif fault == "best":
        real_predict = serving.ZeDOEstimator.predict

        def wrong_best(self, *a, **k):
            out = real_predict(self, *a, **k)
            return {**out, "best": out["reprojection_error"].argmax(1)}

        monkeypatch.setattr(serving.ZeDOEstimator, "predict", wrong_best)
    elif fault == "unchanged":
        monkeypatch.setattr(losses, "_train_body",
                            lambda carry, *a, **k: carry)
    elif fault == "half_batch":
        real_loss = losses.get_sde_loss_fn

        def half(*a, **k):
            fn = real_loss(*a, **k)
            return lambda params, gen, batch, *r: fn(params, gen, batch[:len(batch) // 2], *r)

        monkeypatch.setattr(losses, "get_sde_loss_fn", half)


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    plant(monkeypatch, fault)
    result = run_tiny(name)
    assert result["correct"] is False, result["checks"]


def test_only_whole_top_level_names_are_forbidden(monkeypatch):
    monkeypatch.setitem(sys.modules, "zedo_tpu_torch_fake", object())
    assert harness.loaded_forbidden() == [] or "zedo_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "zedo_tpu.fake", object())
    assert "zedo_tpu" in harness.loaded_forbidden()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from perfbench.tests.test_perfbench_cells import run_tiny;"
            "from perfbench import harness;"
            "[run_tiny(n) for n in sys.argv[1:]];"
            "print(harness.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code, *CELLS], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(harness.ROOT)})
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes_at_full_size(name):
    if not torch.cuda.is_available():
        pytest.skip("the control is read at the cell's own size on a CUDA device")
    from perfbench import control

    cell = harness.cell(name)
    got = control.readings(cell, 2**32 + 77, 2.0, torch.device("cuda", 0), True)
    assert all(got["program"][k] <= v for k, v in cell.limits.items()), got
    assert any(got["control"][k] > v for k, v in cell.limits.items()), got
