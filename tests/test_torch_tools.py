"""zedo_tpu_torch tooling: the trained-fixture accuracy bounds against the
JAX package, and each entry point (bench_kernel, validate_dtype, bench,
convert_checkpoint) on the CPU at tiny sizes, checking what it prints."""
import importlib.util
import json
import os
import re
import types

import numpy as np
import pytest

from zedo_tpu import bench_trained as jbt
from zedo_tpu.utils import generic as jgeneric
from zedo_tpu.utils.table import Table as JTable
from zedo_tpu_torch import bench
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch.tools import bench_kernel, convert_checkpoint, validate_dtype
from zedo_tpu_torch.utils import generic, profiling
from zedo_tpu_torch.utils.table import Table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# MPJPE and pose-delta keys (mm): fp32 runs the same f32 arithmetic in
# another order; bf16 rounds at other places in XLA and PyTorch on the CPU
TRAINED_TOL_MM = 0.05


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_run_trained_bounds_matches_jax():
    kw = dict(n=4, s=2, oil_iterations=10, ipo_iterations=10)
    want = jbt.run_trained_bounds(**kw)
    got = tbt.run_trained_bounds(device="cpu", **kw)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, int):
            assert got[key] == w, key
        else:
            assert abs(got[key] - w) < TRAINED_TOL_MM, (key, got[key], w)


def test_chip_smoke_trained_reference():
    """chip_smoke.py holds `bench --trained` on the card to the JAX
    package's accuracy bounds at its small shape; recompute them."""
    smoke = _smoke()
    want = jbt.run_trained_bounds(n=smoke.TRAINED_N, s=smoke.TRAINED_S)
    for key, ref in smoke.JAX_TRAINED_BOUNDS.items():
        assert abs(want[key] - ref) < 1e-2, (key, want[key], ref)


def test_bench_kernel_prints_variants_and_best(capsys):
    res = bench_kernel.main(["--rows", "40", "--iters", "2", "--split", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("kernel gn=bf16", "kernel gn=f32", "split tile=56 gn=bf16",
                 "split tile=56 gn=f32", "library chain bf16", "unfused bf16"):
        assert name in res and res[name] > 0 and name in out
    # the plain versions of the two kernels compute one function
    assert res["split_max_abs_diff"] < 1e-4
    assert "split max |diff| vs kernel:" in out
    assert re.search(r"^BEST: .+ at [0-9.]+ ms/step \(40 rows, cpu\)$", out, re.M)
    no_split = bench_kernel.main(["--rows", "8", "--iters", "1", "--device", "cpu"])
    assert not any(k.startswith("split") for k in no_split)


def test_validate_dtype_prints_three_lines(capsys):
    res = validate_dtype.main(["--n", "6", "--hypo", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"bounded samples: \d+/6", out[-3])
    assert re.fullmatch(r"pose \|delta\| mean: [0-9.]+ mm, p99: [0-9.]+ mm, max: [0-9.]+ mm",
                        out[-2])
    assert re.fullmatch(r"MPJPE fp32: [0-9.]+ mm \| bf16: [0-9.]+ mm \| diff: [0-9.]+ mm",
                        out[-1])
    assert res["bounded"] == 6 and np.isfinite(res["mpjpe_diff_mm"])


def test_bench_prints_one_json_line(capsys):
    res = bench.main(["--n", "4", "--s", "2", "--oil", "20", "--reuse", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"phases: ipo: [0-9.]+s \(.+\) \| oil: [0-9.]+s \(.+\)", lines[-2])
    line = json.loads(lines[-1])
    assert line == res
    assert line["metric"] == "eval_wallclock_n4_s2_reuse2_oil20"
    assert line["unit"] == "s" and line["value"] > 0
    extras = line["extras"]
    assert extras["nfe"] == 10 and extras["dtype"] == "bf16" and extras["devices"] == 1
    assert extras["device_kind"] == "cpu"
    # the TPU kernel's FLOP estimate and the TPU-era target are gone
    assert not {"mfu", "flops_basis", "vs_baseline"} & (set(extras) | set(line))
    with pytest.raises(SystemExit):
        bench.main(["--tile", "256", "--device", "cpu"])


def test_bench_trained_prints_the_bounds(capsys):
    res = bench.main(["--trained", "--n", "3", "--s", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and line["metric"] == "trained_accuracy_n3_s2"
    assert line["value"] == round(line["extras"]["fp32_mpjpe_mm"], 3)
    assert {"bf16_mpjpe_mm", "reuse2_delta_mm", "short_reuse2_mpjpe_mm",
            "wallclock_5_solves_s"} <= set(line["extras"])


def test_convert_checkpoint_cluster_and_orbax_modes(tmp_path, capsys):
    dst = str(tmp_path / "clusters.npy")
    got = convert_checkpoint.main(["cluster", tbt.CLUSTERS, dst])
    np.testing.assert_array_equal(np.load(dst), np.load(tbt.CLUSTERS))
    assert got.shape == (2, 17, 3) and "wrote (2, 17, 3) clusters" in capsys.readouterr().out
    for mode in ("pth2native", "native2pth"):
        with pytest.raises(NotImplementedError, match="orbax"):
            convert_checkpoint.main([mode, tbt.CHECKPOINT, str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["unknown", "a", "b"])


def test_profiling_trace_annotate_and_stopwatch(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)):
        with profiling.annotate("zedo_span"):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "zedo_span" for e in trace["traceEvents"])
    sw = profiling.Stopwatch()
    for _ in range(2):
        with sw.phase("ipo"):
            pass
    with sw.phase("oil"):
        pass
    assert sw.counts == {"ipo": 2, "oil": 1}
    assert re.fullmatch(r"ipo: [0-9.]+s \(.+%, n=2\) \| oil: [0-9.]+s \(.+%, n=1\)", sw.report())


def test_table_and_logger_match_the_jax_package(tmp_path):
    rows = [["p1", 12.5, "x"], ["protocol 2", 3, ""]]
    mine, theirs = Table(["name", "mm", "note"]), JTable(["name", "mm", "note"])
    for r in rows:
        mine.add_row(r)
        theirs.add_row(r)
    assert str(mine) == str(theirs)
    assert str(Table(["a"])) == str(JTable(["a"]))
    with pytest.raises(ValueError, match="2 cells for 3 fields"):
        mine.add_row(["a", "b"])
    cfg = types.SimpleNamespace(OUTPUT_DIR=str(tmp_path), DATASET=types.SimpleNamespace(
        TRAIN_DATASET="h36m", TEST_DATASET="3dhp"))
    _, out_dir, tb_dir = generic.create_logger(cfg, "test", "run", log_name="a")
    _, j_out, j_tb = jgeneric.create_logger(cfg, "test", "run", log_name="a")
    assert (out_dir, tb_dir) == (j_out, j_tb) and os.path.isdir(tb_dir)


def test_count_sass_instructions():
    """build.count_sass_instructions counts a kernel's instruction lines of a
    `cuobjdump -sass` listing, not the second encoding line of each
    instruction, the headers or the labels."""
    from zedo_tpu_torch.ops.kernels import build

    dump = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _Z6kernelPf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
                                                                           /* 0x000e220000002100 */
.L_x_0:
        /*0020*/                   EXIT ;                                  /* 0x000000000000794d */
                                                                           /* 0x000fea0003800000 */
		..........
		Function : _Z5otherv
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
                                                                           /* 0x000fea0003800000 */
"""
    assert build.count_sass_instructions(dump) == {"_Z6kernelPf": 3, "_Z5otherv": 1}
    assert build.count_sass_instructions("") == {}


def test_repeat_check_holds_each_run_to_the_first(capsys):
    """tools.repeat_check on the CPU at a tiny size: every kernel case, both
    solves and both serving buckets run again and equal their first run bit
    for bit; the first profiled request and the later ones are reported (the
    CPU trace holds no device event); the last line is the JSON record."""
    from zedo_tpu_torch.tools import repeat_check

    res = repeat_check.main(["--device", "cpu", "--scale", "0.0001", "--kernel-rows", "3",
                             "--rows", "2", "--hypo", "2", "--hidden", "64", "--oil", "3",
                             "--ipo", "3"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    runs = {name: r for name, r in res.items() if name != "profiled_request"}
    assert len(runs) == 2 * len(repeat_check.KERNEL_CASES) + len(repeat_check.SOLVES) + 2
    assert all(r["runs"] >= 1 and r["differed"] == 0 for r in runs.values())
    assert [p["request"] for p in res["profiled_request"]] == ["first", "replay"]
    assert all(p["kernel_1_launches"] == 0 == p["device_events"]
               for p in res["profiled_request"])
