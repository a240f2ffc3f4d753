"""The port's spans and counters (`utils.profiling`, `utils.compiled`) and the
benchmark's readers of them (`perfbench.spans`, the `graph_capture_s.setup`
metric), on the CPU: the in-memory log, the span in a torch.profiler trace,
the span tree of `predict` and of a solve, the link of device operations to
spans on a synthetic kineto event list, and the Stopwatch's clock."""
import functools
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness, spans as spans_lib, trace as trace_lib
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch import presets
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.utils import compiled, profiling
from zedo_tpu_torch.zeroshot import pipeline
from zedo_tpu_torch.zeroshot.ipo import IPOConfig
from zedo_tpu_torch.zeroshot.oil import OILConfig


@pytest.fixture(autouse=True)
def _empty_log():
    profiling.clear()
    yield
    profiling.clear()


def _tree(log):
    """(name, parent's name or None) of each logged span."""
    return [(s.name, log[s.parent].name if s.parent >= 0 else None) for s in log]


def test_spans_are_not_logged_outside_recording():
    assert profiling.annotate("zedo.x") is profiling.annotate("zedo.y")  # the shared no-op
    with profiling.annotate("zedo.x"):
        torch.ones(4).sum()
    assert profiling.spans() == []


def test_recording_logs_names_parents_units_and_times():
    with profiling.recording():
        for _ in range(2):
            with profiling.annotate("zedo.a"):
                with profiling.annotate("zedo.b"):
                    pass
                with profiling.annotate("zedo.c"):
                    with profiling.annotate("zedo.d"):
                        pass
    with profiling.annotate("zedo.after"):
        pass
    log = profiling.spans()
    assert _tree(log) == [("zedo.a", None), ("zedo.b", "zedo.a"), ("zedo.c", "zedo.a"),
                          ("zedo.d", "zedo.c")] * 2
    assert [s.unit for s in log[:4]] == [log[0].unit] * 4
    assert [s.unit for s in log[4:]] == [log[4].unit] * 4 and log[4].unit != log[0].unit
    for s in log:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = log[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    profiling.clear()
    assert profiling.spans() == []


def test_the_log_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_EVENTS", 5)
    with profiling.recording():
        for _ in range(4):
            with profiling.annotate("zedo.outer"):
                with profiling.annotate("zedo.inner"):
                    pass
    log = profiling.spans()
    assert len(log) == 5
    assert _tree(log) == [("zedo.outer", None), ("zedo.inner", "zedo.outer")] * 2 + [
        ("zedo.outer", None)]
    assert all(s.end_ns for s in log)


def test_a_span_under_the_profiler_is_its_kineto_event_around_its_ops():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("zedo.work"):
            torch.ones(64).mul(2).sum()
        torch.zeros(8).add(1)
    events = [(e.name(), *trace_lib._start_end(e)) for e in prof.profiler.kineto_results.events()]
    (span,) = [e for e in events if e[0] == "zedo.work"]
    inside = {n for n, s, e in events if span[1] <= s and e <= span[2] and n != "zedo.work"}
    assert {"aten::ones", "aten::mul", "aten::sum"} <= inside
    assert "aten::zeros" not in inside
    assert profiling.spans() == []  # the profiler alone logs nothing in memory


def _estimator():
    _, _, family = tbt.load_fixture(device="cpu")
    preset = presets.h36m(hidden_dim=int(family["hidden"]), embed_dim=int(family["embed"]))
    est = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=preset, dtype="fp32", batch_bucket=8,
        device="cpu").with_schedule(6, ipo_iterations=4)
    _, k, px = tbt.make_scenes(family, 5)
    return est, k, px


def test_predict_logs_its_span_tree_under_one_request_id():
    est, k, px = _estimator()
    with profiling.recording():
        for _ in range(2):
            est.predict(px, k)
    log = profiling.spans()
    one = [("zedo.predict", None), ("zedo.predict.pad", "zedo.predict"),
           ("zedo.predict.h2d", "zedo.predict"), ("zedo.solve", "zedo.predict"),
           ("zedo.ipo", "zedo.solve"), ("zedo.oil", "zedo.solve"),
           ("zedo.predict.rank_pack", "zedo.predict"), ("zedo.predict.d2h_wait", "zedo.predict"),
           ("zedo.predict.unpad", "zedo.predict")]
    assert _tree(log) == one * 2
    assert {s.unit for s in log[:9]} == {log[0].unit}
    assert {s.unit for s in log[9:]} == {log[9].unit} != {log[0].unit}
    host, wait = spans_lib.predict_ms(log)
    whole = sum(s.end_ns - s.start_ns for s in log if s.name == "zedo.predict") / 2 * 1e-6
    assert host > 0 and wait > 0 and host + wait == pytest.approx(whole)


def test_a_compiled_solve_of_1000_steps_logs_three_spans():
    cfg = score_mlp.ScoreMLPConfig(hidden_dim=32, embed_dim=16, group_norm_groups=8)
    params = score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, _, family = tbt.load_fixture(device="cpu")
    _, k, px = tbt.make_scenes(family, 1)
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)
    zcfg = pipeline.ZeDOConfig(ipo=IPOConfig(iterations=2), oil=OILConfig(iterations=1000))
    clusters = torch.from_numpy(tbt.make_hypothesis_clusters(family, 1))
    with profiling.recording():
        pipeline.solve_jit(params, cfg, sde, PCSampler(sde=sde, eps=0.01), zcfg, clusters,
                           torch.from_numpy(px), None, torch.from_numpy(k))
    assert _tree(profiling.spans()) == [("zedo.solve", None), ("zedo.ipo", "zedo.solve"),
                                        ("zedo.oil", "zedo.solve")]


def test_phase_records_its_span_and_synchronizes_only_for_a_stopwatch(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    cuda = torch.device("cuda")
    sw = profiling.Stopwatch()
    with profiling.recording():
        with profiling.phase(None, "ipo", cuda):
            pass
        assert synced == []
        with profiling.phase(sw, "oil", cuda):
            pass
    assert synced == [cuda] and sw.counts == {"oil": 1}
    assert [s.name for s in profiling.spans()] == ["zedo.ipo", "zedo.oil"]


def test_stopwatch_reads_the_monotonic_clock(monkeypatch):
    sw = profiling.Stopwatch()
    # a wall clock stepping back by an hour moves nothing
    monkeypatch.setattr(time, "time", functools.partial(next, iter([7200.0, 3600.0])))
    with sw.phase("ipo"):
        pass
    assert 0 <= sw.totals["ipo"] < 60


# ---------------------------------------------- perfbench.spans: the link and the readers


def _synthetic():
    """A host timeline with a request span holding a solve (ipo, oil), the
    launches inside them (one a graph), a launch outside any span, and the
    device's operations, which run behind the host: each linked to its
    launch by correlation id only. Seconds."""
    host = [
        (0.0, 10.0, "zedo.predict", 1),
        (1.0, 6.0, "zedo.solve", 2),
        (1.0, 2.0, "zedo.ipo", 3),
        (2.0, 6.0, "zedo.oil", 4),
        (1.5, 1.6, "cudaLaunchKernel", 101),
        (2.5, 2.6, "cudaGraphLaunch", 102),
        (7.0, 7.1, "cudaMemcpyAsync", 103),
        (11.0, 11.1, "cuLaunchKernel", 104),
        (2.5, 2.6, "aten::mul", 104),  # an operator's id equal to a device operation's
    ]
    device = [
        (3.0, 4.0, "ipo_kernel", 101),  # ran after zedo.ipo ended: still the ipo's
        (4.0, 6.5, "graph_kernel_a", 102),
        (6.0, 7.0, "graph_kernel_b", 102),  # overlaps a: the union counts 3.0 s
        (8.0, 8.5, "memcpy", 103),
        (12.0, 12.5, "late_kernel", 104),
        (12.5, 13.0, "unlaunched", 999),
    ]
    return device, host


def test_device_operations_link_to_spans_by_correlation_and_gaps_by_span():
    device, host = _synthetic()
    device_by_span, idle_by_span = spans_lib.by_span(device, host)
    assert device_by_span == {"zedo.ipo": 1.0, "zedo.oil": 3.0, "zedo.predict": 0.5,
                              "outside": 1.0}
    # gaps 7.0-8.0 (middle in zedo.predict) and 8.5-12.0 (middle 10.25: no span)
    assert idle_by_span == {"zedo.predict": 1.0, "outside": 3.5}
    t = trace_lib.summarize([d[:3] for d in device], [h[:3] for h in host], 14.0, 1)
    assert sum(device_by_span.values()) == pytest.approx(t.busy_s) and t.busy_s == 5.5
    assert sum(idle_by_span.values()) == pytest.approx(sum(t.idle_gaps.values()))
    # the fields trace.summarize had before the spans, from the same events
    assert t.device_ops == {"ipo_kernel": 1.0, "graph_kernel_a": 2.5, "graph_kernel_b": 1.0,
                            "memcpy": 0.5, "late_kernel": 0.5, "unlaunched": 0.5}
    assert t.dispatches == 3 and t.window_s == 14.0 and t.units == 1
    assert t.idle_gaps == {"zedo.predict": 1.0, "idle": 3.5}


def test_the_readers_give_numbers_from_their_inputs_and_none_without():
    device, host = _synthetic()
    device_by_span, _ = spans_lib.by_span(device, host)
    assert spans_lib.device_ms(device_by_span, "zedo.oil", 2) == pytest.approx(1500.0)
    assert spans_lib.device_ms(device_by_span, "zedo.evaluate", 2) is None
    assert spans_lib.device_ms({}, "zedo.oil", 0) is None
    S = profiling.Span
    log = [S("zedo.predict", 0, 50_000_000, -1, 0), S("zedo.predict.d2h_wait", 8_000_000,
                                                        48_000_000, 0, 0),
           S("zedo.predict", 60_000_000, 90_000_000, -1, 1),
           S("zedo.predict.d2h_wait", 70_000_000, 80_000_000, 2, 1),
           S("zedo.solve", 1_000_000, 2_000_000, 0, 0)]
    assert spans_lib.predict_ms(log) == pytest.approx((15.0, 25.0))
    assert spans_lib.predict_ms(log[4:]) is None and spans_lib.predict_ms([]) is None


def test_graph_capture_reader_reads_the_counter_and_none_without_it(monkeypatch):
    reader = harness.load_module(harness.HERE / "metrics" / "graph_capture_s.setup.py")
    assert reader.read(None) == compiled.cache_info()["capture_s"]
    parent = {"hits": 1, "misses": 2, "entries": 2}  # a program without the counter
    monkeypatch.setattr(compiled, "cache_info", lambda: parent)
    assert reader.read(None) is None


def test_capture_counters_are_kept_by_clear_cache():
    saved = dict(compiled._STATS)
    compiled._STATS.update(captures=3, capture_s=1.5)
    try:
        compiled.clear_cache()
        info = compiled.cache_info()
        assert (info["hits"], info["misses"], info["captures"], info["capture_s"]) == (0, 0, 3, 1.5)
    finally:
        compiled._STATS.update(saved)
