"""The harness finds every configuration, traffic mix, driver, limit file and
per-layer metric by the name BENCHMARK.json gives it."""

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.find_cell(BENCH, name)
    assert cell.config["name"] == cell.workload["config"]
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.traffic['driver']}.py")
    assert hasattr(driver, "Job") and hasattr(driver, "TINY")
    assert cell.limits and set(cell.limits) <= set(
        _numbers(driver.Job.unit))
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    # the driver's readings, named by the traffic, give every other one
    assert {m["name"] for m in cell.end_to_end} - {"setup_s"} \
        <= set(cell.traffic["metrics"].values())
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]).read)


def _numbers(unit):
    base = ("loss", "grad", "update", "bn")
    if unit == "step":
        return base + tuple(f"{k}_{s}" for k in base[1:]
                            for s in ("median", "q90"))
    return ("logits", "classes", "affine")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        e2e = {x["name"] for x in harness.find_cell(BENCH, cell).end_to_end}
        assert m["moves"] in e2e


def test_unknown_cell_is_refused():
    with pytest.raises(harness.CellError):
        harness.find_cell(BENCH, "no-such-cell")


def test_k2_metric_only_where_k2_runs():
    k2 = next(m for m in BENCH["per_layer"]
              if m["name"] == "k2_roofline_pct.infer")
    for name in k2["workloads"]:
        assert harness.find_cell(BENCH, name).traffic["ind"] == 1


def test_a_family_reader_serves_every_metric_of_its_family():
    own = harness.reader("conv_ms.train")
    assert own.__file__.endswith("metrics/conv_ms.py")
    later = harness.reader("conv_ms.some_later_cell")
    assert later.__file__ == own.__file__


def test_idle_is_read_against_the_untraced_window():
    from types import SimpleNamespace

    from portbench.readers import idle_pct
    from portbench.trace import TraceSummary, _union

    # 8 steps traced, the device busy 50 ms a step; the profiler's host cost
    # stretched the slice to 0.8 s, the untraced window ran 80 ms a step
    trace = TraceSummary(units=8, window_s=0.8, busy_s=0.4,
                         ops=[("k", 0.4)])
    ctx = SimpleNamespace(trace=trace,
                          window={"seconds": 10.0, "units": 125})
    assert idle_pct(ctx) == pytest.approx(37.5)
    assert idle_pct(SimpleNamespace(trace=None, window=ctx.window)) is None
    assert _union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
