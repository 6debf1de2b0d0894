"""The step's operations and bytes against numbers worked by hand."""

import pytest

from perfbench import spec, work
from perfbench.work import topl_step


@pytest.mark.parametrize("name,flops,gbytes,bound_ms", [
    # 2 * 128 * 1.25e8 * 96; 1.25e8 * 96 * 4 B of points
    ("deep1b-96d", 3.072e12, 48.0, 45.85),
    # 2 * 128 * 12,903,192 * 1024; 12,903,192 * 1024 * 4 B of keys
    ("knnlm-wt103", 3.3826e12, 52.85, 50.49),
])
def test_step_work_by_hand(name, flops, gbytes, bound_ms):
    cfg = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    n, d, k = cfg["n_points"], cfg["dim"], cfg["shards"]
    f, b = topl_step.work(n, d, k, 128, cfg["service"]["l_max"])
    assert f == pytest.approx(flops, rel=1e-4)
    assert b / 1e9 == pytest.approx(gbytes, rel=1e-3)
    # the queries and the (value, id) results on top of the points
    assert b - n * d * 4 == 128 * d * 4 + k * 128 * cfg["service"][
        "l_max"] * 8
    pk = work.peaks()
    assert work.bound_s(f, b, pk) * 1e3 == pytest.approx(bound_ms, rel=1e-3)
    # compute-bound at a full bucket: the bytes take 14-16 ms
    assert b / pk["hbm_bytes_per_s"] < f / pk["f32_flops_per_s"]
    batches = [{"n_real": 128}, {"n_real": 64}]
    half = topl_step.work(n, d, k, 64, cfg["service"]["l_max"])
    assert topl_step.window_bound_s(cfg, batches, pk) == pytest.approx(
        work.bound_s(f, b, pk) + work.bound_s(*half, pk))


def test_peaks_are_the_data_sheet():
    pk = work.peaks()
    assert pk["f32_flops_per_s"] == 67e12
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["power_limit_w"] == 700
