"""The trace reduction on events laid out by hand."""

from perfbench.trace import Ev, MARK, WINDOW, summarize


def events():
    return [
        Ev(WINDOW, False, 10.0, 20.0, 1),
        # a step: mark, two launches, mark; then a launch outside it
        Ev("cudaLaunchKernel", False, 11.0, 11.01, 7, 40),
        Ev("cudaLaunchKernel", False, 11.1, 11.11, 7, 42),
        Ev("cudaLaunchKernel", False, 11.2, 11.21, 7, 43),
        Ev("cudaLaunchKernel", False, 11.5, 11.51, 7, 41),
        Ev("cudaLaunchKernel", False, 12.0, 12.01, 7, 44),
        Ev("cudaStreamSynchronize", False, 12.01, 12.6, 7, 45),
        Ev(f"fill<{MARK}>", True, 11.02, 11.03, 0, 40),
        Ev(f"fill<{MARK}>", True, 12.0, 12.0, 0, 41),
        Ev("distance", True, 11.2, 11.9, 0, 42),
        Ev("merge", True, 11.9, 12.0, 0, 43),
        Ev("loop", True, 12.1, 12.6, 0, 44),
        # device work before the window is not the window's
        Ev("warmup", True, 5.0, 9.0, 0, 2),
    ]


def test_busy_steps_and_ops():
    s = summarize(events())
    assert s["window_s"] == 10.0
    assert abs(s["busy_s"] - 1.31) < 1e-9
    assert abs(s["step_device_s"] - 0.8) < 1e-9
    assert s["steps"] == 1 and s["marks"] == 2 and s["step_launches"] == 2
    assert [n for n, _ in s["device_ops"]][:3] == ["distance", "loop",
                                                    "merge"]


def test_idle_gaps_by_what_the_host_did():
    s = summarize(events())
    gaps = dict(s["idle_gaps"])
    assert abs(sum(gaps.values()) - (10.0 - 1.31)) < 1e-9
    # [12.6, 20]: Python after the sync; [10, 11.02]: before any call;
    # [11.03, 11.2]: inside the launch of "distance" (a step's first);
    # [12.0, 12.1]: inside the sync that follows the launch of "loop"
    assert abs(gaps["python after cudaStreamSynchronize"] - 7.4) < 1e-9
    assert abs(gaps["python"] - 1.02) < 1e-9
    assert abs(gaps["python in step after cudaLaunchKernel"] - 0.17) < 1e-9
    assert abs(gaps["cudaStreamSynchronize"] - 0.1) < 1e-9


def test_unpaired_marks_give_no_step_time():
    ev = events() + [Ev("cudaLaunchKernel", False, 13.0, 13.01, 7, 50),
                     Ev(MARK, True, 13.1, 13.11, 0, 50)]
    assert summarize(ev)["step_device_s"] is None
    ev = events()
    ev[4] = Ev("cudaLaunchKernel", False, 11.5, 11.51, 8, 41)  # a thread
    assert summarize(ev)["step_device_s"] is None


def test_no_window_or_no_device_work():
    assert summarize([e for e in events() if e.name != WINDOW]) is None
    assert summarize([e for e in events() if not e.device]) is None
