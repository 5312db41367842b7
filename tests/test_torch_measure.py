"""The device-time bookkeeping of ``repro_torch.launch.measure`` (shared by
chip_smoke.py, tools/time_kernel.py, profile_decode and the card tests),
on traces written out by hand: the card's profiler can drop kernel
records, so a kernel's launches a call come from the fullest trace and
its time from the mean of the records that were kept."""
import pytest

from repro_torch.launch import measure

# (traces of 3 calls, the launches a call and mean ms each kernel must get)
CASES = {
    "whole": ([[("a", 10.0), ("b", 2.0)] * 3, [("a", 12.0), ("b", 2.0)] * 3],
              {"a": (1, 0.011), "b": (1, 0.002)}),
    # two of a's three records dropped from the first trace, one from the second
    "dropped": ([[("a", 10.0), ("b", 2.0), ("b", 4.0), ("b", 6.0)],
                 [("a", 20.0), ("a", 30.0)] + [("b", 3.0)] * 3],
                {"a": (1, 0.020), "b": (1, 0.0035)}),
    # a kernel launched twice a call, one trace empty
    "twice": ([[("a", 1.0)] * 6, []], {"a": (2, 0.001)}),
    # a kernel missing from one trace is timed from the other
    "one trace": ([[("a", 5.0)] * 3, [("b", 7.0)] * 2], {"a": (1, 0.005), "b": (1, 0.007)}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pool_counts_launches_and_times_kept_records(case):
    traces, want = CASES[case]
    got = measure.pool(traces, 3)
    assert set(got) == set(want)
    for name, (n, ms) in want.items():
        assert got[name][0] == n
        assert got[name][1] == pytest.approx(ms, rel=1e-12)


def test_kernel_times_retries_empty_traces_and_raises_on_none(monkeypatch):
    """Traces are taken again while all are empty, up to TRACE_TRIES; a
    call whose traces never hold a kernel is an error, not a time of 0."""
    taken = []
    monkeypatch.setattr(measure, "traced", lambda fn, calls, key: taken.append(1) or [])
    with pytest.raises(RuntimeError):
        measure.kernel_times(lambda: None, 5, "repro_sc::")
    assert len(taken) == measure.TRACE_TRIES

    feed = iter([[], [], [("k", 4.0)] * 5])
    monkeypatch.setattr(measure, "traced", lambda fn, calls, key: next(feed))
    assert measure.kernel_times(lambda: None, 5, "") == {"k": (1, 0.004)}
    feed = iter([[("k", 4.0)] * 5, [("k", 6.0)] * 4])
    # one launch a call, at the mean of the nine kept records
    want = (4.0 * 5 + 6.0 * 4) / 9 / 1e3
    assert measure.device_ms(lambda: None, 5, "") == pytest.approx(want, rel=1e-12)
