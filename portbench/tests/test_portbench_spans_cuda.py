"""On the card: a capture with device activity only turns the program's
spans on, and a span's stamps share the device trace's clock: a span around
one kernel launch and a synchronize holds that kernel's device interval,
with at most 20 µs of slack. Skips where there is no CUDA device (the
decision is made inside the test)."""

import pytest


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_device_clock():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from iterative_solvers_tpu_torch.profiling import RECORDER, solve_span
    from portbench.yardstick import read_trace

    x = torch.randn(4096, 4096, device="cuda")
    y = x * 2.0
    torch.cuda.synchronize()
    RECORDER.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        enabled = torch.autograd._profiler_enabled()
        with solve_span("probe"):
            y = x * 2.0
            torch.cuda.synchronize()
    assert enabled, "a capture with device activity only leaves the spans off"
    dev = read_trace(prof)["device"]
    (sp,) = RECORDER.spans
    s0, s1 = sp.t0 / 1e3, sp.t1 / 1e3  # µs, as the trace's
    assert dev
    for name, k0, k1 in dev:
        print(f"span {s0:.3f}..{s1:.3f} µs; {name[:60]} {k0 - s0:.3f}..{k1 - s0:.3f} µs "
              f"after its start, {s1 - k1:.3f} µs before its end")
        assert s0 - 20.0 <= k0 <= k1 <= s1 + 20.0
    del y
