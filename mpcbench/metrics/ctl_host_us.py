"""The part of the window's median latency that is not device work: the
untraced window's p50 (due time to command in host memory, by the host
clock; the number ``ctl_latency_p50_us`` reports) less the median device
time of a traced tick (``ctl_device_us``).  The profiler runs only after
the window, so its own cost stays out of the latency, and the two metrics
sum to the p50.  It holds the input copy, the graph's launch, the fetch,
and whatever keeps an idle card from starting at once."""
import statistics

from mpcbench import timing


def read(run, cell):
    lat = run.values.get("window_latencies_us")
    if run.trace is None or not run.trace.ops or not lat:
        return None
    device = [sum(d for _, _, d in run.trace.ops_in(a, b))
              for a, b in run.trace.spans_named("on_state")]
    if not device:
        return None
    return timing.percentile(lat, 50) - statistics.median(device)
