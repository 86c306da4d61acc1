"""The controller's tail: the 95th percentile of every latency of the
untraced window (due time to command in host memory, by the host clock),
all its ticks and never medians of chunks.  Runs on a host whose cores are
shared spread too widely for it to hold a bound, so it stands beside
``ctl_latency_p50_us`` as a per-layer reading (PERF.md §2)."""
from mpcbench import timing


def read(run, cell):
    lat = run.values.get("window_latencies_us")
    if not lat:
        return None
    return timing.percentile(lat, 95)
