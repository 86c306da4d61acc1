"""Host microseconds a tick in ``TickRunner.run``: the driver's host clock
around ``runner.run`` over the ticks it runs before its profiled window,
outside the profiler and before the sync (``values["replay_s"]`` over
``values["replay_ticks"]``).  It is the host's enqueue of the captured
graphs, and the trace buffers' copies after them; beside the tick it
says whether the host or the device sets the pace.  None without a
traced run."""


def read(run, cell):
    seconds, ticks = run.values.get("replay_s"), run.values.get("replay_ticks")
    if not seconds or not ticks:
        return None
    return seconds / ticks * 1e6
