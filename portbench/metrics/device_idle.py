"""``device_idle.<train|predict|tile>``: the share of the traced
stretch's wall time in which no operation ran on the device (%): one
minus the union of the device operations' intervals over the stretch
(``portbench/trace.py``)."""


def read(name, ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
