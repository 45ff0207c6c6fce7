"""``launches_per_img.<train|predict>``: the host's kernel and graph
launch calls in the traced stretch (``portbench/trace.py``'s
``LAUNCHES``) per image the stretch completed."""


def read(name, ctx):
    if ctx["traced_units"] <= 0 or ctx["trace"]["launches"] <= 0:
        return None
    return ctx["trace"]["launches"] / ctx["traced_units"]
