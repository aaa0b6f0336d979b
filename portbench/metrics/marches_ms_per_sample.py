"""Device ms a sample launched under the program's stages "ocean",
"caustics" and "clouds" (``render/wavefront.py``'s ``StageRanges``)."""

STAGES = ("ocean", "caustics", "clouds")


def read(r):
    t = r.trace
    if t is None or r.samples < 1:
        return None
    us = [o.dur for o in t.ops if o.stage in STAGES]
    if not us:
        return None
    return sum(us) / 1e3 / r.samples
