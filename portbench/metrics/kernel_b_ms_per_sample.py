"""Device ms a sample of kernel B (``csrc/traverse_wide.cu``
``traverse_wide_kernel``: the closest and the any-hit walk) by its kernel
name in the device trace."""

KERNEL = "traverse_wide_kernel"


def read(r):
    t = r.trace
    if t is None or r.samples < 1:
        return None
    us = [o.dur for o in t.ops if o.cat == "kernel" and KERNEL in o.name]
    if not us:
        return None
    return sum(us) / 1e3 / r.samples
