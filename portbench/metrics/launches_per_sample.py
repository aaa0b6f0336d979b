"""Device operations (kernels, copies, fills) that ran in the window, over
the full-frame samples rendered (``torch.profiler``'s device trace)."""


def read(r):
    t = r.trace
    if t is None or not t.ops or r.samples < 1:
        return None
    return len(t.ops) / r.samples
