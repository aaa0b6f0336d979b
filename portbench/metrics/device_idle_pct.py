"""Share of the window in which the card runs no kernel, copy or fill, the
mean over the cell's cards (``torch.profiler``'s device trace)."""


def read(r):
    t = r.trace
    if t is None or not t.devices or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.mean_busy_us() / t.window_us)
