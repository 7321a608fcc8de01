"""Share of the profiled stretch (from its first span to the device's
finish) in which the device ran no kernel, copy or fill, in percent."""


def read(r):
    if r.kind != "train":
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s())
