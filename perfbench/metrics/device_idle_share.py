"""Share of the traced window in which no device activity (kernel, copy or
memset) runs, in percent: 1 - busy / window, busy being the union of the
activities' intervals (``scripts/profile_main_path.py``'s arithmetic)."""


def read(r):
    if r.trace is None or r.trace.window <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window)
