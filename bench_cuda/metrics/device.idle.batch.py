"""The device's idle share of the traced window: one less the union of the
device operations' intervals in the profiler trace over the window's wall
time."""


def read(record):
    if record["window_s"] <= 0 or record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
