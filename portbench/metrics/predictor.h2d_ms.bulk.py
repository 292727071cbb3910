"""Device time of host-to-device copies per predict_batch call in the
traced stretch (ms)."""


def read(run):
    if not run.trace or not run.window.traced_calls or run.trace["h2d_s"] <= 0:
        return None
    return 1e3 * run.trace["h2d_s"] / run.window.traced_calls
