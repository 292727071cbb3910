"""Device busy time per extracted frame in the traced stretch (ms)."""


def read(run):
    if not run.trace or not run.window.traced_items or run.trace["busy_s"] <= 0:
        return None
    return 1e3 * run.trace["busy_s"] / run.window.traced_items
