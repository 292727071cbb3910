"""Kernels the profiler saw on the card per predict_batch call."""


def read(run):
    if not run.trace or not run.window.traced_calls or not run.trace["kernel_launches"]:
        return None
    return run.trace["kernel_launches"] / run.window.traced_calls
