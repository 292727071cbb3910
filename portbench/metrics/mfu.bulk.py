"""The model's operations per call (counts/models.py) times the calls of
the window outside its traced stretch, over that time and the card's peak
(%): the traced run's rate, read on the host's clock without the profiler."""

from portbench.counts.models import captioner_flops
from portbench.harness.readers import bucket, mfu_percent


def read(run):
    mix, w = run.mix, run.window
    flops = captioner_flops(run.config["model"], bucket(mix["batch"]), mix["beam_size"],
                            mix["max_length"])
    return mfu_percent(flops * w.untraced_calls, w.untraced_s)
