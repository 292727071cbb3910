"""ResNet-50's operations per frame times the frames of the window outside
its traced stretch, over that time and the card's peak (%): the traced
run's rate, read on the host's clock without the profiler."""

from portbench.counts.models import resnet50_flops_per_frame
from portbench.harness.readers import mfu_percent


def read(run):
    per_frame = resnet50_flops_per_frame(run.mix["height"])
    return mfu_percent(per_frame * run.window.untraced_items, run.window.untraced_s)
