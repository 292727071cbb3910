"""fused_bottleneck's least time over the device time of its launches and
their TF32 weight splits (%): every clip of the traced stretch is forwards
of ``batch`` frames and one of the rest."""

from portbench.counts import kernels
from portbench.counts.kernels import bound_s
from portbench.harness.trace import kernel_time


def read(run):
    mix, w = run.mix, run.window
    sizes = [mix["batch"]] * (mix["frames"] // mix["batch"])
    if mix["frames"] % mix["batch"]:
        sizes.append(mix["frames"] % mix["batch"])
    least, launches = 0.0, 0
    for b in sizes:
        for hw, C, Cm, n in kernels.RESNET50_IDENTITY_BLOCKS:
            least += n * bound_s(*kernels.fused_bottleneck(b, hw, hw, C, Cm))
            launches += n
    _, seconds = kernel_time(run.trace, "fused_bottleneck_kernel", "split_tf32_kernel")
    counted = w.launches.get("fused_bottleneck", 0)
    if not w.traced_calls or seconds <= 0 or counted != launches * w.traced_calls:
        return None
    return 100.0 * least * w.traced_calls / seconds
