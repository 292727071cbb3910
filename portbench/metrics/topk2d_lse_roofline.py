"""topk2d_lse's least time (counts/kernels.py) over its device time (%)."""

from portbench.counts import kernels
from portbench.harness.readers import bucket, roofline_percent


def read(run):
    K = run.mix["beam_size"]
    shape = kernels.topk2d_lse(bucket(run.mix["batch"]) * K, run.config["model"]["vocab_size"], K)
    return roofline_percent(run, "topk2d_lse", shape, "topk_lse_kernel")
