"""lstm_seq's least time (counts/kernels.py) over its device time (%)."""

from portbench.counts import kernels
from portbench.harness.readers import bucket, roofline_percent


def read(run):
    m = run.config["model"]
    shape = kernels.lstm_seq(m["video_sequence_length"], 2, bucket(run.mix["batch"]),
                             m["encoder_hidden_dim"])
    return roofline_percent(run, "lstm_seq", shape, "lstm_seq_fwd_kernel")
