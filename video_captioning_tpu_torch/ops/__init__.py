"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each wrapper counts the launches of its kernel in a plain integer
attribute (``lstm_seq.launches``), so a run can show that the main path
went through the kernels.
"""

from typing import Dict

from .lstm_seq import lstm_seq, lstm_seq_reference  # noqa: F401
from .lstm_seq_train import (  # noqa: F401
    lstm_seq_train,
    lstm_seq_train_bwd,
    lstm_seq_train_bwd_reference,
    lstm_seq_train_fwd,
    lstm_seq_train_fwd_reference,
)
from .topk import topk2d_lse, topk2d_lse_reference, topk_stable  # noqa: F401

KERNEL_WRAPPERS = (lstm_seq, topk2d_lse, lstm_seq_train_fwd, lstm_seq_train_bwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
