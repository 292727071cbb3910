"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each wrapper counts the launches of its kernel in a plain integer
attribute (``lstm_seq.launches``), so a run can show that the main path
went through the kernels.
"""

from typing import Dict

from .lstm_seq import lstm_seq, lstm_seq_reference  # noqa: F401
from .topk import topk2d_lse, topk2d_lse_reference, topk_stable  # noqa: F401

KERNEL_WRAPPERS = (lstm_seq, topk2d_lse)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
