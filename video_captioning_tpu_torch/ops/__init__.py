"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each wrapper counts the launches of its kernel in a plain integer
attribute (``lstm_seq.launches``), so a run can show that the main path
went through the kernels. ``ops/library.py`` registers the serving
kernels as ``torch.library`` custom ops, so ``torch.export`` keeps them in
a program (whose launches count in the same attributes).
"""

from typing import Dict

from .attention import bahdanau_attend, bahdanau_attend_reference  # noqa: F401
from .bottleneck import fused_bottleneck, fused_bottleneck_reference  # noqa: F401
from .conv1x1 import conv1x1, matmul_bias_act, matmul_bias_act_reference  # noqa: F401
from .int8_matmul import (  # noqa: F401
    int8_matmul_requant,
    int8_matmul_requant_reference,
    int8_matmul_residual_requant,
    int8_matmul_residual_requant_reference,
)
from .lstm_cell import lstm_cell_fused, lstm_cell_reference  # noqa: F401
from .lstm_seq import lstm_seq, lstm_seq_reference  # noqa: F401
from .lstm_seq_train import (  # noqa: F401
    lstm_seq_train,
    lstm_seq_train_bwd,
    lstm_seq_train_bwd_reference,
    lstm_seq_train_fwd,
    lstm_seq_train_fwd_reference,
)
from .topk import (  # noqa: F401
    topk2d,
    topk2d_lse,
    topk2d_lse_reference,
    topk2d_reference,
    topk_stable,
)
from .transformer_attn import (  # noqa: F401
    beam_cross_attention,
    beam_cross_attention_reference,
    beam_self_attention,
    beam_self_attention_reference,
)
from .vocab_topk import (  # noqa: F401
    pad_vocab_weights,
    vocab_topk_lse,
    vocab_topk_lse_reference,
)

from . import library  # noqa: F401,E402  (registers the vct:: custom ops)

KERNEL_WRAPPERS = (lstm_seq, topk2d_lse, lstm_seq_train_fwd, lstm_seq_train_bwd, topk2d,
                   bahdanau_attend, lstm_cell_fused, vocab_topk_lse, beam_self_attention,
                   beam_cross_attention, fused_bottleneck, matmul_bias_act, int8_matmul_requant,
                   int8_matmul_residual_requant)


# The recurrences, whose launches past H = 600 (the wide encoder's, where
# the backward sweep takes its wide form) are counted apart as
# ``<name>_wide`` besides in ``<name>``.
WIDE_FORMS = (lstm_seq, lstm_seq_train_fwd, lstm_seq_train_bwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in WIDE_FORMS:
        fn.wide_launches = 0


def launch_counts() -> Dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts.update({f"{fn.__name__}_wide": fn.wide_launches for fn in WIDE_FORMS})
    return counts
