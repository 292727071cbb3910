"""PyTorch + CUDA port of video_captioning_tpu, for NVIDIA Hopper cards.

The serving path (precomputed features -> BiLSTM encoder -> Bahdanau LSTM
decoder -> greedy or beam search -> HTTP server) and the training path
(teacher-forced loss, optimizer, trainer, ``cli.train``), with
hand-written CUDA kernels where the JAX package has Pallas kernels
(``ops/``). It imports ``torch`` and never ``jax`` nor anything of the
JAX package: it keeps its own copies of the configuration, vocabulary and
other plain-Python modules, and the checkpoints and inference packages it
writes load in the JAX package and the other way round.
"""

from .config import Config  # noqa: F401
from .data.vocabulary import Vocabulary  # noqa: F401
