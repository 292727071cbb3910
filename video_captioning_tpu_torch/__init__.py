"""PyTorch + CUDA port of video_captioning_tpu, for NVIDIA Hopper cards.

The serving path: precomputed features -> BiLSTM encoder -> Bahdanau LSTM
decoder -> greedy or beam search -> HTTP server, with hand-written CUDA
kernels where the JAX package has Pallas kernels (``ops/``). It imports
``torch`` and never ``jax``; the JAX package's jax-free configuration and
vocabulary modules are shared, and its inference packages load unchanged.
"""

from video_captioning_tpu.config import Config  # noqa: F401
from video_captioning_tpu.data.vocabulary import Vocabulary  # noqa: F401
