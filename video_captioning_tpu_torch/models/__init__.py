"""The LSTM captioning model as nn.Modules plus the JAX package's eval functions."""
