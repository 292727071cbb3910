"""Floating-point operations of the whole model a call needs, counted from
the configuration's shapes: a multiply-add is two operations; elementwise
work and softmaxes are left out (under 1% at these widths), so the counts
are a little low, never high.
"""

from __future__ import annotations


def _lstm_captioner(m: dict, B: int, K: int, L: int, S: int) -> float:
    F, E, D = m["cnn_feature_dim"], m["encoder_hidden_dim"], m["decoder_hidden_dim"]
    emb, A, V = m["embedding_dim"], m["attention_dim"], m["vocab_size"]
    enc = 2.0 * B * S * F * E
    for l in range(m["encoder_num_layers"]):
        n_in = E if l == 0 else 2 * E
        enc += 2 * (2.0 * B * S * n_in * 4 * E + 2.0 * B * S * E * 4 * E)
    enc += 2.0 * B * S * 2 * E * E + 2.0 * B * S * E * A
    N = B * K
    step = 2.0 * N * D * A + 3.0 * N * S * A + 2.0 * N * S * E
    for l in range(m["decoder_num_layers"]):
        n_in = emb + E if l == 0 else D
        step += 2.0 * N * (n_in + D) * 4 * D
    step += 2.0 * N * (E + D + emb) * D + 2.0 * N * D * V
    return enc + L * step


def _transformer_captioner(m: dict, B: int, K: int, L: int, S: int) -> float:
    F, D, V = m["cnn_feature_dim"], m["decoder_hidden_dim"], m["vocab_size"]
    R = m["transformer_mlp_ratio"] * D
    enc = 2.0 * B * S * F * D + m["transformer_num_layers"] * (
        8.0 * B * S * D * D + 4.0 * B * S * S * D + 4.0 * B * S * D * R)
    blocks = m["transformer_decoder_layers"]
    enc += blocks * 4.0 * B * S * D * D  # the cross keys and values, once a call
    N = B * K
    dec = 0.0
    for t in range(L):
        dec += blocks * (8.0 * N * D * D + 4.0 * N * (t + 1) * D + 4.0 * N * D * D
                         + 4.0 * N * S * D + 4.0 * N * D * R)
        dec += 2.0 * N * D * V
    return enc + dec


def captioner_flops(m: dict, B: int, K: int, L: int) -> float:
    """One beam-K decode of L tokens for B clips, encoder included."""
    S = m["video_sequence_length"]
    if m.get("architecture", "lstm") == "transformer":
        return _transformer_captioner(m, B, K, L, S)
    return _lstm_captioner(m, B, K, L, S)


def resnet50_flops_per_frame(size: int = 224) -> float:
    """ResNet-50 without fc on one size x size frame."""
    def conv(hw_out, cin, cout, k):
        return 2.0 * hw_out * hw_out * cin * cout * k * k

    hw = size // 2
    total = conv(hw, 3, 64, 7)
    hw //= 2
    cin = 64
    for s, (n, w) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            out = hw // stride
            total += conv(hw, cin, w, 1) + conv(out, w, w, 3) + conv(out, w, 4 * w, 1)
            if b == 0:
                total += conv(out, cin, 4 * w, 1)
            hw, cin = out, 4 * w
    return total
