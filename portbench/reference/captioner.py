"""Plain PyTorch captioners: the LSTM family (BiLSTM encoder, Bahdanau
attention LSTM decoder with a deep output) and the transformer family
(pre-LN encoder-decoder), with teacher-forced scoring and a beam search.

Float32 throughout, with one stated exception: the encoder's recurrent
product takes bfloat16 h and W_hh with float32 sums, the numeric contract
of the configuration's ``kernels.use_pallas_lstm_seq`` recurrence (the
kernel's and its reference's). Whether float32 products run in TF32 is the
caller's choice (``torch.backends.cuda.matmul.allow_tf32``): the benchmark's
reference runs with it off, the control with it on.

Weights are the benchmark's tree in the inference package's layout (a
linear's ``kernel`` is (in, out)); nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NEG = -1e9


def _lin(p: dict, x: Tensor) -> Tensor:
    return x @ p["kernel"] + p["bias"]


def _cell(gates: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------- LSTM family


def lstm_encode(p: dict, feats: Tensor) -> Tuple[Tensor, Tensor]:
    """feats (B, T, F) -> encoder outputs (B, T, E), final state (B, E)."""
    enc = p["encoder"]
    x = _lin(enc["feature_projection"], feats)
    for layer in enc["lstm"]:
        outs, finals = [], []
        for d, rev in (("fwd", False), ("bwd", True)):
            w = layer[d]
            xs = torch.flip(x, (1,)) if rev else x
            xproj = xs @ w["w_ih"] + (w["b_ih"] + w["b_hh"])
            w_hh = _bf16(w["w_hh"])
            h = torch.zeros(x.shape[0], w_hh.shape[0], device=x.device)
            c = torch.zeros_like(h)
            hs = []
            for t in range(x.shape[1]):
                h, c = _cell(xproj[:, t] + _bf16(h) @ w_hh, c)
                hs.append(h)
            out = torch.stack(hs, dim=1)
            outs.append(torch.flip(out, (1,)) if rev else out)
            finals.append(h)
        x = torch.cat(outs, dim=-1)
    final = torch.cat(finals, dim=-1)  # the last layer's h of each direction
    return _lin(enc["output_projection"], x), _lin(enc["output_projection"], final)


class LSTMDecoder:
    """Decode steps over rows that each belong to a clip (``rows`` (N,)
    indexes the clip)."""

    def __init__(self, p: dict, enc_out: Tensor, final: Tensor):
        self.p = p["decoder"]
        self.enc = enc_out
        self.enc_proj = _lin(self.p["attention"]["encoder_projection"], enc_out)
        self.final = final

    def init_state(self, rows: Tensor):
        h0 = self.final[rows]
        if "init_state_projection" in self.p:
            h0 = _lin(self.p["init_state_projection"], h0)
        L = len(self.p["lstm"])
        return [h0] * L, [torch.zeros_like(h0)] * L

    def step(self, rows: Tensor, tokens: Tensor, state):
        """tokens (N,) -> logits (N, V), new state."""
        p, (hs, cs) = self.p, state
        emb = p["embedding"]["table"][tokens]
        att = p["attention"]
        dec_proj = _lin(att["decoder_projection"], hs[-1])                  # (N, A)
        e = torch.tanh(self.enc_proj[rows] + dec_proj[:, None, :])         # (N, S, A)
        scores = (e @ att["attention_linear"]["kernel"])[..., 0] + att["attention_linear"]["bias"]
        weights = torch.softmax(scores, dim=-1)
        ctx = (weights[:, None, :] @ self.enc[rows])[:, 0]                  # (N, E)
        x = torch.cat([emb, ctx], dim=-1)
        new_h, new_c = [], []
        for l, w in enumerate(p["lstm"]):
            h, c = _cell(x @ w["w_ih"] + hs[l] @ w["w_hh"] + w["b_ih"] + w["b_hh"], cs[l])
            new_h.append(h)
            new_c.append(c)
            x = h
        deep = torch.tanh(_lin(p["context_projection"], torch.cat([x, ctx, emb], dim=-1)))
        return _lin(p["output_projection"], deep), (new_h, new_c)

    @staticmethod
    def select(state, idx: Tensor):
        return [h[idx] for h in state[0]], [c[idx] for c in state[1]]


# --------------------------------------------------------- transformer family


def _ln(p: dict, x: Tensor) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], 1e-5)


def _mha(p: dict, q_in: Tensor, kv_in: Tensor, heads: int, causal: bool) -> Tensor:
    B, Tq, D = q_in.shape
    Tk, dh = kv_in.shape[1], D // heads
    q = _lin(p["wq"], q_in).reshape(B, Tq, heads, dh).transpose(1, 2)
    k = _lin(p["wk"], kv_in).reshape(B, Tk, heads, dh).transpose(1, 2)
    v = _lin(p["wv"], kv_in).reshape(B, Tk, heads, dh).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        s = s.masked_fill(~torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril(), NEG)
    ctx = torch.softmax(s, dim=-1) @ v
    return _lin(p["wo"], ctx.transpose(1, 2).reshape(B, Tq, D))


def _mlp(p: dict, x: Tensor) -> Tensor:
    return _lin(p["fc2"], F.gelu(_lin(p["fc1"], x), approximate="tanh"))


def transformer_encode(p: dict, feats: Tensor, heads: int) -> Tensor:
    enc = p["encoder"]
    x = _lin(enc["feature_projection"], feats) + enc["pos_embedding"][: feats.shape[1]]
    for blk in enc["blocks"]:
        h = _ln(blk["ln1"], x)
        x = x + _mha(blk["self_attn"], h, h, heads, False)
        x = x + _mlp(blk["mlp"], _ln(blk["ln2"], x))
    return _ln(enc["ln_f"], x)


class TransformerDecoder:
    """Each step runs the decoder over the whole prefix (no cache)."""

    def __init__(self, p: dict, enc_out: Tensor, heads: int):
        self.p, self.enc, self.heads = p["decoder"], enc_out, heads

    def logits(self, rows: Tensor, prefix: Tensor) -> Tensor:
        """prefix (N, T) tokens -> logits (N, T, V) at every position."""
        p = self.p
        x = p["embedding"]["table"][prefix] + p["pos_embedding"][: prefix.shape[1]]
        enc = self.enc[rows]
        for blk in p["blocks"]:
            h = _ln(blk["ln1"], x)
            x = x + _mha(blk["self_attn"], h, h, self.heads, True)
            x = x + _mha(blk["cross_attn"], _ln(blk["ln2"], x), enc, self.heads, False)
            x = x + _mlp(blk["mlp"], _ln(blk["ln3"], x))
        return _lin(p["output_projection"], _ln(p["ln_f"], x))

    def init_state(self, rows: Tensor):
        return rows.new_zeros((rows.shape[0], 0))

    def step(self, rows: Tensor, tokens: Tensor, prefix: Tensor):
        prefix = torch.cat([prefix, tokens[:, None]], dim=1)
        return self.logits(rows, prefix)[:, -1], prefix

    @staticmethod
    def select(state, idx: Tensor):
        return state[idx]


# ----------------------------------------------------------------- both


def decoder_for(config: dict, p: dict, feats: Tensor):
    m = config["model"]
    if m.get("architecture", "lstm") == "transformer":
        return TransformerDecoder(p, transformer_encode(p, feats, m["transformer_num_heads"]),
                                  m["transformer_num_heads"])
    return LSTMDecoder(p, *lstm_encode(p, feats))


def sequence_logprob(dec, tokens: Tensor, end: int, length_penalty: float) -> Tensor:
    """Teacher-forced score of each clip's generated tokens (B, L + 1),
    START first: the log-probabilities of the tokens up to the first END
    (or all L), over their count ** length_penalty."""
    B, L1 = tokens.shape
    rows = torch.arange(B, device=tokens.device)
    state = dec.init_state(rows)
    total = torch.zeros(B, device=tokens.device)
    length = torch.full((B,), L1 - 1, device=tokens.device)
    alive = torch.ones(B, dtype=torch.bool, device=tokens.device)
    for t in range(L1 - 1):
        logits, state = dec.step(rows, tokens[:, t], state)
        lp = torch.log_softmax(logits.float(), dim=-1).gather(1, tokens[:, t + 1:t + 2])[:, 0]
        total = total + torch.where(alive, lp, torch.zeros_like(lp))
        ended = alive & (tokens[:, t + 1] == end)
        length = torch.where(ended, torch.full_like(length, t + 1), length)
        alive = alive & ~ended
    return total / length.float() ** length_penalty


def beam_search(dec, B: int, K: int, L: int, start: int, end: int,
                length_penalty: float) -> Tuple[Tensor, Tensor]:
    """Beam search over the whole vocabulary: the best completed hypothesis
    by score / length ** length_penalty or, where none completed, the best
    live beam. Returns tokens (B, L + 1) and that score (B,)."""
    dev = dec.enc.device
    rows = torch.arange(B, device=dev).repeat_interleave(K)
    state = dec.init_state(rows)
    scores = torch.full((B, K), NEG, device=dev)
    scores[:, 0] = 0.0
    seqs = torch.full((B, K, L + 1), start, dtype=torch.int64, device=dev)
    fin_scores = torch.full((B, K), NEG, device=dev)
    fin_seqs = seqs.clone()
    tokens = seqs[:, :, 0].reshape(-1)
    for t in range(L):
        logits, state = dec.step(rows, tokens, state)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, -1)
        V = logp.shape[-1]
        top, idx = (scores[:, :, None] + logp).reshape(B, K * V).topk(K, dim=1)
        beam, tok = idx // V, idx % V
        seqs = torch.gather(seqs, 1, beam[..., None].expand(B, K, L + 1)).clone()
        seqs[:, :, t + 1] = tok
        state = dec.select(state, (torch.arange(B, device=dev)[:, None] * K + beam).reshape(-1))
        is_end = tok == end
        step_fin = torch.where(is_end, top / float(t + 1) ** length_penalty,
                               torch.full_like(top, NEG))
        merged = torch.cat([fin_scores, step_fin], dim=1)
        fin_scores, keep = merged.topk(K, dim=1)
        fin_seqs = torch.gather(torch.cat([fin_seqs, seqs], dim=1), 1,
                                keep[..., None].expand(B, K, L + 1))
        scores = torch.where(is_end, torch.full_like(top, NEG), top)
        tokens = tok.reshape(-1)
    best_live, live_idx = (scores / float(L) ** length_penalty).max(dim=1)
    live_seq = seqs[torch.arange(B, device=dev), live_idx]
    done = fin_scores[:, 0] > NEG / 2
    return (torch.where(done[:, None], fin_seqs[:, 0], live_seq),
            torch.where(done, fin_scores[:, 0], best_live))


def judge(config: dict, p: dict, feats: Tensor, served: Tensor, served_scores: Tensor, K: int,
          L: int, start: int, end: int, length_penalty: float) -> Dict[str, Tensor]:
    """For clips ``feats`` (n, T, F) and what was served for them (tokens
    (n, L + 1), beam scores (n,)), in nats a token:

    * ``score_gap``: the gap between each served score and the reference's
      teacher-forced score of the served tokens (the model and the scores);
    * ``beam_gap``: the gap between each served score and the score of the
      reference's own beam-K search (the selection: a served caption that is
      not the best the beam finds, or a beam that kept the wrong candidates,
      reads the difference of the two captions' scores).
    """
    dec = decoder_for(config, p, feats)
    ref_of_served = sequence_logprob(dec, served, end, length_penalty)
    _, best = beam_search(dec, feats.shape[0], K, L, start, end, length_penalty)
    return {"score_gap": (served_scores - ref_of_served).abs(),
            "beam_gap": (served_scores - best).abs()}


def serve(config: dict, p: dict, feats: Tensor, K: int, L: int, start: int, end: int,
          length_penalty: float) -> Tuple[Tensor, Tensor]:
    """The reference put in the program's place: its own beam search."""
    return beam_search(decoder_for(config, p, feats), feats.shape[0], K, L, start, end,
                       length_penalty)

