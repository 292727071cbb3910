"""Batched beam search on the device, without a host sync per step.

Counterpart of video_captioning_tpu/generation/beam.py: per step, the
top-K tokens of each live beam over the raw logits (the ``topk2d_lse``
kernel, which also gives the row logsumexp for the log-softmax) or, where
``fused_vocab_eligible`` holds, straight from the pre-vocab state (the
``vocab_topk_lse`` kernel: projection, top-K and logsumexp without the
logits ever reaching device memory), the top-K of the K*K candidates, a
completed-hypothesis register merged with the step's END candidates under
the length penalty score / (t+1)^alpha, and at the end the best completed
sequence per clip or, where none completed, the best live beam.

Every top-k here uses ``lax.top_k``'s tie order (ops.topk.topk_stable);
the completed register is full of equal -1e9 entries whose slot order
decides ``all_tokens``. The JAX loop stops when no beam in the whole batch
is live (or at max_length). Here the loop runs max_length steps without a
host sync and freezes every output of the carry with
``torch.where(active, new, old)`` once nothing is live, so they and the
step count ``t_final`` are the JAX loop's. The decode state is not frozen:
once ``active`` is false it stays false, so a later state only feeds
outputs that are thrown away (the transformer's caches are written in
place, where a ``where`` would copy them whole). (With K >= 2 a live beam
always proposes K - 1 candidates other than END, so only K = 1 can end
early.)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config

from ..models.captioner import VideoCaptioningModel
from ..ops.topk import topk2d_lse, topk_stable
from ..ops.vocab_topk import pad_vocab_weights, vocab_row_block_fits, vocab_topk_lse
from .families import make_decode_family

Tensor = torch.Tensor

NEG_INF = -1e9
# Rows the JAX kernel's VMEM budget takes; kept so both packages take the
# fused path for the same batches.
FUSED_VOCAB_MAX_ROWS = 2560


def fused_vocab_eligible(config: Config, device: torch.device, B: int, K: int, V: int) -> bool:
    """The JAX gate of the fused vocabulary path (beam.py:88-94): the flag is
    set, B*K <= 2560 and min(K, V) <= 16, and where the JAX package asks for
    a TPU backend, the tensors are on CUDA; elsewhere the hierarchical
    float32 path runs, as the JAX package's does off the TPU. (Its other
    condition, an unquantized vocabulary projection, always holds: the port
    has no int8 decode.) The port's kernel adds its own domain: a row block
    of the pre-vocab state (decoder_hidden_dim wide) fits in shared memory
    (``vocab_row_block_fits``). Tests force the fused path on the CPU by
    patching this function."""
    return (config.kernels.use_fused_vocab_topk and device.type == "cuda"
            and B * K <= FUSED_VOCAB_MAX_ROWS and min(K, V) <= 16
            and vocab_row_block_fits(config.model.decoder_hidden_dim))


def beam_search_generate(
    model: VideoCaptioningModel,
    config: Config,
    encoder_outputs: Tensor,
    encoder_final_state: Tensor,
    start_token_id: int,
    end_token_id: int,
    max_length: int = 20,
    encoder_mask: Optional[Tensor] = None,
    beam_size: int = 5,
    length_penalty: float = 1.0,
) -> Dict[str, Tensor]:
    """Returns ``generated_tokens`` (B, max_length+1) starting with START,
    ``all_tokens`` (B, K, max_length+1) and ``all_scores`` (B, K)."""
    B = encoder_outputs.shape[0]
    dev = encoder_outputs.device
    K = beam_size
    V = model.decoder.output_projection.out_features
    L = max_length + 1
    kk = min(K, V)
    family = make_decode_family(model, config, encoder_outputs, encoder_final_state,
                                encoder_mask, num_beams=K, max_length=max_length)
    state = family.state0
    use_fused_vocab = fused_vocab_eligible(config, dev, B, K, V)
    if use_fused_vocab:  # once per call, outside the loop
        out_proj = model.decoder.output_projection
        w_pad, b_pad, _ = pad_vocab_weights(out_proj.weight.T, out_proj.bias)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    sequences = full((B, K, L), start_token_id, torch.int64)
    scores = torch.where(torch.arange(K, device=dev) == 0, 0.0, NEG_INF).to(torch.float32)
    scores = scores[None, :].expand(B, K).contiguous()
    fin_seqs = full((B, K, L), start_token_id, torch.int64)
    fin_scores = full((B, K), NEG_INF, torch.float32)
    last_tokens = full((B, K), start_token_id, torch.int64)
    t_final = torch.zeros((), dtype=torch.int64, device=dev)
    positions = torch.arange(L, device=dev)[None, None, :]

    for t in range(max_length):
        active = (scores > NEG_INF / 2).any()
        if use_fused_vocab:
            pre_vocab, new_state, _ = family.step_beam_core(last_tokens, state, t)
            top_logits, top_tokens, lse = vocab_topk_lse(pre_vocab, w_pad, b_pad, kk)
        elif config.kernels.use_pallas_topk:
            logits, new_state, _ = family.step_beam(last_tokens, state, t)
            logits32 = logits.float().reshape(B * K, -1)
            top_logits, top_tokens, lse = topk2d_lse(logits32, kk)
        else:
            logits, new_state, _ = family.step_beam(last_tokens, state, t)
            logits32 = logits.float().reshape(B * K, -1)
            top_logits, top_tokens = topk_stable(logits32, kk)
            row_max = top_logits[:, 0]
            lse = row_max + torch.log(torch.sum(torch.exp(logits32 - row_max[:, None]), dim=-1))
        top_logits = top_logits.reshape(B, K, kk)
        top_tokens = top_tokens.reshape(B, K, kk).to(torch.int64)
        cand = scores[:, :, None] + (top_logits - lse.reshape(B, K)[..., None])
        top_scores, flat_idx = topk_stable(cand.reshape(B, K * kk), K)
        beam_idx = flat_idx // kk
        token_idx = torch.gather(top_tokens.reshape(B, K * kk), 1, flat_idx)

        gathered = torch.gather(sequences, 1, beam_idx[..., None].expand(B, K, L))
        new_sequences = torch.where(positions == t + 1, token_idx[..., None], gathered)
        state = family.rebeam(new_state, beam_idx)

        is_end = token_idx == end_token_id
        gen_len = torch.tensor(float(t + 1), dtype=torch.float32, device=dev)
        penalized = top_scores / torch.pow(gen_len, length_penalty)
        step_fin = torch.where(is_end, penalized, NEG_INF)
        merged_scores = torch.cat([fin_scores, step_fin], dim=1)
        merged_seqs = torch.cat([fin_seqs, new_sequences], dim=1)
        new_fin_scores, keep = topk_stable(merged_scores, K)
        new_fin_seqs = torch.gather(merged_seqs, 1, keep[..., None].expand(B, K, L))
        new_scores = torch.where(is_end, NEG_INF, top_scores)

        t_final = t_final + active.to(torch.int64)
        last_tokens = torch.where(active, token_idx, last_tokens)
        sequences = torch.where(active, new_sequences, sequences)
        scores = torch.where(active, new_scores, scores)
        fin_seqs = torch.where(active, new_fin_seqs, fin_seqs)
        fin_scores = torch.where(active, new_fin_scores, fin_scores)

    # Clips with no completed hypothesis fall back to their best live beam.
    best_live_idx = torch.argmax(scores, dim=1)
    best_live_seq = torch.gather(
        sequences, 1, best_live_idx[:, None, None].expand(B, 1, L))[:, 0]
    has_completed = fin_scores[:, 0] > NEG_INF / 2
    best_seq = torch.where(has_completed[:, None], fin_seqs[:, 0], best_live_seq)

    # Empty register slots take the live beams, normalized like completed
    # hypotheses (a live beam at exit holds t_final generated tokens).
    live_len = torch.clamp(t_final, min=1).to(torch.float32)
    live_penalized = torch.where(
        scores > NEG_INF / 2, scores / torch.pow(live_len, length_penalty), NEG_INF)
    live_fill = fin_scores <= NEG_INF / 2
    return {
        "generated_tokens": best_seq.to(torch.int32),
        "all_tokens": torch.where(live_fill[..., None], sequences, fin_seqs).to(torch.int32),
        "all_scores": torch.where(live_fill, live_penalized, fin_scores),
    }
