"""Configuration of video_captioning_tpu_torch: the JAX package's schema,
field for field, in the port's own module.

A package's ``model_config`` (``Config.to_dict()``) written by either
package reads here with ``Config.from_dict`` and writes back unchanged, so
checkpoints and inference packages move between the two. The tree keeps
every knob of the JAX package, including the ``KernelConfig`` gates that
only steer the TPU's lowering; the port reads the gates it has a kernel
for (``use_pallas_lstm_seq``, ``use_pallas_lstm_seq_train``,
``use_pallas_topk``, ``use_pallas_attention``, ``use_pallas_lstm``,
``use_fused_vocab_topk``, ``attention_score_bf16``, ``interpret``) and the
transformer's options that change values (``generation/families.py``),
and ignores only knobs that leave results unchanged; an architecture it
does not know is refused (``models/captioner.py:check_supported``).

Plain Python: nothing here imports torch or jax.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


@dataclass
class ModelConfig:
    """Model architecture configuration (parity: reference config.py:9-31)."""

    # Encoder
    cnn_feature_dim: int = 4096
    encoder_hidden_dim: int = 512
    encoder_num_layers: int = 2
    encoder_dropout: float = 0.3

    # Decoder
    decoder_hidden_dim: int = 512
    decoder_num_layers: int = 2
    decoder_dropout: float = 0.3
    vocab_size: int = 10000
    embedding_dim: int = 512

    # Attention
    attention_dim: int = 512
    use_attention: bool = True
    # New (fixes reference decoder.py:38 hardcode): bahdanau | luong | multihead
    attention_type: str = "bahdanau"
    # Luong score function: dot | general | concat (reference attention.py:79)
    luong_score: str = "general"
    attention_num_heads: int = 8

    # Sequences
    max_sequence_length: int = 20
    video_sequence_length: int = 80

    # Model family (no reference analog — the reference is LSTM-only).
    # "lstm": reference-parity BiLSTM encoder + attention LSTM decoder.
    # "transformer": TPU-first pre-LN encoder-decoder transformer
    # (models/transformer.py): teacher forcing is ONE fully parallel pass
    # (no sequential scan), decode runs on-device with per-layer KV caches.
    # The transformer family reads ONLY the transformer_* knobs below plus
    # the shared dims; the LSTM-only knobs (use_attention, attention_type,
    # luong_score, attention_dim, attention_num_heads, encoder_num_layers,
    # decoder_num_layers, *_dropout) have no effect on it.
    architecture: str = "lstm"
    transformer_num_layers: int = 2        # encoder self-attention blocks
    transformer_decoder_layers: int = 2    # decoder blocks
    transformer_num_heads: int = 8
    transformer_mlp_ratio: int = 4
    transformer_dropout: float = 0.1


@dataclass
class DataConfig:
    """Data processing configuration (parity: reference config.py:34-61)."""

    data_root: Path = Path("data")
    video_dir: Path = Path("data/videos")
    features_dir: Path = Path("data/features")
    captions_file: Path = Path("data/captions.csv")

    img_size: Tuple[int, int] = (224, 224)
    frames_per_video: int = 80
    frame_sampling_rate: int = 1

    train_split: float = 0.8
    val_split: float = 0.1
    test_split: float = 0.1

    vocab_threshold: int = 5
    max_vocab_size: int = 10000

    pad_token: str = "<PAD>"
    start_token: str = "<START>"
    end_token: str = "<END>"
    unk_token: str = "<UNK>"


@dataclass
class TrainingConfig:
    """Training configuration (parity: reference config.py:64-90)."""

    batch_size: int = 32
    num_epochs: int = 100
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    gradient_clip_norm: float = 5.0

    optimizer: str = "adam"  # adam | adamw | sgd
    scheduler: str = "cosine"  # cosine | step | plateau | none
    warmup_epochs: int = 5

    label_smoothing: float = 0.1

    val_every_n_epochs: int = 1
    save_every_n_epochs: int = 5
    early_stopping_patience: int = 10

    # Host input pipeline
    num_workers: int = 4
    prefetch_batches: int = 2
    seed: int = 42

    # TPU-first knobs (no reference analog; the reference is fp32 single-GPU)
    compute_dtype: str = "float32"  # float32 | bfloat16
    donate_state: bool = True
    # Freeze the video encoder (reference freeze_encoder,
    # video_captioning_model.py:308-316) — optax multi_transform masking.
    freeze_encoder: bool = False
    # Failure detection: abort on non-finite loss after this many
    # consecutive bad steps (0 disables). The reference has no failure
    # detection at all (SURVEY §5).
    max_bad_steps: int = 3
    # Rematerialize the per-step (B, S, A) attention-score tensor in the
    # backward pass instead of staging it as a scan residual (~420 MB of
    # HBM write+read per step at reference scale for ~35 µs of recompute;
    # values and gradients unchanged — models/decoder.py:apply_decoder).
    remat_attention: bool = True
    # Exponential moving average of the parameters, updated after every
    # optimizer step (ema = d*ema + (1-d)*params). 0 disables. When on,
    # validation, best-model selection, and the exported inference package
    # use the EMA weights; raw weights still drive optimization and
    # checkpoints carry both.
    ema_decay: float = 0.0
    # Gradient accumulation: split each loader batch into this many
    # micro-batches inside the jitted step (lax.scan), average the
    # gradients, apply ONE optimizer update. Scales effective batch size
    # past HBM limits without touching the input pipeline; batch_size must
    # be divisible by it. Note the reference-parity loss is a per-batch
    # token mean, so with ragged captions the accumulated mean weights
    # micro-batches equally rather than by token count (standard behavior).
    grad_accum_steps: int = 1


@dataclass
class InferenceConfig:
    """Inference configuration (parity: reference config.py:93-104)."""

    search_method: str = "beam"  # beam | greedy
    beam_size: int = 5
    max_length: int = 20
    length_penalty: float = 1.0

    remove_special_tokens: bool = True
    capitalize_first: bool = True


@dataclass
class ParallelConfig:
    """Device-mesh configuration. The reference has no distributed support
    (verified: zero NCCL/Gloo/MPI/torch.distributed usage); this is the
    TPU-native replacement: a ``(data, model)`` mesh consumed by
    ``video_captioning_tpu.parallel``.
    """

    data_axis: int = -1  # -1 = all remaining devices
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")
    # Context parallelism: name of the mesh axis to shard the FRAME axis of
    # cross-attention over (online-softmax combine across shards). None =
    # off. Generation/eval paths route attend/attend_beam through
    # parallel.context_parallel when set; requires an ambient mesh
    # (jax.sharding.set_mesh) or an explicit mesh at the call site.
    context_axis: Optional[str] = None


@dataclass
class KernelConfig:
    """Pallas kernel gates. Each fused kernel is flag-gated with an XLA
    fallback so correctness never depends on Mosaic availability."""

    use_pallas_attention: bool = False
    use_pallas_lstm: bool = False
    # Whole-sequence encoder LSTM kernel (ops/lstm_seq_pallas.py):
    # recurrent weights stay VMEM-resident across all T steps, no per-step
    # update-slices. TPU eval paths only (no custom VJP; training keeps
    # lax.scan). Measured +2.1% e2e beam-5 with bit-identical tokens
    # (docs/PERFORMANCE.md).
    use_pallas_lstm_seq: bool = True
    # Training-path variant of the same kernel with a custom VJP: the
    # backward sweep also runs as one Pallas kernel (recurrent weights and
    # the dW_hh accumulator VMEM-resident across all T reverse steps),
    # replacing XLA's reverse scan + residual dynamic-slices
    # (ops/lstm_seq_pallas.py:lstm_seq_train). Measured on one v5e chip at
    # B=256: training fwd+bwd+adam 7772 -> 9230 clips/s bf16 (+18.8%),
    # 5043 -> 6266 fp32 (+24.3%) — docs/PERFORMANCE.md.
    use_pallas_lstm_seq_train: bool = True
    # Fused vocab-projection + top-k + logsumexp in the beam loop
    # (ops/vocab_topk_pallas.py): TPU-only. Measured SLOWER than the
    # hierarchical XLA path at reference scale (round-5 at-HEAD A/B:
    # transformer fp32 8,656 vs 9,018 clips/s, −4%; round-2 B=64 was
    # neutral) — kept as infrastructure, default off. Beam tokens agree
    # with the XLA path on ~97% of random-init clips, not 100%: the
    # kernel's online logsumexp sums in a different order, which shifts a
    # beam row's candidates uniformly and flips near-tied cross-beam
    # selections — see the kernel docstring's exactness contract (top-k
    # values/indices/tie order exact; lse to f32 rounding).
    use_fused_vocab_topk: bool = False
    # Streaming Pallas top-k + logsumexp (ops/topk_pallas.py) for the
    # beam loop's (B·K, V) expansion in place of lax.top_k's TopK custom
    # call + a separate logsumexp fusion (one pass over the logits).
    # Identical values/tie order; non-lane-multiple vocabs are padded
    # with -inf inside; off-TPU the path falls back to lax.top_k exactly.
    # Default ON: the round-5 at-HEAD chip A/B (benchmarks/
    # ab_beam_flags.json ptopk_off arms, beam-5 B=256) measured +8.6%
    # transformer fp32 / +8.6% bf16, +3.5% LSTM fp32 / +12.6% bf16, with
    # clip_agreement_vs_base = 1.0 on all four arms.
    use_pallas_topk: bool = True
    interpret: bool = False  # force interpreter mode (CPU testing)
    # Compute additive-attention scores (the profiled decode hot spot: 52M
    # tanh/step at reference scale) in bfloat16 while keeping softmax and
    # context fp32. Opt-in: slightly perturbs scores, so token-level parity
    # holds only with it off.
    attention_score_bf16: bool = False
    # Batch-chunk the Bahdanau BEAM score fusion into <=N-row pieces
    # (0 = off). Motivation: the (B, K, S, A) tanh+reduce fusion falls
    # to half its elementwise rate past ~26M elements (the B>=160 cliff
    # behind the sharp B=128 serving optimum — beam_batch_scaling.json,
    # profile_beam round 5: 158 µs/step at B=256 vs 2x42 expected).
    # MEASURED NEGATIVE on chip (ab_beam_flags achunk arms, B=256 fp32,
    # agreement 1.0): 15,161 (chunk 128) / 15,118 (chunk 64) vs 15,981
    # base — per-chunk scheduling + the concat cost more than the cliff;
    # the B=128 optimum evidently involves the whole step's schedule
    # (enc-proj relayout copies included), not this fusion alone. Kept
    # as gated, tested infrastructure; serve at B=128 instead.
    attention_score_chunk: int = 0
    # ResNet50 inference-forward variant (models/backbones/resnet.py):
    #   xla       - per-op conv+BN+ReLU graph (reference-shaped)
    #   folded    - frozen BN folded into conv weights (fewer HBM-bound
    #               elementwise ops; fp32-rounding-level numerics delta)
    #   fused     - folded + whole-bottleneck Pallas kernel for stride-1
    #               identity blocks (intermediates VMEM-resident)
    #   fused_s2d - fused + exact space-to-depth stem rewrite
    #   int8      - W8A8 static PTQ (models/backbones/resnet_int8.py):
    #               per-channel int8 weights, calibrated per-site activation
    #               scales, int8 MXU convs + int8 inter-op activations.
    #               Opt-in ONLY — approximate features (error gated in
    #               tests/test_backbones.py), for HBM-bound serving.
    # All variants are parity-gated in tests/test_backbones.py. On-chip
    # A/B at B=320 (benchmarks/cnn_results.json): folded wins (+2.4% bf16,
    # +13% fp32 over xla); fused measured a 34% LOSS (bt=1 tiles and the
    # stage-1 Cm=64 matmuls underutilize the MXU, swamping the HBM-traffic
    # savings) and s2d was neutral — both kept flag-gated for the record.
    resnet50_variant: str = "folded"
    # Transformer-family beam search: rebeam the self-attention KV caches
    # LAZILY via a (B, K, T) ancestry-index carry instead of physically
    # gathering both (n_blocks, B·K, T, D) cache tensors every step.
    # Columns of the physical cache are write-once (position t is written
    # exactly once), so attention can score against all K physical rows
    # (a K× expansion of the tiny (B, K, h, T) score tensor) and select
    # with the one-hot ancestry — the big caches are read once and written
    # one row per step. Token/score-identical to physical rebeaming
    # (gated in tests/test_transformer.py); pure-XLA, no kernel.
    transformer_lazy_rebeam: bool = True
    # Store the transformer decode self-attention KV caches in bfloat16
    # while the residual stream / scores / softmax stay in the state dtype
    # (fp32 by default). The attention dots already run on bf16 operand
    # copies under XLA's DEFAULT precision, so fp32 cache STORAGE buys no
    # matmul precision — only 2x the dominant per-step HBM read plus a
    # per-step fp32→bf16 conversion copy of both (n_blocks, B·K, T, D)
    # tensors (profiled, docs/PERFORMANCE.md round 3). The only numeric
    # change is the stored K/V rounding to bf16; token agreement is gated
    # in tests/test_transformer.py. Off by default: fp32 caches keep
    # decode bit-identical to the parallel teacher-forcing oracle.
    transformer_cache_bf16: bool = False
    # Store the transformer decode CROSS-attention K/V in bfloat16. On
    # the beam path (K>1, non-fused) this pre-stages them in the
    # (B, h, dh, S) OPERAND layout the decode loop's DEFAULT-precision
    # attention dots consume (precompute_cross_kv operand_layout=True;
    # _cross_attn_step_operand), targeting the per-step f32→bf16 relayout
    # copies the round-4 profile showed. MEASURED NEGATIVE in every form
    # (ab_beam_flags, beam-5 B=256, agreement 1.0): operand layout 6,183
    # vs 8,838 clips/s f32 (−30%) and 6,193 vs 8,041 bf16 (−23%) — the
    # head-split (B, h, dh, S) batching fragments the score/context dots
    # into tiny per-(b,h) matmuls, costing far more than the conversion
    # DMA it hoists (which XLA overlaps well); plain bf16 (B, S, D)
    # storage lost ~28% (round 4); a head-major pre-transpose lost ~50%
    # on greedy (round 3). Kept as gated, tested infrastructure for the
    # record; the per-step conversions are instead attacked from the
    # WEIGHT side (transformer_decode_weights_bf16 below), which is where
    # the round-5 profile showed the un-overlapped cost. Default off.
    transformer_cross_kv_bf16: bool = False
    # Fused transformer beam-decode attention Pallas kernels
    # (ops/transformer_attn_pallas.py): the ancestry-select cached
    # self-attention and the one-query cross-attention each run as ONE
    # Pallas pass with fp32-in-VMEM softmax — the lazy-rebeam selection
    # happens by one-hot gather BEFORE the score dot (no (B, K, h, j, T)
    # expansion or re-expansion intermediates), and bf16 cache/KV storage
    # skips XLA's packed-layout softmax cliff natively. Applies to the
    # lazy-rebeam beam path only (greedy and CP keep XLA). Numerical
    # parity gated in tests/test_pallas_kernels.py; token identity in
    # tests/test_transformer.py.
    transformer_fused_beam_attn: bool = False
    # Keep the transformer beam decode state (residual stream, KV caches,
    # cross-KV) natively bf16 under bf16 params instead of the round-3
    # forced-fp32-state hybrid. The round-4 per-op profile showed the
    # hybrid's cost: per-step f32<->bf16 conversion fusions of the
    # cross-KV, per-step staging copies of the bf16 weights against f32
    # activations, and packed-layout relayouts. With attention scores
    # produced as f32 via preferred_element_type (models/transformer.py)
    # the packed-softmax cliff that motivated the hybrid no longer
    # applies. A/B'd on chip in benchmarks/ab_beam_flags.py.
    transformer_bf16_beam_state: bool = False
    # Auto-upcast the transformer DECODER params to fp32 for beam decode
    # when they arrive bf16 (VERDICT r4 item 2). Under bf16 params the
    # beam loop measured SLOWER than fp32 (8,046 vs 8,846 clips/s at
    # B=256 — round-4 transformer_results.json): the fp32-state hybrid
    # re-stages bf16 weights against f32 activations every step. The
    # upcast happens ONCE per generation call (~27M params, ~0.2 ms,
    # amortized over the whole beam batch) and makes the loop the same
    # program as the fp32 arm; values are the bf16 ones, just stored
    # wide. Greedy keeps bf16 params (measured +48% there). Chip A/B in
    # benchmarks/ab_beam_flags.json (beam_params_f32 arms).
    transformer_beam_params_f32: bool = True
    # Pre-cast the transformer decode loop's weight KERNELS to bf16 once
    # per generation call (models/transformer.py:
    # stage_decode_weights_bf16), greedy and beam. On TPU this is
    # bit-identical to the plain f32 program — XLA's DEFAULT dot
    # precision truncates operands to bf16 anyway — but hoists the
    # weight-side f32→bf16 conversion copies the round-5 profile found
    # INSIDE the while loop every step (block linears + chunked
    # vocab-projection re-staging, several ms/batch at B=256 beam-5).
    # Applied only when the backend is TPU; CPU keeps true-f32 dots so
    # the CPU parity gates stay exact. Chip A/B in
    # benchmarks/ab_beam_flags.json (wstage arms).
    transformer_decode_weights_bf16: bool = True
    # LSTM-family analog of transformer_decode_weights_bf16: pre-cast the
    # LSTM decode loop's in-loop weight matrices (cell w_ih/w_hh, deep
    # output, vocab projection, per-step attention linears) to bf16 once
    # per generation call (models/decoder.py:stage_decode_weights_bf16).
    # Bit-identical on TPU (DEFAULT dot precision), TPU-gated so the
    # CPU-run reference-parity gates stay exact. Not applied when
    # kernels.use_pallas_lstm drives the cell (that kernel manages its
    # own operand staging). Chip A/B in benchmarks/ab_beam_flags.json.
    lstm_decode_weights_bf16: bool = True
    # Run the transformer decode ATTENTION dots (cached self-attn scores/
    # context, cross-attn scores/context) at Precision.HIGHEST — true-f32
    # multi-pass MXU — instead of DEFAULT's bf16 truncation. Rationale:
    # the decode-loop profile attributes most non-matmul time to XLA's
    # per-step f32→bf16 operand-conversion copies of the cross-KV and
    # caches; HIGHEST consumes the f32 operands DIRECTLY (no conversion),
    # and at this scale the extra passes are noise (~0.4 GFLOP/step of
    # attention dots vs 21 GFLOP of linears). Numerics: slightly MORE
    # accurate than DEFAULT (never less); tokens may differ from the
    # bf16-truncated path at near-ties. Chip A/B in ab_beam_flags.json
    # (attnf32 arms).
    transformer_attn_dots_f32: bool = False
    # Beam self-attention ancestry selection as a take_along_axis GATHER
    # (+ broadcast-multiply re-expansion) instead of the two one-hot
    # einsums. Values are exactly equal (a gather selects; x*1/x*0 masks —
    # no summation), so tokens/scores are bit-identical; the flag only
    # changes the lowered op mix — the profiled (B,K,T,h) select fusions
    # are ~6x lane-padded at reference scale and cost ~370 us/step of the
    # 1.42 ms transformer beam step. Chip A/B in ab_beam_flags.json (gsel
    # arms).
    transformer_select_gather: bool = False
    # Route ONLY the beam loop's cross-attention through the fused Pallas
    # kernel (ops/transformer_attn_pallas.py:beam_cross_attention),
    # keeping the XLA ancestry-select self-attention. The monolithic
    # transformer_fused_beam_attn measured 3.4x slower and the regression
    # was attributed to the SELF-attention kernel's per-lane-block
    # ancestry recompute; the cross kernel alone (one pass, fp32-in-VMEM
    # softmax, no per-step relayout conversion copies) was never A/B'd
    # standalone. Chip A/B in benchmarks/ab_beam_flags.json (fcross arms).
    transformer_fused_cross_attn: bool = False
    # Merge each decoder block's self-attention wq/wk/wv into ONE fused
    # (D, 3D) linear for the BEAM decode loop, built once per generation
    # call (models/transformer.py:merge_self_attn_qkv). XLA does not
    # merge separate dots, so the three back-to-back (N, D)x(D, D)
    # matmuls on the same activation each re-read x and pay their own
    # dispatch; the fused form reads x once. Default ON, beam-only: chip
    # A/B (ab_beam_flags qkv arms) measured +1.3% fp32 B=256 with clip
    # agreement 1.0 (output columns of a matmul are independent lanes,
    # so the merge is bit-identical when accumulation is f32 — the beam
    # path upcasts/stages params so it always is). NOT applied at K=1:
    # greedy measured neutral (+0.1%) and under true-bf16 greedy params
    # the merged matmul's different contraction blocking flips ~16% of
    # random-init clips (agreement 0.84) — not worth a numerics change.
    transformer_merge_qkv: bool = True
    # Route the int8 ResNet50's stride-1 1x1 convs through fused Pallas
    # int8 matmul+requant kernels (ops/int8_matmul_pallas.py): the s32
    # conv accumulator stays in VMEM and the dequant/residual/ReLU/requant
    # epilogue is fused — targets the stage-1 requant fusions and
    # s32-emitting 1x1-conv the round-3 int8 profile identified.
    # A/B'd on chip (VERDICT r3 item 7); same math, parity gated in tests.
    int8_conv1x1_pallas: bool = False


@dataclass
class ExperimentConfig:
    """Experiment tracking configuration (parity: reference config.py:107-125)."""

    experiment_name: str = "video_captioning"
    project_name: str = "video-captioning-tpu"

    log_every_n_steps: int = 100
    use_wandb: bool = False
    use_tensorboard: bool = True
    profile_dir: Optional[Path] = None

    checkpoint_dir: Path = Path("checkpoints")
    best_model_path: Path = Path("checkpoints/best_model.pth")
    # "native": reference-compatible single-file checkpoints (pickled numpy,
    # same names/schema as the reference). "orbax": async sharded
    # checkpoints for multi-chip production runs (utils/orbax_ckpt.py).
    checkpoint_backend: str = "native"

    output_dir: Path = Path("outputs")
    predictions_file: Path = Path("outputs/predictions.json")

    # Persistent XLA compilation cache (jax_compilation_cache_dir). First
    # compile of the beam program is tens of seconds at production scale;
    # with a warm cache, serving/training restarts skip it. None = off.
    compilation_cache_dir: Optional[Path] = None


@dataclass
class Config:
    """Main configuration tree (parity: reference config.py:128-150)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    kernels: KernelConfig = field(default_factory=KernelConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)

    # When True (reference behavior, config.py:139-143) directories are
    # auto-created at construction. Tests set this False to avoid touching cwd.
    create_dirs: bool = False

    def __post_init__(self) -> None:
        self.validate()
        if self.create_dirs:
            self.ensure_dirs()

    def validate(self) -> None:
        total = self.data.train_split + self.data.val_split + self.data.test_split
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"Data splits must sum to 1.0, got {total}")
        # Keep vocab bound in sync (reference config.py:150)
        self.model.vocab_size = self.data.max_vocab_size
        if self.model.attention_type not in ("bahdanau", "luong", "multihead"):
            raise ValueError(f"Unknown attention_type: {self.model.attention_type}")
        if self.model.luong_score not in ("dot", "general", "concat"):
            raise ValueError(f"Unknown luong_score: {self.model.luong_score}")
        if self.model.encoder_hidden_dim % self.model.attention_num_heads != 0:
            raise ValueError("encoder_hidden_dim must be divisible by attention_num_heads")
        if self.model.architecture not in ("lstm", "transformer"):
            raise ValueError(f"Unknown architecture: {self.model.architecture}")
        if self.model.architecture == "transformer":
            if self.model.encoder_hidden_dim != self.model.decoder_hidden_dim:
                raise ValueError(
                    "transformer architecture requires encoder_hidden_dim == "
                    "decoder_hidden_dim (shared d_model)"
                )
            if self.model.decoder_hidden_dim % self.model.transformer_num_heads != 0:
                raise ValueError(
                    "decoder_hidden_dim must be divisible by transformer_num_heads"
                )
            if self.model.embedding_dim != self.model.decoder_hidden_dim:
                raise ValueError(
                    "transformer architecture ties the token embedding width to "
                    "d_model: embedding_dim must equal decoder_hidden_dim "
                    f"(got {self.model.embedding_dim} vs "
                    f"{self.model.decoder_hidden_dim})"
                )
            if self.data.frames_per_video > self.model.video_sequence_length:
                raise ValueError(
                    "transformer architecture's learned frame positions cover "
                    "video_sequence_length rows; data.frames_per_video="
                    f"{self.data.frames_per_video} exceeds model."
                    f"video_sequence_length={self.model.video_sequence_length}"
                )
        if (
            self.parallel.context_axis is not None
            and self.parallel.context_axis not in self.parallel.axis_names
        ):
            raise ValueError(
                f"context_axis {self.parallel.context_axis!r} is not one of "
                f"axis_names {self.parallel.axis_names}"
            )
        if self.kernels.resnet50_variant not in (
            "xla", "folded", "fused", "fused_s2d", "int8"
        ):
            raise ValueError(
                f"Unknown resnet50_variant: {self.kernels.resnet50_variant}"
            )
        if self.training.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if not (0.0 <= self.training.ema_decay < 1.0):
            raise ValueError("ema_decay must be in [0, 1)")
        if self.training.batch_size % self.training.grad_accum_steps != 0:
            raise ValueError(
                f"batch_size={self.training.batch_size} must be divisible by "
                f"grad_accum_steps={self.training.grad_accum_steps}"
            )

    def ensure_dirs(self) -> None:
        for p in (
            self.data.data_root,
            self.data.video_dir,
            self.data.features_dir,
            self.experiment.checkpoint_dir,
            self.experiment.output_dir,
        ):
            Path(p).mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------------- I/O

    def to_dict(self) -> Dict[str, Any]:
        def conv(obj: Any) -> Any:
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {k: conv(v) for k, v in dataclasses.asdict(obj).items()}
            if isinstance(obj, Path):
                return str(obj)
            if isinstance(obj, tuple):
                return list(obj)
            if isinstance(obj, dict):
                return {k: conv(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return [conv(v) for v in obj]
            return obj

        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = conv(v) if dataclasses.is_dataclass(v) else conv(v)
        return out

    def save(self, path: Path) -> None:
        path = Path(path)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        _apply_overrides(cfg, d)
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: Path) -> "Config":
        """Load a config from YAML or JSON. This implements the ``--config``
        flag the reference exposes but never reads (src/train.py:60)."""
        path = Path(path)
        text = path.read_text(encoding="utf-8")
        if path.suffix in (".yaml", ".yml"):
            import yaml

            data = yaml.safe_load(text) or {}
        else:
            data = json.loads(text)
        return cls.from_dict(data)


_PATH_FIELDS = {
    "data_root", "video_dir", "features_dir", "captions_file",
    "checkpoint_dir", "best_model_path", "output_dir", "predictions_file",
    "profile_dir", "compilation_cache_dir",
}

_TUPLE_FIELDS = {"img_size", "axis_names"}


def _apply_overrides(cfg: Any, overrides: Dict[str, Any]) -> None:
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"Unknown config key: {key!r}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _apply_overrides(current, value)
        else:
            if key in _PATH_FIELDS and value is not None:
                value = Path(value)
            if key in _TUPLE_FIELDS and isinstance(value, list):
                value = tuple(value)
            setattr(cfg, key, value)


def get_config() -> Config:
    """Default configuration (parity: reference config.py:153-155)."""
    return Config()
