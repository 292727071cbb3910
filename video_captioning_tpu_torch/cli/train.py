"""Training CLI.

Counterpart of video_captioning_tpu/cli/train.py with the same flags:
``--data-file`` CSV in, the vocabulary built or loaded at
``<checkpoint-dir>/vocabulary.json``, the seed-42 train/val/test split,
``--resume``, the inference package of the best epoch written at the end,
and an emergency checkpoint on KeyboardInterrupt. ``--device`` names the
torch device and defaults to ``cuda``; ``--device cpu`` trains on the CPU
(with the kernels' plain versions where ``kernels.interpret`` is set).

    python -m video_captioning_tpu_torch.cli.train --data-file captions.csv \
        --checkpoint-dir checkpoints --epochs 10

Options the port does not run yet (``--compute-dtype bfloat16``, the
orbax backend, ``--profile-dir``, ``--wandb``, a non-LSTM architecture or
another attention type) raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ..config import Config
from ..utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train video captioning model (PyTorch)")
    parser.add_argument("--config", type=str, help="Path to config file (YAML/JSON)")
    parser.add_argument("--data-file", type=str, required=True, help="Path to captions CSV file")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints", help="Checkpoint directory")
    parser.add_argument("--resume", type=str, help="Path to checkpoint to resume from")
    parser.add_argument("--batch-size", type=int, help="Batch size override")
    parser.add_argument("--learning-rate", type=float, help="Learning rate override")
    parser.add_argument("--epochs", type=int, help="Number of epochs override")
    parser.add_argument("--device", type=str, default="cuda", help="Torch device (cuda, cuda:N, cpu)")
    parser.add_argument("--log-level", type=str, default="INFO", help="Logging level")
    parser.add_argument("--wandb", action="store_true", help="Use Weights & Biases logging")
    parser.add_argument("--no-tensorboard", action="store_true", help="Disable TensorBoard logging")
    parser.add_argument("--attention-type", type=str, choices=["bahdanau", "luong", "multihead"],
                        help="Attention mechanism override")
    parser.add_argument("--architecture", type=str, choices=["lstm", "transformer"],
                        help="Model family override")
    parser.add_argument("--compute-dtype", type=str, choices=["float32", "bfloat16"],
                        help="Device compute dtype")
    parser.add_argument("--seed", type=int, help="Random seed override")
    parser.add_argument("--freeze-encoder", action="store_true",
                        help="Freeze the video encoder (train decoder only)")
    parser.add_argument("--checkpoint-backend", type=str, choices=["native", "orbax"],
                        help="Checkpoint backend override")
    parser.add_argument("--profile-dir", type=str, help="Write a profiler trace here")
    parser.add_argument("--grad-accum-steps", type=int,
                        help="Micro-batches per optimizer update (batch_size must divide evenly)")
    parser.add_argument("--ema-decay", type=float,
                        help="Parameter EMA decay (e.g. 0.999); validation and the exported "
                        "model use the averaged weights")
    return parser


def main(argv=None):
    """Run training; returns the trainer (its model, step count and
    histories) once it has finished or saved on an interrupt."""
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level, log_file="training.log")
    logger = logging.getLogger(__name__)

    config = Config.from_file(Path(args.config)) if args.config else Config()
    if args.batch_size:
        config.training.batch_size = args.batch_size
    if args.learning_rate:
        config.training.learning_rate = args.learning_rate
    if args.epochs:
        config.training.num_epochs = args.epochs
    if args.wandb:
        config.experiment.use_wandb = True
    if args.no_tensorboard:
        config.experiment.use_tensorboard = False
    if args.attention_type:
        config.model.attention_type = args.attention_type
    if args.architecture:
        config.model.architecture = args.architecture
    if args.compute_dtype:
        config.training.compute_dtype = args.compute_dtype
    if args.seed is not None:
        config.training.seed = args.seed
    if args.profile_dir:
        config.experiment.profile_dir = Path(args.profile_dir)
    if args.freeze_encoder:
        config.training.freeze_encoder = True
    if args.checkpoint_backend:
        config.experiment.checkpoint_backend = args.checkpoint_backend
    if args.grad_accum_steps is not None:
        config.training.grad_accum_steps = args.grad_accum_steps
    if args.ema_decay is not None:
        config.training.ema_decay = args.ema_decay

    config.data.captions_file = Path(args.data_file)
    config.experiment.checkpoint_dir = Path(args.checkpoint_dir)
    config.validate()

    import torch

    from ..data.pipeline import create_data_loaders, prepare_data
    from ..data.vocabulary import Vocabulary, build_vocabulary_from_csv
    from ..models.captioner import VideoCaptioningModel, count_params
    from ..models.weights import (
        init_params_numpy,
        jax_params_from_state_dict,
        state_dict_from_jax_params,
    )
    from ..training.trainer import VideoCaptioningTrainer

    config.ensure_dirs()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu")
    logger.info(f"Device: {device}")

    logger.info("Preparing data...")
    train_rows, val_rows, test_rows = prepare_data(config)

    vocabulary_path = config.experiment.checkpoint_dir / "vocabulary.json"
    if vocabulary_path.exists():
        logger.info("Loading existing vocabulary...")
        vocabulary = Vocabulary.load(vocabulary_path, config)
    else:
        logger.info("Building new vocabulary...")
        vocabulary = build_vocabulary_from_csv(config.data.captions_file, config, "caption")
        vocabulary.save(vocabulary_path)
    config.model.vocab_size = len(vocabulary)

    logger.info("Creating data loaders...")
    train_loader, val_loader, _ = create_data_loaders(config, vocabulary, train_rows, val_rows,
                                                      test_rows)

    logger.info("Initializing model...")
    model = VideoCaptioningModel(config, len(vocabulary))
    model.load_state_dict(state_dict_from_jax_params(
        init_params_numpy(config, len(vocabulary), seed=config.training.seed), config))
    logger.info(f"Model has {count_params(model):,} trainable parameters")

    trainer = VideoCaptioningTrainer(model, config, vocabulary, train_loader, val_loader,
                                     device=device)
    if args.resume:
        logger.info(f"Resuming from checkpoint: {args.resume}")
        trainer.load_checkpoint(Path(args.resume))

    logger.info("Starting training...")
    try:
        results = trainer.train()
        logger.info("Training completed successfully!")
        logger.info(f"Best validation score: {results['best_val_score']:.4f}")
        # Package the weights that earned best_val_score: the best
        # checkpoint's model_state_dict (the EMA shadow with ema_decay).
        best = trainer.checkpoint_manager.load_best_model()
        if best is not None:
            export_params = best["model_state_dict"]
            logger.info(f"Packaging best-epoch weights (epoch {best.get('epoch')})")
        else:
            export_params = jax_params_from_state_dict(trainer.eval_state_dict(), config)
        pkg = trainer.checkpoint_manager.save_model_for_inference(export_params, vocabulary,
                                                                  config)
        logger.info(f"Saved inference model to: {pkg}")
    except KeyboardInterrupt:
        logger.info("Training interrupted by user")
        trainer._save(trainer.current_epoch, {}, is_best=False)
        logger.info("Saved current training state")
    return trainer


if __name__ == "__main__":
    main()
