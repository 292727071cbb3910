"""Rank functions that tests/test_torch_parallel.py runs in spawned gloo
processes (``parallel.multihost.spawn_ranks``). They import only the port,
so a spawned process does not load JAX."""

from __future__ import annotations

import numpy as np
import torch


def _config(cfg_dict, data_axis, model_axis, context_axis=None):
    from video_captioning_tpu_torch.config import Config

    cfg = Config.from_dict(cfg_dict)
    cfg.parallel.data_axis, cfg.parallel.model_axis = data_axis, model_axis
    cfg.parallel.context_axis = context_axis
    cfg.experiment.use_tensorboard = False
    cfg.validate()
    return cfg


def train_step(rank, world, cfg_dict, state, batch, model_axis, checkpoint_dir):
    """One data-parallel (and, with ``model_axis > 1``, vocabulary-split)
    step on this rank's rows; returns the loss, the unsplit parameters
    after the step and the split of this rank's parameters."""
    from video_captioning_tpu_torch.data.vocabulary import Vocabulary
    from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
    from video_captioning_tpu_torch.parallel import make_mesh, shard_batch
    from video_captioning_tpu_torch.parallel.sharding import gather_state_dict
    from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer

    cfg = _config(cfg_dict, -1, model_axis)
    cfg.experiment.checkpoint_dir = checkpoint_dir
    V = state["decoder.output_projection.weight"].shape[0]
    model = VideoCaptioningModel(cfg, V)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    mesh = make_mesh(cfg)
    trainer = VideoCaptioningTrainer(model, cfg, Vocabulary(cfg), None, None, device="cpu",
                                     mesh=mesh)
    trainer.generator = None
    local = shard_batch(mesh, batch)
    loss = trainer.train_step(local)
    trainer._save(0, {"loss": float(loss)}, is_best=False)
    full = gather_state_dict(trainer.model.state_dict(), mesh)
    return {"loss": float(loss), "coords": mesh.coords, "rows": int(local["input_tokens"].shape[0]),
            "local_vocab_rows": int(trainer.model.decoder.output_projection.weight.shape[0]),
            "params": {k: v.detach().numpy().copy() for k, v in full.items()}}


def cp_generate(rank, world, cfg_dict, state, feats, mask, beam_size):
    """Greedy and beam generation with the frame axis split over the
    ``model`` axis of a (1, world) mesh."""
    from video_captioning_tpu_torch.generation import beam_search_generate, greedy_generate
    from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, encode
    from video_captioning_tpu_torch.parallel import make_mesh
    from video_captioning_tpu_torch.parallel.mesh import set_mesh

    cfg = _config(cfg_dict, 1, world, "model")
    V = state["decoder.output_projection.weight"].shape[0]
    model = VideoCaptioningModel(cfg, V)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.eval()
    out = {}
    with set_mesh(make_mesh(cfg)), torch.no_grad():
        f, m = torch.from_numpy(feats), torch.from_numpy(mask)
        enc, final, m = encode(model, cfg, f, m)
        g = greedy_generate(model, cfg, enc, final, 1, 2, 6, m)
        b = beam_search_generate(model, cfg, enc, final, 1, 2, 6, m, beam_size=beam_size)
    out["greedy"] = {k: v.numpy() for k, v in g.items()}
    out["beam"] = {k: v.numpy() for k, v in b.items()}
    return out


def collectives(rank, world):
    """The mesh's groups and the sharding collectives on a (2, world/2)
    mesh: the vocabulary-parallel embedding and column-parallel linear
    against their unsplit modules, forward and backward."""
    from video_captioning_tpu_torch.config import Config
    from video_captioning_tpu_torch.parallel import make_mesh
    from video_captioning_tpu_torch.parallel.sharding import (
        ColumnParallelLinear,
        VocabParallelEmbedding,
        local_rows,
    )

    cfg = Config()
    cfg.parallel.model_axis = 2
    mesh = make_mesh(cfg)
    g = torch.Generator().manual_seed(0)
    table = torch.randn(8, 3, generator=g)
    w, b = torch.randn(8, 5, generator=g), torch.randn(8, generator=g)
    tokens = torch.tensor([[0, 7, 3], [4, 4, 1]])
    x = torch.randn(2, 3, 5, generator=g)
    start = mesh.axis_index("model") * 4
    emb = VocabParallelEmbedding(local_rows(table, mesh), start, 8, mesh.group("model"))
    lin = ColumnParallelLinear(local_rows(w, mesh), local_rows(b, mesh), start, 8,
                               mesh.group("model"))
    xr = x.clone().requires_grad_(True)
    y = lin(xr)
    (y * torch.arange(8.0)).sum().backward()
    e = emb(tokens)
    (e * 2.0).sum().backward()
    return {"coords": mesh.coords, "emb": e.detach().numpy(), "lin": y.detach().numpy(),
            "x_grad": xr.grad.numpy(), "w_grad": lin.weight.grad.numpy(),
            "table_grad": emb.weight.grad.numpy(), "start": start,
            "inputs": (table.numpy(), w.numpy(), b.numpy(), tokens.numpy(), x.numpy())}


def nothing(rank, world):
    return np.int64(rank)


def cli_train(rank, world, args, workdir):
    """``cli.train`` in every rank of the process group (as under
    ``torchrun``): each rank trains on its own rows, rank 0 writes."""
    import os

    from video_captioning_tpu_torch.cli import train as train_cli

    os.chdir(workdir)
    trainer = train_cli.main(args)
    return {"rows": len(trainer.train_loader) * trainer.train_loader.batch_size,
            "batch": trainer.train_loader.batch_size, "steps": trainer.global_step,
            "params": {k: v.detach().numpy().copy()
                       for k, v in trainer.model.state_dict().items()}}
