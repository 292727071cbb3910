"""Multi-process data-parallel dry run, and the process launcher.

Counterpart of video_captioning_tpu/parallel/multihost.py. The JAX dry run
launches N ``jax.distributed`` processes with gloo CPU collectives; here
N ``torch.distributed`` worker processes with ``gloo`` on the CPU, each:

* reads only its own rows through the real ``data.pipeline.DataLoader``
  (``shard_index=rank, num_shards=N``);
* runs one data-parallel ``VideoCaptioningTrainer`` step whose gradient
  reduction crosses the processes (the loss comes back the same on every
  rank);
* has rank 0 alone write the checkpoint.

The launcher then replays the same global batch in one process with the
same reduction: each shard's loss share and gradients computed as a rank
computes them, summed in rank order, then clipped and applied. The loss
and the parameters must equal the workers' bit for bit: only the process
boundary differs, so any difference is a multi-process fault.

``spawn_ranks`` runs a function in N processes of one process group
(``file://`` rendezvous, no fixed port): the tests and ``chip_smoke.py``
use it.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

_WORKER_ENV_READY = "_VCT_TORCH_MULTIHOST_WORKER"
FEAT_DIM, FRAMES = 32, 10


# --------------------------------------------------------------------------
# Launching N ranks of one process group
# --------------------------------------------------------------------------


def _mark(out_dir: str, rank: int, what: str) -> None:
    """Append ``what`` and the time to the rank's log (``_rank_progress``)."""
    import time

    with open(os.path.join(out_dir, f"rank{rank}.log"), "a") as log:
        log.write(f"{what} {time.time():.3f}\n")


def _rank_main(rank: int, fn: Callable, world_size: int, init_file: str, backend: str,
               args: Sequence[Any], out_dir: str) -> None:
    _mark(out_dir, rank, "started")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    try:
        # init_process_group returns on a rank once its own links are up,
        # while a peer may still be inside gloo's connectFullMesh: a rank
        # whose fn makes no collective would finish, tear its links down
        # and fail that peer's start ("Connection closed by peer"). The
        # barrier holds every rank until all have joined.
        if backend == "nccl":
            dist.barrier(device_ids=[rank])
        else:
            dist.barrier()
        _mark(out_dir, rank, "joined")
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        _mark(out_dir, rank, "done")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
                backend: str = "gloo", timeout: float = 120.0,
                workdir: Optional[Path] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes of one ``backend`` process group (``nccl``: rank r on card
    r) and return each rank's result. ``fn`` must be importable (a module
    function). A rank that fails or outlives ``timeout`` seconds raises
    here, and every process is stopped."""
    import time

    import torch
    import torch.multiprocessing as mp

    workdir = Path(workdir or tempfile.mkdtemp(prefix="vct_ranks_"))
    workdir.mkdir(parents=True, exist_ok=True)
    init_file = workdir / "rendezvous"
    for stale in [init_file, *(workdir / f"rank{r}{ext}" for r in range(world_size)
                               for ext in (".log", ".pt"))]:
        if stale.exists():
            stale.unlink()
    t0 = time.time()
    ctx = mp.start_processes(_rank_main, args=(fn, world_size, str(init_file), backend,
                                               tuple(args), str(workdir)),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    what = f"{world_size} ranks of {fn.__name__}"
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what} ran past {timeout} s; "
                                   f"{_rank_progress(workdir, world_size, t0)}")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        how = (f"exited on {e.signal_name}" if getattr(e, "signal_name", None)
               else f"exited with code {e.exit_code}" if hasattr(e, "exit_code")
               else "raised")
        raise RuntimeError(f"rank {e.error_index} of {what} {how} after "
                           f"{time.time() - t0:.1f} s; "
                           f"{_rank_progress(workdir, world_size, t0)}: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    missing = [r for r in range(world_size) if not (workdir / f"rank{r}.pt").exists()]
    if missing:
        raise RuntimeError(f"ranks {missing} of {what} exited with code 0 and no result; "
                           f"{_rank_progress(workdir, world_size, t0)}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world_size)]


def _rank_progress(workdir: Path, world_size: int, t0: float) -> str:
    """Each rank's progress (started, joined the group, done), in seconds
    after the spawn, from the logs ``_rank_main`` writes."""
    parts = []
    for r in range(world_size):
        log = workdir / f"rank{r}.log"
        marks = [line.split() for line in log.read_text().splitlines()] if log.exists() else []
        parts.append(f"rank {r}: " + (", ".join(f"{m[0]} +{float(m[1]) - t0:.1f} s"
                                                for m in marks if len(m) == 2)
                                      or "not started"))
    return "; ".join(parts)


# --------------------------------------------------------------------------
# The dry run's data, model and step
# --------------------------------------------------------------------------


def _build_dataset(workdir: Path, n_rows: int) -> Path:
    """Synthetic features + CSV, deterministic; built once by the launcher
    before any worker starts (workers only read ``workdir``)."""
    import numpy as np

    feat_dir = workdir / "features"
    feat_dir.mkdir(parents=True, exist_ok=True)
    words = ["man", "dog", "cat", "rides", "runs", "sits", "horse", "park"]
    rs = np.random.RandomState(7)
    rows = []
    for i in range(n_rows):
        path = feat_dir / f"clip{i:03d}.npy"
        feats = rs.randn(FRAMES, FEAT_DIM).astype(np.float32)
        if not path.exists():
            np.save(path, feats)
        rows.append({"video_id": f"clip{i:03d}", "video_path": f"clip{i:03d}.mp4",
                     "feature_path": str(path),
                     "caption": " ".join(words[(i + j) % len(words)] for j in range(4))})
    csv_path = workdir / "dataset.csv"
    if not csv_path.exists():
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    return csv_path


def _tiny_config(workdir: Path):
    from ..config import Config

    config = Config()
    m = config.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = FEAT_DIM, 16, 16
    m.embedding_dim, m.attention_dim = 12, 16
    m.max_sequence_length, m.video_sequence_length = 6, FRAMES
    m.encoder_dropout = m.decoder_dropout = 0.0
    config.data.frames_per_video = FRAMES
    config.data.vocab_threshold = 1
    config.experiment.checkpoint_dir = workdir / "ckpt"
    config.experiment.use_tensorboard = False
    config.validate()
    return config


def _setup(workdir: Path):
    """(config, vocabulary, dataset, a fresh model) from ``workdir``."""
    from ..data.pipeline import VideoCaptioningDataset, read_captions_csv
    from ..data.vocabulary import build_vocabulary_from_csv
    from ..models.captioner import VideoCaptioningModel
    from ..models.weights import init_params_numpy, state_dict_from_jax_params

    config = _tiny_config(workdir)
    csv_path = workdir / "dataset.csv"
    vocab = build_vocabulary_from_csv(csv_path, config, "caption")
    config.data.max_vocab_size = len(vocab)
    config.validate()
    dataset = VideoCaptioningDataset(read_captions_csv(csv_path), vocab, config)
    model = VideoCaptioningModel(config, len(vocab))
    model.load_state_dict(state_dict_from_jax_params(init_params_numpy(config, len(vocab)),
                                                     config))
    return config, vocab, dataset, model


def _loader(dataset, rows_per_process: int, shard: int, num_shards: int):
    from ..data.pipeline import DataLoader

    return DataLoader(dataset, rows_per_process, shuffle=True, seed=42, drop_last=True,
                      num_workers=2, shard_index=shard, num_shards=num_shards)


def _param_digest(model) -> List[str]:
    """Every parameter's float64 sum, exact in its repr."""
    return [repr(float(p.detach().double().sum())) for p in model.parameters()]


def _worker(rank: int, world_size: int, workdir: str, rows_per_process: int) -> dict:
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh
    from ..training.trainer import VideoCaptioningTrainer

    workdir = Path(workdir)
    config, vocab, dataset, model = _setup(workdir)
    mesh = make_mesh(config)
    local = next(iter(_loader(dataset, rows_per_process, rank, world_size)))
    token_sum = torch.tensor(int(local["target_tokens"].sum()))
    dist.all_reduce(token_sum)
    trainer = VideoCaptioningTrainer(model, config, vocab, None, None, device="cpu", mesh=mesh)
    trainer.generator = None  # dropout off, as the replay
    loss = trainer.train_step(local)
    trainer._save(0, {"loss": float(loss)}, is_best=False)  # rank 0 writes
    return {"process_id": rank, "process_count": world_size,
            "global_devices": mesh.size, "loss": repr(float(loss)),
            "token_sum": int(token_sum), "local_rows": list(local["video_id"]),
            "params": _param_digest(trainer.model)}


def _replay(workdir: Path, num_shards: int, rows_per_process: int) -> dict:
    """One process, no process group: the workers' global batch in rank
    order, each shard's loss share and gradients as its rank computes
    them, summed in rank order, clipped and applied."""
    import torch

    from ..training import optim
    from ..training.trainer import VideoCaptioningTrainer

    torch.set_num_threads(1)
    config, vocab, dataset, model = _setup(workdir)
    shards = [next(iter(_loader(dataset, rows_per_process, s, num_shards)))
              for s in range(num_shards)]
    trainer = VideoCaptioningTrainer(model, config, vocab, None, None, device="cpu")
    trainer.generator = None
    count = sum((torch.from_numpy(s["target_tokens"]) != vocab.pad_idx).sum().float()
                for s in shards)
    grads, loss = None, None
    for shard in shards:
        trainer.optimizer.zero_grad(set_to_none=True)
        b = trainer._place(shard)
        share = trainer._share_loss(b["video_features"], b["input_tokens"],
                                    b["target_tokens"], global_count=count)
        share.backward()
        share = (torch.zeros(()) + share.detach()) / 1
        loss = share if loss is None else loss + share
        g = [p.grad.clone() for p in trainer.trainable]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    for p, g in zip(trainer.trainable, grads):
        p.grad = g
    optim.clip_grad_global_norm_(trainer.trainable, config.training.gradient_clip_norm)
    trainer.optimizer.step()
    token_sum = int(sum(int(s["target_tokens"].sum()) for s in shards))
    return {"loss": repr(float(loss)), "token_sum": token_sum,
            "params": _param_digest(trainer.model)}


def _run_module(argv: List[str], timeout: float, ready: bool = True) -> str:
    env = dict(os.environ)
    if ready:
        env[_WORKER_ENV_READY] = "1"
    repo_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    result = subprocess.run([sys.executable, "-m", "video_captioning_tpu_torch.parallel.multihost",
                             *argv], env=env, capture_output=True, text=True, timeout=timeout)
    if result.returncode != 0:
        raise RuntimeError(f"{argv[0]} failed (rc={result.returncode}):\n{result.stdout}\n"
                           f"{result.stderr}")
    return result.stdout.strip().splitlines()[-1]


def dryrun_multihost(num_processes: int = 2, devices_per_process: int = 1, workdir=None,
                     rows_per_process: int = 4, timeout: float = 300.0) -> dict:
    """Run the workers, then the single-process replay, and check: the
    same loss on every rank, disjoint shards covering the global batch,
    rank 0's checkpoint, and the replay's loss and parameters equal to the
    workers' bit for bit. Returns a report. One device a process (the
    port's mesh has no virtual devices), so ``devices_per_process`` must
    be 1."""
    if devices_per_process != 1:
        raise ValueError("the port drives one device per process (devices_per_process=1)")
    workdir = Path(workdir) if workdir else Path(tempfile.mkdtemp(prefix="vct_multihost_"))
    workdir.mkdir(parents=True, exist_ok=True)
    _build_dataset(workdir, rows_per_process * num_processes)
    reports = json.loads(_run_module(["--worker", "--num-processes", str(num_processes),
                                      "--workdir", str(workdir), "--rows-per-process",
                                      str(rows_per_process)], timeout))
    losses = [r["loss"] for r in reports]
    token_sums = [r["token_sum"] for r in reports]
    assert len(set(losses)) == 1, f"losses diverged across processes: {losses}"
    assert len(set(token_sums)) == 1, f"global batch diverged across processes: {token_sums}"
    assert all(r["params"] == reports[0]["params"] for r in reports), "parameters diverged"
    all_rows = [v for r in reports for v in r["local_rows"]]
    assert len(set(all_rows)) == len(all_rows), f"per-process shards overlap: {all_rows}"
    ckpt = workdir / "ckpt" / "checkpoint_epoch_0000.pth"
    assert ckpt.exists(), "rank 0 did not write the checkpoint"

    replay = json.loads(_run_module(["--replay", "--num-shards", str(num_processes),
                                     "--workdir", str(workdir), "--rows-per-process",
                                     str(rows_per_process)], timeout))
    assert replay["token_sum"] == token_sums[0], (
        f"replay saw a different global batch: {replay['token_sum']} vs {token_sums[0]}")
    assert replay["loss"] == losses[0], (
        f"multi-process loss {losses[0]} != single-process replay {replay['loss']}")
    assert replay["params"] == reports[0]["params"], "parameters differ from the replay"
    report = {"ok": True, "num_processes": num_processes,
              "devices_per_process": devices_per_process,
              "global_devices": reports[0]["global_devices"], "loss": float(losses[0]),
              "replay_loss": float(replay["loss"]), "token_sum": token_sums[0],
              "checkpoint": str(ckpt), "rows": all_rows}
    print(f"dryrun_multihost OK: {num_processes} procs, loss={float(losses[0]):.6f} "
          "(single-process replay identical)")
    return report


def _main_worker(argv) -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--workdir", type=str, required=True)
    parser.add_argument("--rows-per-process", type=int, default=4)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--coordinator", type=str, default=None)
    args = parser.parse_args(argv)
    if os.environ.get(_WORKER_ENV_READY) != "1":
        raise SystemExit("worker must be launched by dryrun_multihost (env not prepared)")
    reports = spawn_ranks(_worker, args.num_processes, (args.workdir, args.rows_per_process),
                          workdir=Path(args.workdir) / "ranks")
    print(json.dumps(reports), flush=True)


def _main_replay(argv) -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--num-shards", type=int, required=True)
    parser.add_argument("--workdir", type=str, required=True)
    parser.add_argument("--rows-per-process", type=int, default=4)
    args = parser.parse_args(argv)
    print(json.dumps(_replay(Path(args.workdir), args.num_shards, args.rows_per_process)),
          flush=True)


def main() -> None:
    argv = sys.argv[1:]
    if argv and argv[0] == "--worker":
        _main_worker(argv[1:])
    elif argv and argv[0] == "--replay":
        _main_replay(argv[1:])
    else:
        dryrun_multihost(num_processes=int(argv[0]) if argv else 2)


if __name__ == "__main__":
    main()
