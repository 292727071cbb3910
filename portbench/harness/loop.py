"""What the drivers share: the window's record, the program's ``Config``
from a configuration file, a closed loop with its traced stretch, and the
precision the references run in."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from .trace import Stretch, span


def program_config(config: dict):
    """The program's ``Config`` with the configuration file's sections."""
    from video_captioning_tpu_torch.config import Config

    conf = Config()
    for section in ("model", "kernels", "data"):
        for key, value in config.get(section, {}).items():
            setattr(getattr(conf, section), key, value)
    conf.validate()
    return conf


@dataclass
class Window:
    """What the measured window did."""
    seconds: float = 0.0
    calls: int = 0
    items: int = 0                  # clips (or frames) whose result came back
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)  # the driver's values
    traced: Optional[Stretch] = None
    traced_calls: int = 0
    traced_items: int = 0
    launches: Dict[str, int] = field(default_factory=dict)
    # The window without its traced stretch (the profiler's start, the
    # profiled calls, its stop and export), for rates read in a traced run.
    untraced_s: float = 0.0
    untraced_calls: int = 0
    untraced_items: int = 0


def closed_loop(call: Callable[[int], int], seconds: float, max_calls: int,
                trace_after: int, trace_calls: int, trace: bool) -> Window:
    """One client: ``call(i)`` runs the i-th call and returns the items it
    finished, each call after the last returned, until ``seconds`` have
    passed. A traced run profiles calls ``trace_after`` to ``trace_after +
    trace_calls`` and keeps the program's launch counts of that stretch."""
    from video_captioning_tpu_torch import ops

    w = Window()
    stretch = Stretch() if trace else None
    paused = 0.0
    t0 = time.perf_counter()

    def stop() -> None:
        nonlocal paused
        stretch.stop()
        w.launches = dict(ops.launch_counts())
        w.traced = stretch
        paused += time.perf_counter() - begun

    while time.perf_counter() - t0 < seconds and w.calls < max_calls:
        if stretch is not None and w.calls == trace_after:
            begun = time.perf_counter()
            ops.reset_launch_counts()
            stretch.start()
        n = call(w.calls)
        w.calls += 1
        w.items += n
        if stretch is not None and stretch.prof is not None:
            w.traced_calls += 1
            w.traced_items += n
            if w.traced_calls == trace_calls:
                stop()
    w.seconds = time.perf_counter() - t0
    if stretch is not None and stretch.prof is not None:  # the window ended first
        stop()
    w.untraced_s = w.seconds - paused
    w.untraced_calls = w.calls - w.traced_calls
    w.untraced_items = w.items - w.traced_items
    return w


def spanned(name: str, fn):
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapped


class reference_precision:
    """float32 products with TF32 off (the reference) or on (the control)."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
