"""One client, closed loop: ``VideoCaptionPredictor.predict_batch`` on
``batch`` host clips at a time, each call after the last returned, with the
mix's method, beam and length. Produces ``clips_per_s``: the clips whose
caption came back over the whole window."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.harness import faults, inputs
from portbench.harness.captioning import Captioning, caption_control, sample
from portbench.harness.loop import Window, closed_loop


class Driver(Captioning):
    def window(self, seconds: float, trace: bool) -> Window:
        mix, B = self.mix, self.mix["batch"]
        order = inputs.clip_order(self.seed, mix["pool"], B * mix["max_calls"])
        self.served: List[tuple] = []  # (clip id, tokens (L + 1,), score)

        def call(i: int) -> int:
            ids = order[i * B:(i + 1) * B]
            results = self.predict([self.pool[j] for j in ids])
            self.served += [(int(j), np.asarray(r["tokens"]), r["bench_score"])
                            for j, r in zip(ids, results)]
            return len(results)

        w = closed_loop(call, seconds, mix["max_calls"], mix["trace_after_calls"],
                        mix["trace_calls"], trace)
        w.attempted = w.calls * B
        w.failed = w.attempted - w.items
        w.end_to_end = {"clips_per_s": w.items / w.seconds}
        return w

    def check(self) -> Dict[str, float]:
        return self.check_sample(*sample(self.seed, self.served, self.mix["check_clips"]))


def control(config: dict, mix: dict, seed: int, device: str) -> Dict[str, float]:
    return caption_control(config, mix, seed, device)


# The faults this timed path can have (one card: no exchange between cards).
FAULTS = {"state_unchanged": faults.state_unchanged, "half_batch": faults.half_batch,
          "token_altered": faults.token_altered, "topk_ranks_shifted": faults.topk_ranks_shifted,
          "worst_hypothesis_served": faults.worst_hypothesis_served}
