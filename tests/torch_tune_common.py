"""Trainables for the port's tune tests. A cluster worker imports this
module by reference to run them, so it imports neither JAX nor
``ray_tpu`` (a module-level function of a test file would make the worker
import that file, and JAX with it)."""

import json
import os
import tempfile

from ray_tpu_torch import tune
from ray_tpu_torch.train import Checkpoint


def moving_optimum_trainable(config):
    """Score = -(lr - target(t))^2: the best lr DRIFTS over time, so a
    static config loses and PBT's exploit+explore tracks it. State
    (cumulative score) rides checkpoints (under ``config["root"]``) so
    exploits transfer progress."""
    score_sum = 0.0
    start = 0
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            with open(os.path.join(d, "state.json")) as f:
                st = json.load(f)
            score_sum, start = st["score_sum"], st["step"] + 1
    lr = config["lr"]
    for step in range(start, 16):
        target = 0.1 + 0.05 * step          # optimum drifts upward
        score_sum += -((lr - target) ** 2)
        d = tempfile.mkdtemp(prefix="pbt_ckpt_", dir=config["root"])
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"score_sum": score_sum, "step": step}, f)
        tune.report({"score": score_sum, "lr": lr, "step": step},
                    checkpoint=Checkpoint(d))


def ramp_trainable(config):
    """Deterministic reports: ``metric(q, step)`` for up to ``steps``
    steps."""
    for step in range(config["steps"]):
        tune.report({"acc": ramp_metric(config["q"], step)})


def ramp_metric(q, step):
    return q * (step + 1) - 0.05 * step * step
