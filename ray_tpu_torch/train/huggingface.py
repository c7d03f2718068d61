"""TransformersTrainer: HuggingFace Trainer on the gang substrate
(``ray_tpu/train/huggingface.py``).

Parity target: the reference's transformers shim
(reference: python/ray/train/huggingface/transformers/ —
prepare_trainer + RayTrainReportCallback wiring a stock HF Trainer into
a TorchTrainer worker loop). Same split here: the user writes a normal
``transformers.Trainer`` inside ``train_loop_per_worker``; this module
provides the two integration pieces:

- :func:`prepare_trainer` — points the HF Trainer at the gang's torch
  process group (the TorchTrainer wrapper already ran
  ``dist.init_process_group``; HF picks the world up from the RANK /
  WORLD_SIZE env vars that wrapper exports) and disables HF's own
  reporting spam.
- :class:`RayTrainReportCallback` — an HF ``TrainerCallback`` that
  forwards per-log metrics (and per-save checkpoints) to
  ``ray_tpu_torch.train.report``, so HF training drives the same lockstep
  report/checkpoint machinery every other trainer uses.

Usage::

    def loop(config):
        import transformers
        trainer = transformers.Trainer(model=..., args=..., ...)
        trainer = prepare_trainer(trainer)
        trainer.add_callback(RayTrainReportCallback())
        trainer.train()

    TransformersTrainer(loop, scaling_config=ScalingConfig(num_workers=2),
                        ).fit()
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.train.torch import TorchTrainer


class TransformersTrainer(TorchTrainer):
    """HF training loops run inside an initialized torch process group —
    a named alias of TorchTrainer so the library surface mirrors the
    reference's per-framework trainer classes."""


def prepare_trainer(trainer):
    """Adapt a ``transformers.Trainer`` for the gang (reference:
    train/huggingface/transformers/_transformers_utils.prepare_trainer).
    The process group is already initialized by the TorchTrainer wrapper;
    HF's TrainingArguments read RANK/WORLD_SIZE/MASTER_* from env, so the
    main work is silencing per-worker console reporting and pinning
    non-rank-0 workers to no-save (the gang's report()/checkpoint path
    handles persistence once, on rank 0)."""
    from ray_tpu_torch.train.session import get_context

    ctx = get_context()
    args = trainer.args
    try:
        args.disable_tqdm = True
        if hasattr(args, "report_to"):
            args.report_to = []
        if ctx.get_world_rank() != 0:
            args.save_strategy = "no"
    except Exception:
        pass  # frozen/immutable args: HF still trains correctly
    return trainer


class RayTrainReportCallback:
    """HF TrainerCallback forwarding logs/checkpoints into
    ray_tpu_torch.train.report (reference:
    train/huggingface/transformers/_transformers_utils.RayTrainReportCallback).

    Implemented duck-typed (subclassing transformers.TrainerCallback at
    import time would make transformers a hard dependency of the train
    package); HF accepts any object with the callback methods."""

    def __init__(self):
        self._last_checkpoint_dir: Optional[str] = None

    # --- TrainerCallback surface (subset HF invokes) -------------------

    def on_save(self, args, state, control, **kwargs):
        import os

        self._last_checkpoint_dir = os.path.join(
            args.output_dir, f"checkpoint-{state.global_step}")
        return control

    def on_log(self, args, state, control, logs=None, **kwargs):
        from ray_tpu_torch import train as rt_train
        from ray_tpu_torch.train.checkpoint import Checkpoint

        metrics: Dict[str, Any] = dict(logs or {})
        metrics.setdefault("step", state.global_step)
        metrics.setdefault("epoch", state.epoch)
        ckpt = None
        if self._last_checkpoint_dir is not None:
            import os

            if os.path.isdir(self._last_checkpoint_dir):
                ckpt = Checkpoint.from_directory(self._last_checkpoint_dir)
            self._last_checkpoint_dir = None
        rt_train.report(metrics, checkpoint=ckpt)
        return control

    # no-op passthroughs HF may call
    def __getattr__(self, name: str):
        if name.startswith("on_"):
            return lambda *a, **k: k.get("control")
        raise AttributeError(name)
