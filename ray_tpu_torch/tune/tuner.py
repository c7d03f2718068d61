"""Tuner: concurrent trial orchestration over actors
(``ray_tpu/tune/tuner.py``).

Parity target: reference python/ray/tune/tuner.py (Tuner.fit :344) +
execution/tune_controller.py (:666 step loop): trials are actors running
the user trainable with a report session; the controller caps concurrency,
feeds every report to the scheduler, stops losers early, and collects a
ResultGrid. Function trainables call `ray_tpu_torch.tune.report(metrics)` per
iteration (same session machinery as ray_tpu_torch.train).

Kept difference from ``ray_tpu``: a trial that the scheduler stops, or
the old trial of a PBT clone, ends its trainable at the trainable's next
``report``. Killing a ``TrialActor`` calls its ``__ray_shutdown__``,
which stops its session (``TrainSession.stop``); ``report`` then raises
in the trainable's thread and the thread exits. On the in-process runtime
the trials are threads of one process, and a stopped trial's thread
would otherwise keep every tensor its trainable holds.
"""

from __future__ import annotations

import dataclasses
import os
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.config import TrainContextConfig
from ray_tpu_torch.train.session import TrainSession
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.search import generate_variants


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"                   # "max" | "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[Any] = None     # FIFOScheduler | ASHAScheduler | ...
    #: sequential searcher (TPESearcher, ...); None = random/grid variants
    search_alg: Optional[Any] = None
    seed: Optional[int] = None


@dataclasses.dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Optional[Dict[str, Any]]       # last reported
    history: List[Dict[str, Any]]
    error: Optional[str] = None
    stopped_early: bool = False


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i: int) -> TrialResult:
        return self._results[i]

    @property
    def errors(self) -> List[TrialResult]:
        return [r for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("specify metric= (none set in TuneConfig)")
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise RuntimeError("no trial reported the metric "
                               f"{metric!r}")
        key = lambda r: float(r.metrics[metric])  # noqa: E731
        return (max if mode == "max" else min)(scored, key=key)

    def get_dataframe(self) -> List[Dict[str, Any]]:
        return [dict(r.metrics or {}, trial_id=r.trial_id, **{
            f"config/{k}": v for k, v in r.config.items()})
            for r in self._results]


class TrialActor:
    """Hosts one trial: the trainable runs under a report session."""

    def __init__(self):
        self._session: Optional[TrainSession] = None

    def start(self, trainable: Callable, config: Dict[str, Any],
              trial_id: str,
              checkpoint_path: Optional[str] = None) -> None:
        from ray_tpu_torch.train.checkpoint import Checkpoint

        ctx = TrainContextConfig(world_size=1, world_rank=0,
                                 experiment_path=trial_id,
                                 trial_info={"trial_id": trial_id,
                                             "config": config})

        def runner(cfg):
            out = trainable(cfg)
            # Return-style trainables: a returned dict is the final report.
            if isinstance(out, dict):
                from ray_tpu_torch.train.session import _require_session

                _require_session().report(out)

        self._session = TrainSession(
            runner, config, ctx,
            checkpoint=Checkpoint(checkpoint_path) if checkpoint_path
            else None)
        self._session.start()

    def poll(self, timeout: float = 1.0):
        r = self._session.poll(timeout)
        if r is None:
            return None
        if r.done:
            out = {"done": True}
            if r.error is not None:
                exc, tb = r.error
                out["error"] = f"{type(exc).__name__}: {exc}"
            return out
        return {"done": False, "metrics": r.metrics,
                "checkpoint_path": r.checkpoint_path}

    def __ray_shutdown__(self) -> None:
        # Called once by kill: the trainable's next report raises in its
        # thread, which then exits (module docstring).
        if self._session is not None:
            self._session.stop()


@dataclasses.dataclass
class _Trial:
    trial_id: str
    config: Dict[str, Any]
    actor: Any = None
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    iteration: int = 0
    done: bool = False
    error: Optional[str] = None
    stopped_early: bool = False
    latest_checkpoint: Optional[str] = None
    perturbs: int = 0


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[Any] = None):
        self._trainable = trainable
        self._space = param_space or {}
        self._cfg = tune_config or TuneConfig()
        self._run_config = run_config
        self._restored_trials: Optional[List[_Trial]] = None
        self._searcher_state: Optional[Dict[str, Any]] = None

    # ------------------------------------------------- experiment state

    def _experiment_dir(self) -> Optional[str]:
        rc = self._run_config
        if rc is None or getattr(rc, "storage_path", None) is None:
            return None
        name = getattr(rc, "name", None) or "tune_experiment"
        return os.path.join(rc.storage_path, name)

    def _snapshot(self, trials: List["_Trial"], searcher=None) -> None:
        """Atomic experiment-state snapshot after every round (reference:
        python/ray/tune/execution/experiment_state.py checkpointing) —
        a killed driver restores with Tuner.restore(). Searcher
        observation state rides along (reference: searcher save/restore)
        so a resumed BO experiment keeps its model."""
        path = self._experiment_dir()
        if path is None:
            return
        import json

        os.makedirs(path, exist_ok=True)
        state = {"trials": [{
            "trial_id": t.trial_id, "config": t.config,
            "history": t.history, "iteration": t.iteration,
            "done": t.done, "error": t.error,
            "stopped_early": t.stopped_early,
            "latest_checkpoint": t.latest_checkpoint,
            "perturbs": t.perturbs,
        } for t in trials]}
        if searcher is not None:
            try:
                state["searcher"] = searcher.get_state()
            except Exception:
                pass
        tmp = os.path.join(path, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(path, "experiment_state.json"))

    @classmethod
    def restore(cls, path: str, trainable: Callable, *,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[Any] = None) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results; unfinished ones restart from their latest checkpoint
        (the trainable resumes via tune.get_checkpoint())."""
        import json

        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        tuner = cls(trainable, tune_config=tune_config,
                    run_config=run_config)
        trials = []
        for ts in state["trials"]:
            t = _Trial(ts["trial_id"], ts["config"],
                       history=list(ts["history"]),
                       iteration=ts["iteration"], done=ts["done"],
                       error=ts.get("error"),
                       stopped_early=ts.get("stopped_early", False),
                       latest_checkpoint=ts.get("latest_checkpoint"),
                       perturbs=ts.get("perturbs", 0))
            trials.append(t)
        tuner._restored_trials = trials
        tuner._searcher_state = state.get("searcher")
        return tuner

    def fit(self) -> ResultGrid:
        cfg = self._cfg
        scheduler = cfg.scheduler or sched_mod.FIFOScheduler()
        searcher = cfg.search_alg
        if searcher is not None:
            searcher.set_search_properties(cfg.metric, cfg.mode,
                                           self._space)
            if self._searcher_state:
                searcher.set_state(self._searcher_state)
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif searcher is not None:
            trials = []  # created lazily: each suggest sees prior results
        else:
            variants = generate_variants(self._space, cfg.num_samples,
                                         cfg.seed)
            trials = [_Trial(f"trial_{i:04d}_{uuid.uuid4().hex[:6]}", v)
                      for i, v in enumerate(variants)]
        register = getattr(scheduler, "register", None)
        if register is not None:
            for t in trials:
                register(t.trial_id, t.config)
        pending = [t for t in trials if not t.done]
        running: List[_Trial] = []
        created = len(trials)
        reported_done: set = set()
        actor_cls = ray_tpu_torch.remote(TrialActor)

        def can_create() -> bool:
            return searcher is not None and created < cfg.num_samples

        while pending or running or can_create():
            while ((pending or can_create())
                   and len(running) < cfg.max_concurrent_trials):
                if pending:
                    t = pending.pop(0)
                else:
                    trial_id = (f"trial_{created:04d}_"
                                f"{uuid.uuid4().hex[:6]}")
                    t = _Trial(trial_id, searcher.suggest(trial_id))
                    trials.append(t)
                    created += 1
                    if register is not None:
                        register(t.trial_id, t.config)
                try:
                    t.actor = actor_cls.options(num_cpus=1).remote()
                    ray_tpu_torch.get(t.actor.start.remote(
                        self._trainable, t.config, t.trial_id,
                        t.latest_checkpoint), timeout=120)
                except Exception as e:
                    # Cluster can't host another concurrent trial right
                    # now: requeue and run at the concurrency that fits —
                    # unless nothing at all is running (then it never
                    # will; fail the trial instead of spinning).
                    if t.actor is not None:
                        try:
                            ray_tpu_torch.kill(t.actor)
                        except Exception:
                            pass
                        t.actor = None
                    if running:
                        pending.insert(0, t)
                        break
                    t.done = True
                    t.error = f"could not schedule trial: {e}"
                    continue
                running.append(t)
            polls = [(t, t.actor.poll.remote(1.0)) for t in running]
            round_results = []
            for t, ref in polls:
                try:
                    r = ray_tpu_torch.get(ref, timeout=60)
                except Exception as e:
                    t.done, t.error = True, f"trial actor died: {e}"
                    continue
                if r is None:
                    continue
                if r.get("done"):
                    t.done = True
                    t.error = r.get("error")
                    continue
                t.iteration += 1
                t.history.append(r["metrics"])
                if r.get("checkpoint_path"):
                    t.latest_checkpoint = r["checkpoint_path"]
                round_results.append((t, r["metrics"]))
            # Whole round to the scheduler at once (batch-synchronous):
            # the lockstep polling order must not decide rung survival.
            if round_results:
                decisions = scheduler.on_batch(
                    [(t.trial_id, t.iteration, m)
                     for t, m in round_results])
                by_id = {t.trial_id: t for t in trials}
                # Apply EVERY decision, not just this round's reporters:
                # cohort schedulers (HyperBand) judge stragglers when the
                # cohort completes a rung, stopping trials that reported
                # in EARLIER rounds.
                for tid, d in decisions.items():
                    t = by_id.get(tid)
                    if (t is not None and not t.done
                            and d == sched_mod.STOP
                            and all(t is not rt_ for rt_, _m
                                    in round_results)):
                        t.done = True
                        t.stopped_early = True
                for t, _m in round_results:
                    d = decisions.get(t.trial_id)
                    if d == sched_mod.STOP:
                        t.done = True
                        t.stopped_early = True
                    elif isinstance(d, dict) and d.get("action") == "clone":
                        # PBT exploit+explore: restart this trial from the
                        # SOURCE trial's checkpoint with the explored
                        # config (reference: pbt.py _exploit).
                        source = by_id.get(d["source"])
                        src_ckpt = (source.latest_checkpoint
                                    if source else None)
                        try:
                            ray_tpu_torch.kill(t.actor)
                        except Exception:
                            pass
                        t.config = d["config"]
                        t.perturbs += 1
                        if src_ckpt:
                            t.latest_checkpoint = src_ckpt
                        try:
                            t.actor = actor_cls.options(
                                num_cpus=1).remote()
                            ray_tpu_torch.get(t.actor.start.remote(
                                self._trainable, t.config, t.trial_id,
                                t.latest_checkpoint), timeout=120)
                        except Exception as e:
                            t.done = True
                            t.error = f"PBT clone restart failed: {e}"
            for t in [t for t in running if t.done]:
                running.remove(t)
                try:
                    ray_tpu_torch.kill(t.actor)
                except Exception:
                    pass
            sched_complete = getattr(scheduler, "on_trial_complete", None)
            for t in trials:
                if t.done and t.trial_id not in reported_done:
                    reported_done.add(t.trial_id)
                    if searcher is not None:
                        # Merge the fidelity reached into the final result
                        # (reports carry only user metrics): multi-fidelity
                        # searchers (BOHB) tier observations by it.
                        last = None
                        if t.history:
                            last = dict(t.history[-1])
                            last.setdefault("training_iteration",
                                            t.iteration)
                        searcher.on_trial_complete(t.trial_id, last)
                    if sched_complete is not None:
                        # Cohort schedulers must drop terminal trials
                        # from readiness checks (a dead peer would block
                        # its bracket's halving forever).
                        sched_complete(t.trial_id)
            self._snapshot(trials, searcher)

        results = [TrialResult(
            trial_id=t.trial_id, config=t.config,
            metrics=t.history[-1] if t.history else None,
            history=t.history, error=t.error,
            stopped_early=t.stopped_early) for t in trials]
        return ResultGrid(results, cfg.metric, cfg.mode)
