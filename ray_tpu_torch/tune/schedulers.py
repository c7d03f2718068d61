"""Trial schedulers: FIFO, ASHA, PBT, PB2, median stopping and HyperBand
(``ray_tpu/tune/schedulers.py``).

Parity target: reference python/ray/tune/schedulers/async_hyperband.py
(ASHAScheduler) — asynchronous successive halving: at each rung
(iteration r, r*eta, r*eta^2, ...) a trial survives only if its metric is
in the top 1/eta of results recorded AT that rung so far.
"""

from __future__ import annotations

from typing import Any, Dict, List

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, iteration: int,
                  metrics: Dict[str, Any]) -> str:
        return CONTINUE

    def on_batch(self, results) -> Dict[str, str]:
        return {trial_id: CONTINUE for trial_id, _i, _m in results}


class ASHAScheduler:
    def __init__(self, metric: str, mode: str = "max",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.eta = reduction_factor
        self.max_t = max_t
        # rung iteration -> list of recorded metric values
        self._rungs: Dict[int, List[float]] = {}
        r = grace_period
        self._rung_levels = []
        while r < max_t:
            self._rung_levels.append(r)
            r *= reduction_factor

    def _score(self, metrics: Dict[str, Any]) -> float:
        v = float(metrics[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial_id: str, iteration: int,
                  metrics: Dict[str, Any]) -> str:
        return self.on_batch([(trial_id, iteration, metrics)])[trial_id]

    def on_batch(self, results) -> Dict[str, str]:
        """Batch-synchronous halving: record EVERY result of the round at
        its rung first, then judge each against the updated cutoff — a
        lockstep tuner feeding results one-by-one would otherwise prune by
        arrival order, not by score."""
        decisions: Dict[str, str] = {}
        judge = []
        for trial_id, iteration, metrics in results:
            if iteration >= self.max_t:
                decisions[trial_id] = STOP
                continue
            if iteration not in self._rung_levels:
                decisions[trial_id] = CONTINUE
                continue
            score = self._score(metrics)
            rung = self._rungs.setdefault(iteration, [])
            rung.append(score)
            judge.append((trial_id, iteration, score))
        for trial_id, iteration, score in judge:
            rung = sorted(self._rungs[iteration], reverse=True)
            # Top 1/eta of everything recorded at this rung survives
            # (ceil: a 2-entry rung at eta=2 keeps 1, a 4-entry keeps 2).
            k = max(1, -(-len(rung) // self.eta))
            decisions[trial_id] = (CONTINUE if score >= rung[k - 1]
                                   else STOP)
        return decisions


class PopulationBasedTraining:
    """PBT (reference: python/ray/tune/schedulers/pbt.py:221
    PopulationBasedTraining): at each perturbation interval, bottom-
    quantile trials EXPLOIT a top-quantile trial (clone its checkpoint +
    config) and EXPLORE (mutate hyperparameters). Decisions come back as
    {"action": "clone", "source": trial_id, "config": {...}} entries the
    Tuner applies by restarting the trial from the source's checkpoint.
    """

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Dict[str, Any] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: int = 0):
        import random as _random

        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations must be non-empty")
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = _random.Random(seed)
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._latest: Dict[str, float] = {}

    # The Tuner registers configs so explore() can mutate them.
    def register(self, trial_id: str, config: Dict[str, Any]) -> None:
        self._configs[trial_id] = dict(config)

    def _score(self, metrics: Dict[str, Any]) -> float:
        v = float(metrics[self.metric])
        return v if self.mode == "max" else -v

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Mutate each listed hyperparameter: resample with probability
        resample_probability, else perturb x1.2 / x0.8 (numeric) or step
        to a neighboring option (categorical) — reference explore()."""
        out = dict(config)
        for key, spec in self.mutations.items():
            cur = out.get(key)
            if self._rng.random() < self.resample_p or cur is None:
                if callable(spec):
                    out[key] = spec()
                elif isinstance(spec, (list, tuple)):
                    out[key] = self._rng.choice(list(spec))
                elif hasattr(spec, "sample"):
                    out[key] = spec.sample(self._rng)
                continue
            if isinstance(spec, (list, tuple)) and cur in spec:
                idx = list(spec).index(cur)
                step = self._rng.choice([-1, 1])
                out[key] = list(spec)[max(0, min(len(spec) - 1, idx + step))]
            elif isinstance(cur, (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[key] = type(cur)(cur * factor)
        return out

    def on_batch(self, results) -> Dict[str, Any]:
        decisions: Dict[str, Any] = {}
        for trial_id, _it, metrics in results:
            if self.metric in metrics:
                self._latest[trial_id] = self._score(metrics)
            decisions[trial_id] = CONTINUE
        ranked = sorted(self._latest.items(), key=lambda kv: kv[1])
        n = len(ranked)
        if n < 2:
            return decisions
        k = max(1, int(n * self.quantile))
        bottom = {tid for tid, _s in ranked[:k]}
        top = [tid for tid, _s in ranked[-k:]]
        for trial_id, iteration, _metrics in results:
            if (trial_id in bottom and iteration > 0
                    and iteration % self.interval == 0):
                source = self._rng.choice(top)
                if source == trial_id:
                    continue
                new_config = self._explore(self._configs.get(source, {}))
                self._configs[trial_id] = new_config
                decisions[trial_id] = {"action": "clone", "source": source,
                                       "config": new_config}
        return decisions


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (Parker-Holder et al. 2020; reference:
    python/ray/tune/schedulers/pb2.py): PBT's exploit step, but explore
    picks the next hyperparameters by a GP-UCB bandit over observed
    (config -> score-improvement) data instead of random perturbation —
    far more sample-efficient for small populations.

    ``hyperparam_bounds`` maps each tuned key to [low, high]; explore
    proposes within those bounds. The GP is a small exact RBF regressor
    over normalized configs with UCB acquisition (kappa sqrt-growth in
    data size, matching the time-varying bandit schedule's spirit)."""

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Dict[str, Any] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 n_candidates: int = 64):
        if not hyperparam_bounds:
            raise ValueError("hyperparam_bounds must be non-empty")
        for k, b in hyperparam_bounds.items():
            if (not isinstance(b, (list, tuple)) or len(b) != 2
                    or not float(b[0]) < float(b[1])):
                raise ValueError(f"bounds for {k!r} must be [low, high]")
        self.bounds = {k: (float(b[0]), float(b[1]))
                       for k, b in hyperparam_bounds.items()}
        # The base class's mutations/resample machinery never runs — PB2
        # replaces _explore wholesale — but its constructor requires a
        # non-empty mutations dict; pass an inert marker per tuned key.
        super().__init__(metric, mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={k: "pb2-gp"
                                               for k in self.bounds},
                         quantile_fraction=quantile_fraction, seed=seed)
        self.n_candidates = n_candidates
        #: (normalized config vector, score delta) observations
        self._gp_data: List[tuple] = []
        self._prev_score: Dict[str, float] = {}

    # -------------------------------------------------------------- data

    def _vec(self, config: Dict[str, Any]) -> List[float]:
        out = []
        for k, (lo, hi) in sorted(self.bounds.items()):
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo))
        return out

    def on_batch(self, results) -> Dict[str, Any]:
        # Record per-trial score improvements BEFORE the base class
        # updates _latest (the GP models "what config change helped").
        for trial_id, _it, metrics in results:
            if self.metric not in metrics:
                continue
            score = self._score(metrics)
            prev = self._prev_score.get(trial_id)
            if prev is not None:
                cfg = self._configs.get(trial_id)
                if cfg is not None:
                    self._gp_data.append((self._vec(cfg), score - prev))
                    if len(self._gp_data) > 100:
                        self._gp_data.pop(0)
            self._prev_score[trial_id] = score
        return super().on_batch(results)

    # ------------------------------------------------------------ explore

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        out = dict(config)
        if len(self._gp_data) < 4:
            for k, (lo, hi) in self.bounds.items():
                out[k] = self._rng.uniform(lo, hi)
            return out
        X = np.asarray([d[0] for d in self._gp_data])
        y = np.asarray([d[1] for d in self._gp_data])
        y_std = y.std() or 1.0
        yn = (y - y.mean()) / y_std
        ell, noise = 0.3, 1e-2
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        K = np.exp(-0.5 * d2 / ell**2) + noise * np.eye(len(X))
        Kinv = np.linalg.inv(K)
        alpha = Kinv @ yn

        cand = np.asarray([
            [self._rng.random() for _ in self.bounds]
            for _ in range(self.n_candidates)
        ])
        cd2 = ((cand[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        Kc = np.exp(-0.5 * cd2 / ell**2)
        mu = Kc @ alpha
        var = np.maximum(1.0 - np.einsum("ij,jk,ik->i", Kc, Kinv, Kc), 1e-9)
        kappa = 0.5 * np.sqrt(np.log(len(X) + 1.0))
        best = int(np.argmax(mu + kappa * np.sqrt(var)))
        for i, (k, (lo, hi)) in enumerate(sorted(self.bounds.items())):
            out[k] = lo + float(cand[best, i]) * (hi - lo)
        return out


class MedianStoppingRule:
    """Median stopping (reference: python/ray/tune/schedulers/
    median_stopping_rule.py): a trial stops when its best metric so far
    falls below the MEDIAN of other trials' running-average metric at the
    same iteration — a gentle prune that needs no rung schedule.

    Guards: no stops before `min_samples_required` trials have reported
    at an iteration, nor before `grace_period` iterations of the trial
    itself (fresh trials get time to warm up)."""

    def __init__(self, metric: str, mode: str = "max",
                 grace_period: int = 2, min_samples_required: int = 3):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        # trial_id -> list of scores per reported iteration
        self._scores: Dict[str, List[float]] = {}

    def _score(self, metrics: Dict[str, Any]) -> float:
        v = float(metrics[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial_id: str, iteration: int,
                  metrics: Dict[str, Any]) -> str:
        return self.on_batch([(trial_id, iteration, metrics)])[trial_id]

    def on_batch(self, results) -> Dict[str, str]:
        decisions: Dict[str, str] = {}
        for trial_id, _iteration, metrics in results:
            self._scores.setdefault(trial_id, []).append(
                self._score(metrics))
        for trial_id, iteration, _metrics in results:
            mine = self._scores[trial_id]
            if iteration < self.grace:
                decisions[trial_id] = CONTINUE
                continue
            t = len(mine)
            # Other trials' RUNNING AVERAGE over their first t reports.
            others = [sum(s[:t]) / min(t, len(s))
                      for tid, s in self._scores.items()
                      if tid != trial_id and s]
            if len(others) < self.min_samples:
                decisions[trial_id] = CONTINUE
                continue
            others.sort()
            mid = len(others) // 2
            median = (others[mid] if len(others) % 2
                      else 0.5 * (others[mid - 1] + others[mid]))
            best = max(mine)
            decisions[trial_id] = CONTINUE if best >= median else STOP
        return decisions


class HyperBandScheduler:
    """Synchronous HyperBand (reference: python/ray/tune/schedulers/
    hyperband.py): trials are dealt round-robin into brackets with
    different exploration/exploitation trade-offs; bracket s halves its
    cohort every ``R / eta^(s-k)`` iterations, so aggressive brackets
    stop most trials early while conservative ones let everything run
    long. A rung is judged ONCE, when every live cohort member has
    reached it (terminal trials are dropped from readiness via
    on_trial_complete, so a dead peer can never block its bracket);
    losers are stopped wherever they are — including trials that passed
    the rung in earlier rounds (the tuner applies decisions to any
    trial, not just the round's reporters).

    NOTE: synchronous halving prunes BELOW max_t only when a bracket's
    cohort runs concurrently (the tuner's lockstep rounds provide this
    when max_concurrent_trials >= the trial count; the reference gets it
    by pausing trials at rungs). With fewer slots, early trials finish
    before their peers arrive and only the stragglers get pruned —
    prefer ASHAScheduler for heavily queued experiments."""

    def __init__(self, metric: str, mode: str = "max", max_t: int = 81,
                 reduction_factor: int = 3):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.eta = reduction_factor
        self.max_t = max_t
        # Integer bracket count: float log loses a bracket on exact
        # powers (log(243, 3) == 4.999...).
        s = 0
        while self.eta ** (s + 1) <= max_t:
            s += 1
        self._s_max = s
        #: bracket s -> rung iterations (ascending), e.g. R=81, eta=3,
        #: s=2 -> [9, 27, 81]
        self._bracket_rungs = {
            b: [max(1, int(max_t / (reduction_factor ** k)))
                for k in range(b, -1, -1)]
            for b in range(self._s_max + 1)
        }
        self._next_bracket = 0
        self._trial_bracket: Dict[str, int] = {}
        #: trial -> score per iteration
        self._scores: Dict[str, Dict[int, float]] = {}
        self._stopped: set = set()
        self._finished: set = set()
        self._judged: set = set()  # (bracket, rung) pairs already halved

    def register(self, trial_id: str, config) -> None:
        self._trial_bracket[trial_id] = self._next_bracket
        self._next_bracket = (self._next_bracket + 1) % (self._s_max + 1)

    def on_trial_complete(self, trial_id: str) -> None:
        """Terminal (finished/errored) trials leave their cohort — their
        absence must not stall readiness forever."""
        self._finished.add(trial_id)

    def _score(self, metrics: Dict[str, Any]) -> float:
        v = float(metrics[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial_id: str, iteration: int,
                  metrics: Dict[str, Any]) -> str:
        """One-trial-at-a-time protocol: halving decisions that target
        OTHER trials (stragglers judged when this report completed a rung)
        are delivered on each loser's NEXT report via _stopped — on_batch
        marks them stopped, and any report from a stopped trial returns
        STOP below, so no decision is lost."""
        return self.on_batch([(trial_id, iteration, metrics)])[trial_id]

    def on_batch(self, results) -> Dict[str, str]:
        decisions: Dict[str, str] = {}
        touched: set = set()
        for trial_id, iteration, metrics in results:
            self._trial_bracket.setdefault(trial_id, 0)
            self._scores.setdefault(trial_id, {})[iteration] = \
                self._score(metrics)
            bracket = self._trial_bracket[trial_id]
            if trial_id in self._stopped or iteration >= self.max_t:
                # Already judged out in an earlier round (its STOP may have
                # been addressed to a batch it wasn't part of) — or done.
                decisions[trial_id] = STOP
                self._stopped.add(trial_id)
            else:
                decisions[trial_id] = CONTINUE
            touched.add(bracket)
        # Judge every unjudged non-final rung whose cohort is complete —
        # decisions may target trials OUTSIDE this batch (stragglers that
        # passed the rung earlier).
        for bracket in touched:
            rungs = self._bracket_rungs[bracket]
            # Cohort for RANKING includes terminal trials whose rung
            # score was recorded (they just can't be stopped again);
            # readiness requires every non-terminal member at the rung.
            members = [t for t, b in self._trial_bracket.items()
                       if b == bracket and t not in self._stopped]
            if len(members) < 2:
                continue
            for rung in rungs[:-1]:
                if (bracket, rung) in self._judged:
                    continue
                live = [t for t in members if t not in self._finished]
                if not all(rung in self._scores.get(t, {})
                           for t in live):
                    break  # live cohort still climbing toward this rung
                scored = [t for t in members
                          if rung in self._scores.get(t, {})]
                if len(scored) < 2:
                    break
                self._judged.add((bracket, rung))
                ranked = sorted(scored,
                                key=lambda t: -self._scores[t][rung])
                keep = max(1, len(ranked) // self.eta)
                for loser in ranked[keep:]:
                    decisions[loser] = STOP
                    self._stopped.add(loser)
                members = [t for t in members
                           if t not in self._stopped]
        return decisions
