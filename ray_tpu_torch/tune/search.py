"""Search spaces + the basic variant generator
(``ray_tpu/tune/search.py``).

Parity target: reference python/ray/tune/search/sample.py (Categorical/
Float/Integer domains) + basic_variant.py (grid cross-product x
num_samples). Advanced searchers (hyperopt/optuna/...) are pluggable via
the same `suggest` seam but not bundled.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def generate_variants(param_space: Dict[str, Any], num_samples: int = 1,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Cross-product of every grid_search axis x num_samples random draws
    of the stochastic domains (reference BasicVariantGenerator)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grids = [param_space[k].values for k in grid_keys]
    variants: List[Dict[str, Any]] = []
    for combo in itertools.product(*grids) if grids else [()]:
        for _ in range(num_samples):
            cfg = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants


# --------------------------------------------------------------------------
# Searchers (sequential model-based suggestion)
# --------------------------------------------------------------------------


class Searcher:
    """ABC for sequential config suggestion (reference:
    python/ray/tune/search/searcher.py Searcher — suggest /
    on_trial_complete; hyperopt/optuna plug in behind the same seam).
    The Tuner draws configs lazily from a searcher so every suggestion
    can condition on finished trials."""

    def set_search_properties(self, metric: str, mode: str,
                              param_space: Dict[str, Any]) -> None:
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    f"param {k!r}: grid_search axes are exhaustive, not "
                    f"suggestible — use tune.choice() with a searcher, or "
                    f"drop the searcher for grid execution")
        self.metric = metric
        self.mode = mode
        self.space = param_space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        raise NotImplementedError

    # Snapshot/restore of the observation history (rides the experiment
    # state file; reference: searcher save/restore).
    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (the algorithm behind hyperopt's
    default searcher; reference integration surface:
    python/ray/tune/search/hyperopt/hyperopt_search.py).

    After ``n_initial`` random trials, observations split into the top
    ``gamma`` fraction (good) and the rest (bad). Candidates are drawn
    from the good-set density l(x) and ranked by l(x)/g(x): maximizing
    that ratio proposes configs that look like winners and unlike losers
    (Bergstra et al. 2011). Floats use Gaussian KDEs (log-space when the
    domain is log); integers round; categoricals use smoothed counts."""

    def __init__(self, *, n_initial: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._live: Dict[str, Dict[str, Any]] = {}
        self._obs: List[Dict[str, Any]] = []   # {"config", "score"}

    # ------------------------------------------------------------ state

    def get_state(self) -> Dict[str, Any]:
        return {"obs": self._obs}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._obs = list(state.get("obs", []))

    # ---------------------------------------------------------- suggest

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        import math

        if len(self._obs) < self.n_initial:
            cfg = {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                   for k, v in self.space.items()}
            self._live[trial_id] = cfg
            return cfg
        # Split observations: maximize -> high scores are "good". The
        # good-set size grows ~ gamma*sqrt(n) (hyperopt's rule): a flat
        # top-25% dilutes the winners' density with mediocre points.
        ordered = sorted(self._obs, key=lambda o: o["score"],
                         reverse=(self.mode == "max"))
        n = len(ordered)
        n_good = min(max(2, round(4 * self.gamma * math.sqrt(n))), 25)
        good, bad = ordered[:n_good], ordered[n_good:] or ordered[:1]

        # Per-dimension TPE (matching hyperopt's independent-factor
        # model): draw candidates from the good density MIXED WITH THE
        # PRIOR (the mixture keeps exploration alive — a pure good-KDE
        # collapses onto early mediocre winners), rank by l(x)/g(x),
        # keep each dimension's argmax.
        cfg: Dict[str, Any] = {}
        for key, dom in self.space.items():
            if not isinstance(dom, Domain):
                cfg[key] = dom
                continue
            gvals = [o["config"][key] for o in good]
            bvals = [o["config"][key] for o in bad]
            if isinstance(dom, Categorical):
                cats = dom.categories
                gc = {c: 1.0 for c in cats}
                for v in gvals:
                    gc[v] = gc.get(v, 1.0) + 1.0
                bc = {c: 1.0 for c in cats}
                for w in bvals:
                    bc[w] = bc.get(w, 1.0) + 1.0
                gtot, btot = sum(gc.values()), sum(bc.values())
                # Sample candidates from the good distribution, keep the
                # best ratio (sampling, not argmax over all categories:
                # preserves stochasticity across parallel suggests).
                best_c, best_r = None, -math.inf
                for _ in range(self.n_candidates):
                    c = self._rng.choices(
                        cats, weights=[gc[x] for x in cats])[0]
                    r = math.log(gc[c] / gtot) - math.log(bc[c] / btot)
                    if r > best_r:
                        best_c, best_r = c, r
                cfg[key] = best_c
                continue
            log_space = isinstance(dom, Float) and dom.log
            xform = math.log if log_space else (lambda z: z)
            lo_d = xform(float(dom.lower))
            hi_d = xform(float(dom.upper if isinstance(dom, Float)
                               else dom.upper - 1))
            width = max(hi_d - lo_d, 1e-12)
            gx = [xform(float(v)) for v in gvals]
            bx = [xform(float(v)) for v in bvals]

            def bandwidths(samples: List[float]) -> List[float]:
                """Per-sample bandwidth = spacing to adjacent samples
                (hyperopt's adaptive-parzen rule): kernels SHRINK as
                points concentrate, so refinement is unbounded, while
                isolated points keep wide kernels for exploration."""
                order = sorted(range(len(samples)),
                               key=lambda i: samples[i])
                srt = [samples[i] for i in order]
                bws = [0.0] * len(samples)
                for pos, i in enumerate(order):
                    left = srt[pos] - srt[pos - 1] if pos > 0 else width
                    right = (srt[pos + 1] - srt[pos]
                             if pos + 1 < len(srt) else width)
                    bws[i] = min(max(max(left, right), width / 100.0),
                                 width)
                return bws

            gbws = bandwidths(gx)
            bbws = bandwidths(bx)

            def logpdf(x: float, samples: List[float],
                       bws: List[float]) -> float:
                # MEAN kernel density blended with a uniform prior, no
                # count asymmetry: normalizing l by n_good and g by n_bad
                # hands every EMPTY region a constant ratio advantage of
                # log((n_bad+1)/(n_good+1)) and the argmax degenerates to
                # uniform exploration.
                n = max(1, len(samples))
                acc = 0.0
                for s, bw in zip(samples, bws):
                    acc += math.exp(-0.5 * ((x - s) / bw) ** 2) / (
                        bw * 2.5066282746310002)
                dens = 0.9 * (acc / n) + 0.1 / width
                return math.log(max(dens, 1e-300))

            best_x, best_r = None, -math.inf
            for _ in range(self.n_candidates):
                if self._rng.random() < 1.0 / (len(gx) + 1):
                    x = self._rng.uniform(lo_d, hi_d)  # prior draw
                else:
                    i = self._rng.randrange(len(gx))
                    x = self._rng.gauss(gx[i], gbws[i])
                    x = min(max(x, lo_d), hi_d)
                if isinstance(dom, Integer):
                    x = float(int(round(x)))
                r = logpdf(x, gx, gbws) - logpdf(x, bx, bbws)
                if r > best_r:
                    best_x, best_r = x, r
            if log_space:
                # exp(log(bound)) can land an ulp outside the domain.
                cfg[key] = min(max(math.exp(best_x), dom.lower),
                               dom.upper)
            elif isinstance(dom, Integer):
                cfg[key] = min(max(int(best_x), dom.lower), dom.upper - 1)
            else:
                cfg[key] = min(max(best_x, dom.lower), dom.upper)
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or result is None:
            return
        score = result.get(self.metric)
        if score is None:
            return
        self._obs.append({"config": cfg, "score": float(score)})


class BOHBSearcher(TPESearcher):
    """BOHB's model component (Falkner et al. 2018), for pairing with
    HyperBandScheduler (reference: python/ray/tune/search/bohb/
    bohb_search.py + schedulers/hb_bohb.py).

    Multi-fidelity twist on TPE: each observation records the budget
    (training_iteration) the trial reached — HyperBand stops losers at
    low rungs, so completions arrive at mixed fidelities. Suggestions are
    modeled on the HIGHEST budget tier that has accumulated ``n_initial``
    observations (higher-fidelity scores are more trustworthy); until any
    tier has enough, sampling stays random."""

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or result is None:
            return
        score = result.get(self.metric)
        if score is None:
            return
        self._obs.append({
            "config": cfg, "score": float(score),
            "budget": int(result.get("training_iteration", 0) or 0),
        })

    def _model_obs(self) -> List[Dict[str, Any]]:
        budgets = sorted({o.get("budget", 0) for o in self._obs},
                         reverse=True)
        for b in budgets:
            sub = [o for o in self._obs if o.get("budget", 0) >= b]
            if len(sub) >= self.n_initial:
                return sub
        return []

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        full = self._obs
        self._obs = self._model_obs()
        try:
            return super().suggest(trial_id)
        finally:
            self._obs = full


class OptunaSearch(Searcher):
    """Optuna adapter over the Searcher seam (reference:
    python/ray/tune/search/optuna/optuna_search.py OptunaSearch —
    ask/tell against an optuna Study). Lazily creates the study at the
    first suggest (direction needs the mode, which arrives via
    set_search_properties). ``optuna`` (or any object with its
    create_study/ask/tell surface, e.g. a test double) can be injected
    via ``optuna_module`` — the import is gated so the tune package
    never hard-depends on it."""

    def __init__(self, sampler: Any = None, seed: Optional[int] = None,
                 optuna_module: Any = None):
        self._optuna = optuna_module
        self._sampler = sampler
        self._seed = seed
        self._study = None
        self._live: Dict[str, Any] = {}

    def _ensure_study(self):
        if self._study is not None:
            return
        ot = self._optuna
        if ot is None:
            try:
                import optuna as ot  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "OptunaSearch requires the `optuna` package (pass "
                    "optuna_module=... to inject a compatible object)"
                ) from e
            self._optuna = ot
        sampler = self._sampler
        if sampler is None and self._seed is not None:
            try:
                sampler = ot.samplers.TPESampler(seed=self._seed)
            except Exception:
                sampler = None
        direction = "minimize" if self.mode == "min" else "maximize"
        self._study = ot.create_study(direction=direction,
                                      sampler=sampler)

    def _suggest_param(self, trial, name: str, dom: Any):
        if isinstance(dom, Categorical):
            return trial.suggest_categorical(name, dom.categories)
        if isinstance(dom, Float):
            return trial.suggest_float(name, dom.lower, dom.upper,
                                       log=dom.log)
        if isinstance(dom, Integer):
            return trial.suggest_int(name, dom.lower, dom.upper - 1)
        return dom  # literal values pass through

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        self._ensure_study()
        t = self._study.ask()
        self._live[trial_id] = t
        return {k: self._suggest_param(t, k, v)
                for k, v in self.space.items()}

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        t = self._live.pop(trial_id, None)
        if t is None or self._study is None:
            return
        value = None if result is None else result.get(self.metric)
        if value is None:
            try:
                state = self._optuna.trial.TrialState.FAIL
                self._study.tell(t, state=state)
            except Exception:
                pass
            return
        self._study.tell(t, float(value))
