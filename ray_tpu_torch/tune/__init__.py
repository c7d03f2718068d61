"""ray_tpu_torch.tune: hyperparameter search over concurrent trial actors
(``ray_tpu/tune/__init__.py``).

Parity target: the reference Ray Tune surface (python/ray/tune/__init__ —
Tuner/TuneConfig/report/search spaces/schedulers), orchestration-only over
this runtime's actors: trials run the user trainable under a report
session; ASHA prunes losers at successive-halving rungs.
"""

from ray_tpu_torch.train.session import get_checkpoint, report  # session API
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                     HyperBandScheduler,
                                     MedianStoppingRule, PB2,
                                     PopulationBasedTraining)
from ray_tpu_torch.tune.search import (BOHBSearcher, OptunaSearch,
                                 Searcher, TPESearcher,
                                 choice, grid_search, loguniform,
                                 randint, uniform)
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig, Tuner)

__all__ = [
    "ASHAScheduler", "BOHBSearcher", "FIFOScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PB2",
    "PopulationBasedTraining", "OptunaSearch", "Searcher", "TPESearcher",
    "ResultGrid", "TrialResult", "TuneConfig", "Tuner", "choice",
    "get_checkpoint", "grid_search", "loguniform", "randint", "report",
    "uniform",
]
