"""repro_torch.learning — KronDPP learning (port of ``repro/learning``).

The public API for learning is the facade: ``dpp.Kron(factors).fit(batch,
algorithm=..., ...)`` delegates here and wraps the result back into a
``Kron``. This package is the engine behind it.

Module map
----------
engine.py     ``LearningEngine`` + ``LearnerState`` — chunks of KrK-Picard
              sweeps (a Python loop; one device sync per chunk),
              ``torch.randperm`` minibatches from an explicit generator.
objective.py  factored log-likelihood: masked subset logdets plus
              ``logdet(I + L1⊗L2)`` via the sampler's log-space
              product-spectrum fold — never materializes the N x N kernel.
schedules.py  step-size policies for ``a``: constant, a0/sqrt(1+t), and
              Armijo backtracking (PSD iterates + per-sweep ascent,
              Thm 3.2; one host sync per trial).
api.py        ``fit(model, batch, algorithm=..., ...)`` on one device.

Not ported yet (ROADMAP.md queue 1 #8): EM and joint Picard (so
``log_likelihood_eig``), checkpoint save/resume, the mesh placement.
"""

from . import schedules
from .api import FitReport, fit
from .engine import (ALGORITHMS, LearnerState, LearningEngine,
                     select_minibatch)
from .objective import (log_likelihood_factored, logdet_I_plus_kron,
                        subset_logdets_factored)
from .schedules import Schedule, ScheduleState, armijo, constant, inv_sqrt

__all__ = [
    "fit", "FitReport",
    "LearningEngine", "LearnerState", "ALGORITHMS", "select_minibatch",
    "log_likelihood_factored", "logdet_I_plus_kron",
    "subset_logdets_factored",
    "schedules", "Schedule", "ScheduleState", "constant", "inv_sqrt",
    "armijo",
]
