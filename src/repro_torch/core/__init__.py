"""Core AGE-CMPC combinatorics: codes, worker counts, overheads."""
from .age import (
    AGECode,
    GeneralizedPolyCode,
    entangled_code,
    optimal_age_code,
    polydot_code,
)
from .overheads import Overheads, overheads, scheme_overheads
from .worker_counts import (
    all_worker_counts,
    gamma,
    n_age_cmpc,
    n_entangled_cmpc,
    n_gcsa_na,
    n_polydot_cmpc,
    n_ssmm,
    optimal_lambda,
)

__all__ = [
    "AGECode",
    "GeneralizedPolyCode",
    "entangled_code",
    "optimal_age_code",
    "polydot_code",
    "Overheads",
    "overheads",
    "scheme_overheads",
    "all_worker_counts",
    "gamma",
    "n_age_cmpc",
    "n_entangled_cmpc",
    "n_gcsa_na",
    "n_polydot_cmpc",
    "n_ssmm",
    "optimal_lambda",
]
