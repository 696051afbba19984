"""Post-processing & validation: SBC, cross-validation, completeness."""

from .crossvalidation import (
    pointwise_like,
    prior_only_model,
    generate_kfold_systems,
    generate_system_per_epoch,
    psis_loo,
)
from .sbc import sbc_trial, calibrate
from .completeness import (
    CompletenessJob,
    CompletenessMap,
    CompletenessResult,
    assemble_completeness,
    completeness_jobs,
    completeness_map,
    run_completeness_trial,
)

__all__ = [
    "pointwise_like",
    "prior_only_model",
    "generate_kfold_systems",
    "generate_system_per_epoch",
    "psis_loo",
    "sbc_trial",
    "calibrate",
    "CompletenessJob",
    "CompletenessMap",
    "CompletenessResult",
    "assemble_completeness",
    "completeness_jobs",
    "completeness_map",
    "run_completeness_trial",
]
