"""Samplers: `octofit` with cross-chain ChEES-HMC, NUTS or jittered HMC,
parallel tempering (`octofit_pigeons`) with NUTS, ChEES or jittered-HMC
explorers, and rejection sampling from the prior (`octofit_rejection`)."""

from .driver import octofit, octofit_rejection
from .chees import run_chees
from .hmc import hmc_step
from .nuts import nuts_step, run_nuts
from .tempering import octofit_pigeons

__all__ = ["octofit", "octofit_rejection", "run_chees", "run_nuts", "nuts_step", "hmc_step",
           "octofit_pigeons"]
