"""Samplers: `octofit` with cross-chain ChEES-HMC, NUTS or jittered HMC,
parallel tempering (`octofit_pigeons`) with NUTS, ChEES or jittered-HMC
explorers, rejection sampling from the prior (`octofit_rejection`) and
batched nested sampling (`octofit_nested`, alias `dysample`)."""

from .driver import octofit, octofit_rejection
from .chees import run_chees
from .hmc import hmc_step
from .nuts import nuts_step, run_nuts
from .tempering import octofit_pigeons
from .nested import octofit_nested, dysample

__all__ = ["octofit", "octofit_rejection", "run_chees", "run_nuts", "nuts_step", "hmc_step",
           "octofit_pigeons", "octofit_nested", "dysample"]
