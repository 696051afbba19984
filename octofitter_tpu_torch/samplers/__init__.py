"""Samplers: cross-chain ChEES-HMC behind `octofit`, and parallel
tempering (`octofit_pigeons`) with ChEES or jittered-HMC explorers."""

from .driver import octofit
from .chees import run_chees
from .hmc import hmc_step
from .tempering import octofit_pigeons

__all__ = ["octofit", "run_chees", "hmc_step", "octofit_pigeons"]
