"""Typed configuration with environment overrides.

A copy of `octofitter_tpu/config.py` (importing that package would
import JAX), without the JAX-only fields.

The reference scatters configuration across Preferences.jl, env vars
(`OCTO_GOST_CATALOG`, `DATADEPS_ALWAYS_ACCEPT`, ...) and global Refs
(`_kepsolve_use_threads`) — SURVEY.md section 5 prescribes one typed
config dataclass + env overrides. Every field can be
overridden by an `OCTOFITTER_<FIELD>` environment variable (upper-case;
parsed to the field's type), read once at first `get_config()`.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class OctofitterConfig:
    """Global defaults; see module docstring for env overrides."""

    # sampling defaults (reference `sampling.jl:317-325`)
    sampler: str = "chees"          # octofit default transition
    chains: int = 4                 # default chain count (raise on a GPU)
    adaptation: int = 1000
    iterations: int = 1000
    target_accept: float = 0.8
    max_depth: int = 12

    # initialization pipeline (model.initialize)
    init_prior_samples: int = 100_000
    init_multistart: int = 512
    init_opt_steps: int = 1000
    init_draws: int = 1000

    # logging / tracing
    verbosity: int = 1
    profile_dir: str = ""           # non-empty: octofit writes a torch.profiler trace here

    # data paths (zero-egress local mirrors)
    gost_catalog: str = ""          # OCTO_GOST_CATALOG equivalent
    data_dir: str = ""              # local dataset cache root

    # checkpointing
    checkpoint_dir: str = ""


def _parse(value: str, typ):
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def config_from_env(env=None) -> OctofitterConfig:
    env = os.environ if env is None else env
    cfg = OctofitterConfig()
    for f in dataclasses.fields(OctofitterConfig):
        key = f"OCTOFITTER_{f.name.upper()}"
        if key in env:
            setattr(cfg, f.name, _parse(env[key], f.type if isinstance(f.type, type) else type(getattr(cfg, f.name))))
    # legacy alias from the reference docs
    if "OCTO_GOST_CATALOG" in env and not cfg.gost_catalog:
        cfg.gost_catalog = env["OCTO_GOST_CATALOG"]
    return cfg


_CONFIG: OctofitterConfig | None = None


def get_config() -> OctofitterConfig:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = config_from_env()
    return _CONFIG


def set_config(**overrides) -> OctofitterConfig:
    """Update global config fields programmatically."""
    cfg = get_config()
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(cfg, k, v)
    return cfg
