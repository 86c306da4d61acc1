"""The system under test, set up from a configuration file: the
``indy7_mpc_tpu_torch`` package's configuration objects, the Indy7 model
and the fig-8 reference on the device.  Nothing else of the package is
read here; the drivers call its entry points."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import traffic


class Setup(NamedTuple):
    cost: object
    sqp: object
    mpc: object
    sample: object
    plant: object
    model: object
    x0: torch.Tensor
    f_true0: list


def setup(cfg: dict, device) -> Setup:
    """The program's configuration of ``cfg`` on ``device``, in float32."""
    from indy7_mpc_tpu_torch.config import (
        CostConfig, MPCConfig, PlantConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7

    if cfg["dtype"] != "float32":
        raise ValueError(f"the program runs float32, the configuration states {cfg['dtype']}")
    w = cfg["wrench"]
    x0 = torch.zeros(12, dtype=torch.float32, device=device)
    x0[:6] = torch.tensor(cfg["init_q"], dtype=torch.float32)
    return Setup(
        cost=CostConfig(**cfg["cost"]),
        sqp=SQPConfig(**cfg["sqp"]),
        mpc=MPCConfig(N=cfg["horizon"], dt=cfg["dt"], sim_substeps=cfg["plant"]["substeps"]),
        sample=SampleConfig(batch_size=cfg["batch_size"], f_ext_std=w["f_ext_std"],
                            f_ext_resample_std=w["f_ext_resample_std"], decay=w["decay"]),
        plant=PlantConfig(**cfg["plant"]),
        model=indy7(torch.float32, device),
        x0=x0,
        f_true0=list(w["f_true0"]),
    )


def reference_rows(cfg: dict, ticks_between_wraps: int):
    """The fig-8 reference (numpy) long enough for a wrapped offset and
    ``ticks_between_wraps`` ticks after it."""
    return traffic.fig8_reference(cfg, traffic.periods_needed(cfg, ticks_between_wraps))
