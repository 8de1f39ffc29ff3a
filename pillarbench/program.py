"""The system under test as a configuration file states it: the port's
``PillarsConfig`` from the file's ``config``, and the program's options
from its ``program`` object: ``dtype`` (``float32`` or ``bfloat16``, the
type the RPN and head compute in) and ``fused_frontend`` (the fused front
end, or the classic one with K6). Every loop builds the program through
these, so that what a configuration file states is what runs."""

from __future__ import annotations


def program_config(fields: dict):
    """The config file's ``config`` object -> the port's ``PillarsConfig``."""
    from tpu_pillars_torch.config import ClassSpec, PillarsConfig

    kw = dict(fields)
    kw["classes"] = tuple(ClassSpec(**c) for c in fields["classes"])
    for key in ("rpn_channels", "rpn_layers", "anchor_yaws"):
        kw[key] = tuple(kw[key])
    return PillarsConfig(**kw)


def options(config_file: dict) -> dict:
    """{"dtype": a torch dtype, "fused_frontend": bool}."""
    import torch

    prog = config_file["program"]
    return {"dtype": getattr(torch, prog["dtype"]),
            "fused_frontend": bool(prog["fused_frontend"])}
