"""Logical-axis sharding for the port: rules, parameter makers, context."""

from repro_torch.sharding.rules import (  # noqa: F401
    AxisRules, DEFAULT_RULES, FSDP_RULES, logical_to_spec, safe_spec,
)
from repro_torch.sharding.param import ParamMaker, logical_axes  # noqa: F401
