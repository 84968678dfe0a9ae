"""Plant models: the stateful LTI classes and ZOH discretization."""

from direct_data_driven_mpc_tpu_torch.models.c2d import (
    c2d_zoh,
    discretize_plant,
)
from direct_data_driven_mpc_tpu_torch.models.lti_model import (
    LTIModel,
    LTISystemModel,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams

__all__ = ["LTIModel", "LTISystemModel", "LTIParams", "c2d_zoh",
           "discretize_plant"]
