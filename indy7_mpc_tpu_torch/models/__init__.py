"""Robot models (port of indy7_mpc_tpu/models)."""
from .robot import INDY7_PARAMS, RobotModel, indy7

__all__ = ["INDY7_PARAMS", "RobotModel", "indy7"]
