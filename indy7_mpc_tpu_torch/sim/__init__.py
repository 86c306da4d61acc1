"""Ground-truth plant.

The package exports the plant on a ``RobotModel`` with states
``(*b, 12)``, the TPU package's contract (``sim/readable_plant.py``);
``sim/plant.py`` holds the lane-major ``(12, L)`` plant on a
``StaticModel``, kernel K2's plain version.  One deviation from the TPU
package: ``plant_step`` takes pre-drawn, scaled ``noise`` in place of
``torque_noise_std`` with a ``jax.random`` key.
"""
from .readable_plant import apply_joint_limits, plant_step, predict_next_states

__all__ = ["apply_joint_limits", "plant_step", "predict_next_states"]
