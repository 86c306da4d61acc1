"""Fixed-step integrators matching the reference's semantics (port of
``dynamics/integrators.py``).

* :func:`euler_step` mirrors the reference's linearization and merit
  integrator (``pin.integrate`` + an explicit-Euler velocity update).
* :func:`rk4_step` mirrors the reference's ``rk4``, including its
  averaged-velocity position update.

All steps broadcast over leading batch dims.  States are ``x = [q, v]``
with shape ``(*batch, 2 nj)``.
"""
from __future__ import annotations

import torch

from ..models.robot import RobotModel
from .rnea import forward_dynamics


def split_state(model: RobotModel, x):
    return x[..., : model.nq], x[..., model.nq :]


def friction_torque(v, friction):
    """Unmodeled joint friction tau_f = -kv v - kc tanh(v / 0.01).

    ``friction`` is (viscous kv, coulomb kc); the tanh smooths the Coulomb
    sign so the plant dynamics stay C^1 for the integrator.
    """
    kv, kc = friction
    return -kv * v - kc * torch.tanh(v / 0.01)


def euler_step(model: RobotModel, x, u, dt, f_ext_ee=None, friction=None):
    """Explicit Euler: q+ = q + v dt,  v+ = v + a(q, v, u) dt."""
    q, v = split_state(model, x)
    ue = u if friction is None else u + friction_torque(v, friction)
    a = forward_dynamics(model, q, v, ue, f_ext_ee=f_ext_ee)
    return torch.cat([q + v * dt, v + a * dt], dim=-1)


def rk4_step(model: RobotModel, x, u, dt, f_ext_ee=None, friction=None):
    """RK4 with the reference's averaged-velocity position update.

    ``friction=(kv, kc)`` adds joint friction inside every stage
    evaluation (plant-side model mismatch; config.PlantConfig).
    """
    q, v = split_state(model, x)

    def fd(q_, v_):
        tau = u if friction is None else u + friction_torque(v_, friction)
        return forward_dynamics(model, q_, v_, tau, f_ext_ee=f_ext_ee)

    k1q = v
    k1v = fd(q, v)
    q2 = q + k1q * (dt / 2)
    k2q = v + k1v * (dt / 2)
    k2v = fd(q2, k2q)
    q3 = q + k2q * (dt / 2)
    k3q = v + k2v * (dt / 2)
    k3v = fd(q3, k3q)
    q4 = q + k3q * dt
    k4q = v + k3v * dt
    k4v = fd(q4, k4q)
    v_next = v + (dt / 6) * (k1v + 2 * k2v + 2 * k3v + k4v)
    avg_v = (k1q + 2 * k2q + 2 * k3q + k4q) / 6
    q_next = q + avg_v * dt
    return torch.cat([q_next, v_next], dim=-1)
