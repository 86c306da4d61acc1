from .traj import goals_from_flat, pack_xu, unpack_xu

__all__ = ["pack_xu", "unpack_xu", "goals_from_flat"]
