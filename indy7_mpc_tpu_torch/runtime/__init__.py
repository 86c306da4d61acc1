"""Host-driven runtime: the sampled controller, plant transports, stats
(port of ``indy7_mpc_tpu/runtime``)."""
from .stats import RunRecorder, make_stats, print_stats
from .transport import InProcessPlant, PlantState, UdpTransport
from .controller import SampledController, run_control_loop

__all__ = [
    "RunRecorder",
    "make_stats",
    "print_stats",
    "InProcessPlant",
    "PlantState",
    "UdpTransport",
    "SampledController",
    "run_control_loop",
]
