"""The port's counterparts of the repository's ``examples/`` scripts.

Each module has ``main(argv=None)``, runs as ``python3 -m
indy7_mpc_tpu_torch.examples.<name>``, takes ``--device`` (the card by
default; ``cpu`` only when asked, with no fallback when CUDA is missing)
and imports only torch, numpy and this package:

  * ``protocol`` — the recorded-run configuration, once;
  * ``record_runs`` — the 3,500-tick recordings (device loop, in-process
    controller, controller over UDP to the native plant) and their summary;
  * ``fig8_closed_loop`` — one device-loop fig-8 run with a JSON summary;
  * ``point_to_goal`` — the goal chain, and B=1 against B=64 under a wrench;
  * ``baseline_table`` — the solve-time and tracking table at each
    reference B.
"""
