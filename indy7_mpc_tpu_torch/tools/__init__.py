"""The port's counterparts of the repository's ``tools/`` scripts that need
the port: the HTML replay (``replay_html``) and the diagnostic tools
(``latency_decomp``, ``profile_kernel_stages``, ``profile_solve``,
``profile_pscan``, ``consensus_collective_bench``, ``multihost_eff``), each
with the script's arguments and JSON keys.  The others read only the
recordings' ``.npy`` files or the UDP wire format and run on the port's
output as they are."""
