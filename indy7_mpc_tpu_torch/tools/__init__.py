"""The port's counterparts of the repository's ``tools/`` scripts that need
the robot model (``replay_html``); the others read only the recordings'
``.npy`` files or the UDP wire format and run on the port's output as they
are."""
