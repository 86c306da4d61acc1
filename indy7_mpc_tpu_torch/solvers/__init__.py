"""SQP solvers: the SQP kernel and its plain version."""
