"""The plain reference: the Indy7 (``robot``), its rigid-body dynamics
and plant (``rbd``), the Gauss-Newton SQP (``sqp``) and the sampled-MPC
tick (``tick``), in plain PyTorch, importing nothing of the program under
test."""
