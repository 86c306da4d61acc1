"""Ground-truth plant."""
