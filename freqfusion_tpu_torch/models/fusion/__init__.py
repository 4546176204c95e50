"""The 7-phase fusion network (PyTorch)."""
