"""The four experts, the fusion net and the pipeline (PyTorch)."""
