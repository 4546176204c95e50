"""FreqFusionSR in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``freqfusion_tpu`` (JAX on a TPU), which stays the reference.
Layout mirrors it: ``ops/`` (kernel wrappers and their plain versions),
``models/`` (experts, fusion net, pipeline), ``interface/`` (the NTIRE
entry point), ``utils/``, ``convert/`` and ``csrc/`` (CUDA sources).
"""
