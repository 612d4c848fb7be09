"""PyTorch/CUDA port of mallorn-tpu.

Mirrors the module layout of ``mallorn_tpu`` (the JAX reference, which
this package never imports). Entry points run on the CUDA device unless
the caller passes ``device="cpu"``; the one hand-written Hopper kernel of
the serving path (``ops.chol_cuda``) falls back to its plain PyTorch
version only for tensors that lie on the CPU.

The port so far covers the v92d serving path: packed lightcurves ->
features_v4 + TDE + 2D-GP + Bazin -> 222-column matrix -> binning ->
forest margin -> probability (``serving.V92dServer``).
"""

__version__ = "0.1.0"
