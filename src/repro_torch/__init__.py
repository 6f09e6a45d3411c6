"""PyTorch/CUDA port of the EinDecomp system.

Same subpackage layout and module names as the JAX package ``repro``, so
every module here has one obvious counterpart there.  The planner
(``core/``, ``frontend/``) is pure Python and gives the same plans and keys
as the reference; the model stack (``models/``, ``launch/``) runs on a CUDA
device through the hand-written kernels in ``kernels/`` unless the caller
asks for ``device="cpu"``.
"""
