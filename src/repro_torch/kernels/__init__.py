"""Hand-written CUDA kernels, their plain torch versions and the dispatcher
(``ops.py``)."""
