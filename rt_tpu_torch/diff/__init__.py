"""Differentiable rendering (rt_tpu/diff): the path-replay gradient with
its adjoint kernels (replay.py) and the inverse-rendering loop
(inverse.py)."""
