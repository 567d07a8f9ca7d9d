"""Differentiable rendering (rt_tpu/diff): the path-replay gradient with
its adjoint kernels and the tangent replay (replay.py), the winner tape
with its capture kernel (tape.py), and the inverse-rendering loop
(inverse.py)."""
