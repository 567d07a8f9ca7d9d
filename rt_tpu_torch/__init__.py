"""rt_tpu_torch — the PyTorch/CUDA port of rt_tpu.

The JAX package `rt_tpu` is the reference: every module here has its
counterpart at the same path there, and the tests hold each against it
on the same inputs. This package imports torch and numpy only — never
jax, jaxlib, Pillow, or anything of `rt_tpu` (its own copies of the
JAX-free helpers live here).

Hot kernels are written by hand for Hopper (`csrc/*.cu`, built with
nvcc into `_build/` at first use and bound with ctypes); each keeps a
plain PyTorch version beside it, which the wrapper uses only for
tensors that lie on the CPU.
"""

__version__ = "0.1.0"

from rt_tpu_torch.config import RenderConfig  # noqa: F401
