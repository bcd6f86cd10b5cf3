"""torch_nerf_tpu_torch — the PyTorch and CUDA port of ``torch_nerf_tpu``.

The JAX package stays the reference; this package mirrors its module names
(``cameras``, ``encoders``, ``ops.sampling``, ``ops.integration``,
``models.nerf``, ``fields``, ``renderer``, ``session``, ``runners``) and
runs on an NVIDIA Hopper card, with hand-written kernels where the JAX
package has Pallas kernels (``ops/csrc``). It imports torch, never jax, and
nothing of ``torch_nerf_tpu``. Entry points run on the card unless the
caller asks for the CPU.
"""

from torch_nerf_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
