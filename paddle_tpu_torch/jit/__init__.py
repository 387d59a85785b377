"""paddle_tpu_torch.jit — compilation of fixed-shape steps as CUDA graphs
(the part of ``paddle_tpu.jit`` the serving engine needs: its steps are
``jax.jit`` programs there).

- :mod:`graphs` — :class:`GraphStep`: one captured graph per input
  signature, replayed with static input buffers
"""
from .graphs import GraphStep

__all__ = ["GraphStep"]
