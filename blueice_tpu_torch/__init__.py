"""blueice_tpu_torch: the PyTorch and CUDA port of blueice_tpu.

Same layout and public names as the JAX package (``blueice_tpu``), which
stays the reference it is held against. This package imports torch, numpy
and scipy only — never jax and never blueice_tpu — and carries its own numpy
host layer (sources, models, morphers, likelihood construction), since the
machines with the GPU have no JAX. Its device layer runs the batched binned
and unbinned profile-likelihood toy studies on one device, with the hot
likelihood ops as hand-written CUDA kernels for Hopper (``ops/fused*.py``,
``csrc/``). Entry points compile onto the CUDA device unless the caller
asks for the CPU with ``device='cpu'``.

It does all the JAX package does; ROADMAP.md lists the follow-ups.
"""

__version__ = '0.1.0'

from .exceptions import *            # noqa: F401,F403
from .models.model import *          # noqa: F401,F403
from .models.source import *         # noqa: F401,F403
from .likelihood import *            # noqa: F401,F403
from .priors import *                # noqa: F401,F403
from .models.jax_source import (JaxDensitySource,  # noqa: F401
                                prefill_anchor_templates)
from .morphers import MORPHERS       # noqa: F401
from .compile import build_logl      # noqa: F401
