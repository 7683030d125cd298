"""Utilities: structured logging, profiling hooks, debug toggles.

The JAX package's third utility, ``utils/cache.py`` (JAX's persistent
compile cache), has its counterpart in ``_build.py``: the hand-written
kernels are compiled once into ``build/kernels/`` (and the DICOM scanner
into ``build/native/``), named by a hash of their sources.
"""

from mrisr_tpu_torch.utils.logging import StepTimer, get_logger  # noqa: F401
from mrisr_tpu_torch.utils.profiling import (  # noqa: F401
    enable_nan_debug,
    profile_trace,
)
