"""Device kernels: exact backward search, LF-walk locate, seed verify.

Every stage is plain jnp/lax over the int32 lattice layout
(bwtpu.index), compiled by XLA; the simple one-step kernels exported
here are the bit-exact references the packed pipelines are tested
against.
"""

from bwtpu.kernels.search import backward_search  # noqa: F401
from bwtpu.kernels.locate import locate_rows  # noqa: F401
from bwtpu.kernels.verify import verify_candidates  # noqa: F401
