from .vb_driver import vb_factorize  # noqa: F401
from .ml_driver import factorize  # noqa: F401
