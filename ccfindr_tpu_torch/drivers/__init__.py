from .vb_driver import vb_factorize  # noqa: F401
