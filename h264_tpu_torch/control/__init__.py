from .ratectl import RateControl  # noqa: F401
