from .attention import sdpa  # noqa: F401
