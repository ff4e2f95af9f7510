from . import gates, matcher  # noqa: F401
