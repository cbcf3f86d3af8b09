"""User-facing exceptions (the port's own copy of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised when user misuses the metric API (e.g. a capacity overflow)."""
