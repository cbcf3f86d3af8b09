"""User-facing exceptions (the port's own copy of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised when user misuses the metric API (e.g. a capacity overflow)."""


class MetricsUserWarning(UserWarning):
    """Warning category for metric API usage issues (e.g. memory-heavy list states)."""
