"""Optional-dependency probes.

Counterpart of ``metrics_tpu/utils/imports.py``, with the probes that the
text family needs. A probe only asks the import system whether a package
could be found; nothing is imported here, so the port imports without
``nltk``, ``regex`` or ``transformers``, and a metric that needs one raises
where it is built or used.
"""
from importlib.util import find_spec


def _package_available(name: str) -> bool:
    try:
        return find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


_NLTK_AVAILABLE = _package_available("nltk")
_REGEX_AVAILABLE = _package_available("regex")
_TRANSFORMERS_AVAILABLE = _package_available("transformers")
