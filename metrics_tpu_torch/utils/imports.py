"""Optional-dependency probes.

Counterpart of ``metrics_tpu/utils/imports.py``, with the probes that the
text and audio families need. A probe only asks the import system whether a
package could be found; nothing is imported here, so the port imports
without ``nltk``, ``regex``, ``transformers``, ``pesq`` or ``pystoi``, and a
metric that needs one raises where it is built or used (PESQ takes the
``pesq`` binding when it is installed and the in-repo engine otherwise).
"""
from importlib.util import find_spec


def _package_available(name: str) -> bool:
    try:
        return find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


_SCIPY_AVAILABLE = _package_available("scipy")
_NLTK_AVAILABLE = _package_available("nltk")
_REGEX_AVAILABLE = _package_available("regex")
_TRANSFORMERS_AVAILABLE = _package_available("transformers")
_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
