"""String-valued enums for metric configuration.

The port's own copy of ``metrics_tpu/utils/enums.py`` (the case-deduction
``DataType`` and the two averaging enums). All enums compare case-insensitively
against strings.
"""
from enum import Enum
from typing import Union


class EnumStr(str, Enum):
    """String enum comparing case-insensitively with strings."""

    def __eq__(self, other: Union[str, Enum, None]) -> bool:  # type: ignore[override]
        other = other.value if isinstance(other, Enum) else str(other)
        return self.value.lower() == other.lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """Classification input "case" deduced from shapes/dtypes."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Reduction over classes."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Handling of the extra dimension of multi-dim multi-class inputs."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
