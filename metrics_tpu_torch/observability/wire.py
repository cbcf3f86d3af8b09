"""Versioned wire format for fleet snapshots: metric states and telemetry
payloads as self-describing, dtype-stable byte blobs.

Counterpart of ``metrics_tpu/observability/wire.py``, with the same bytes:
a snapshot is UTF-8 JSON with sorted keys, a magic string and a schema
version, the provenance header (publisher, sequence number, wall clock,
host, process, mode, tier, manifest fingerprint, the optional ``span``
context of schema v2), and the states as ``{metric: {state: leaf}}``. An
array leaf is ``{"__arr__": {"dtype", "shape", "data"}}``: numpy's
``dtype.str`` (little-endian) and the raw bytes in base64, so every leaf
round-trips bit for bit; Python scalars (the eager ``_n_updates`` counter)
are JSON numbers and list states ``{"__list__": [...]}``. A port blob and a
JAX blob of the same states carry the same leaf bytes and header fields;
only the class paths of ``states_key`` differ (they name the port's
modules, so a collector of either package counts the other's snapshot as
one ``fold_error``).

**Leaves on the card.** :func:`encode_snapshot` packs every tensor leaf of
a snapshot that lives on a card into one ``uint8`` buffer there and copies
it to the host once: one host synchronisation per publish
(:func:`wire_copy_counts` counts the copies). :func:`decode_snapshot` lays
every array leaf of a snapshot into one host buffer (each leaf 16-byte
aligned) and hands out CPU tensors that view it; :meth:`Snapshot.to_device`
moves the whole buffer to a device in one copy and views it there.

**bfloat16.** numpy has no bfloat16, and the JAX package writes such a leaf
as ``'<V2'`` (its decoder returns raw ``|V2`` bytes). The port writes
``'<V2'`` as well, so the bytes stay compatible, and decodes a two-byte
void leaf as bfloat16 (the only two-byte torch dtype without a numpy
name), which is bit-exact.

**The manifest fingerprint** is the JAX package's formula over the port's
own analyzer manifests (``analysis/fusibility_manifest.json`` and
``analysis/layout_manifest.json``): two port builds that agree on it
serialize the same state schemas and reshard each leaf the same way, and a
collector counts a mismatch as version skew. ``""`` (unknown: collectors
fold anyway) when the port's fusibility manifest is absent.
"""
import base64
import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "WIRE_MAGIC",
    "WIRE_SCHEMA_VERSION",
    "Snapshot",
    "WireError",
    "decode_snapshot",
    "encode_snapshot",
    "manifest_fingerprint",
    "members_of",
    "snapshot_states",
    "states_key",
    "wire_copy_counts",
]

Tensor = torch.Tensor

#: leading magic every snapshot blob starts with (inside the JSON header)
WIRE_MAGIC = "metrics-tpu-snapshot"

#: current wire schema. Decoders accept any version <= this and refuse
#: newer ones. v2 adds the optional ``span`` header field.
WIRE_SCHEMA_VERSION = 2

#: accepted snapshot modes
MODES = ("state", "delta")

#: numpy ``dtype.str`` of each torch dtype a leaf may have (bfloat16 as the
#: JAX package writes it)
_DTYPE_STR = {
    torch.float16: "<f2",
    torch.float32: "<f4",
    torch.float64: "<f8",
    torch.bfloat16: "<V2",
    torch.complex64: "<c8",
    torch.complex128: "<c16",
    torch.bool: "|b1",
    torch.uint8: "|u1",
    torch.int8: "|i1",
    torch.int16: "<i2",
    torch.int32: "<i4",
    torch.int64: "<i8",
}
_TORCH_OF = {s: d for d, s in _DTYPE_STR.items()}
_TORCH_OF["|V2"] = torch.bfloat16

#: byte alignment of each leaf in a decoded snapshot's buffer
_ALIGN = 16

_COPIES = {"device_to_host": 0, "host_to_device": 0}
_COPIES_LOCK = threading.Lock()


def _count_copy(kind: str) -> None:
    with _COPIES_LOCK:
        _COPIES[kind] += 1


def wire_copy_counts(reset: bool = False) -> Dict[str, int]:
    """Buffer copies between a card and the host made by the wire since
    the last reset: ``device_to_host`` (one per encoded snapshot with card
    leaves, each a host synchronisation) and ``host_to_device`` (one per
    :meth:`Snapshot.to_device` onto a card)."""
    with _COPIES_LOCK:
        out = dict(_COPIES)
        if reset:
            for k in _COPIES:
                _COPIES[k] = 0
    return out


class WireError(ValueError):
    """Raised on undecodable, foreign or future-schema snapshot bytes. The
    collector catches it per snapshot and counts a ``fold_error``."""


# ---------------------------------------------------------------------------
# leaf codec
# ---------------------------------------------------------------------------

def _tensor_dtype_str(t: Tensor) -> str:
    try:
        return _DTYPE_STR[t.dtype]
    except KeyError:
        raise ValueError(f"the wire has no encoding for tensor dtype {t.dtype}") from None


def _numpy_spec(arr: np.ndarray) -> Dict[str, Any]:
    # little-endian, so the bytes mean the same on every host
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return {
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii"),
    }


def _raw_bytes(t: Tensor) -> Tensor:
    """A tensor's bytes as a flat ``uint8`` tensor on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _encode_tree(tree: Any, tensors: List[Tensor]) -> Any:
    """JSON-safe form of one leaf; tensors become ``__arr__`` specs whose
    ``data`` is filled in after the one copy (their index in ``tensors``)."""
    if isinstance(tree, bool):
        return tree
    if isinstance(tree, (int, float)):
        return tree
    if isinstance(tree, list):
        return {"__list__": [_encode_tree(v, tensors) for v in tree]}
    if isinstance(tree, Tensor):
        tensors.append(tree)
        return {"__arr__": {"dtype": _tensor_dtype_str(tree), "shape": list(tree.shape), "data": len(tensors) - 1}}
    return {"__arr__": _numpy_spec(np.asarray(tree))}


def _host_bytes(tensors: List[Tensor]) -> List[bytes]:
    """The bytes of each tensor: the card's leaves packed into one buffer
    per card and copied to the host once."""
    out: List[Optional[bytes]] = [None] * len(tensors)
    by_device: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for device, idx in by_device.items():
        parts = [_raw_bytes(tensors[i]) for i in idx]
        packed = torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8, device=device)
        if device.type != "cpu":
            packed = packed.cpu()
            _count_copy("device_to_host")
        host = packed.numpy()
        lo = 0
        for i, part in zip(idx, parts):
            n = part.numel()
            out[i] = host[lo : lo + n].tobytes()
            lo += n
    return out  # type: ignore[return-value]


def _fill_data(tree: Any, blobs: List[bytes]) -> Any:
    if isinstance(tree, dict) and "__list__" in tree:
        return {"__list__": [_fill_data(v, blobs) for v in tree["__list__"]]}
    if isinstance(tree, dict) and "__arr__" in tree and isinstance(tree["__arr__"]["data"], int):
        spec = dict(tree["__arr__"])
        spec["data"] = base64.b64encode(blobs[spec["data"]]).decode("ascii")
        return {"__arr__": spec}
    return tree


# ---------------------------------------------------------------------------
# states helpers
# ---------------------------------------------------------------------------

def members_of(obj: Any) -> Dict[str, Any]:
    """The ``{metric name: metric}`` member map of a template: a
    :class:`~metrics_tpu_torch.collections.MetricCollection` keys members by
    their collection names, a bare metric its one entry by its class name.
    The snapshot shape, the layout key and the collector's fold all derive
    from this one helper."""
    if hasattr(obj, "items") and hasattr(obj, "compile_update"):  # MetricCollection
        return dict(obj.items(keep_base=True))
    return {type(obj).__name__: obj}


def snapshot_states(obj: Any) -> Dict[str, Dict[str, Any]]:
    """A metric's (or collection's) current states in the wire's
    ``{metric name: {state name: leaf}}`` shape. Leaves are the live state
    values (tensors, the eager ``int`` counter, list states); a ``"delta"``
    publisher resets the metric right after encoding them."""
    return {name: {k: getattr(m, k) for k in m._defaults} for name, m in members_of(obj).items()}


def _leaf_key(value: Any) -> str:
    """One leaf's structural signature: ``"list"`` for list states,
    ``"int"``/``"float"`` for scalars (a Python int and a 0-d int32 tensor
    are the same layout), dtype string and shape otherwise."""
    if isinstance(value, list):
        return "list"
    if isinstance(value, (bool, int)):
        return "int"
    if isinstance(value, float):
        return "float"
    if isinstance(value, Tensor):
        if value.ndim == 0:
            return "float" if value.is_floating_point() or value.is_complex() else "int"
        return f"{_tensor_dtype_str(value)}{list(value.shape)}"
    arr = np.asarray(value)
    if arr.ndim == 0:
        return "int" if arr.dtype.kind in "biu" else "float"
    return f"{arr.dtype.str}{list(arr.shape)}"


def states_key(obj: Any) -> Dict[str, Any]:
    """Structural key of a template's states: class path plus each leaf's
    :func:`_leaf_key`. It rides the snapshot header, so a collector refuses
    a publisher whose layout disagrees with its template before a leaf is
    folded (a different class, or a config that changes a state's shape)."""

    def one(metric: Any) -> Dict[str, Any]:
        return {
            "class": f"{type(metric).__module__}.{type(metric).__name__}",
            "states": {name: _leaf_key(getattr(metric, name)) for name in sorted(metric._defaults)},
        }

    return {name: one(m) for name, m in members_of(obj).items()}


_MANIFEST_FP_CACHE: Optional[str] = None


def manifest_fingerprint() -> str:
    """Short sha256 fingerprint of the port's analyzer manifests:
    ``sha256(fusibility + b"\\x00" + layout)[:16]`` over the two files'
    bytes (the layout file reads as empty when absent), ``""`` when the
    fusibility manifest is absent. Cached for the process: a collector
    consults it per ingested snapshot."""
    global _MANIFEST_FP_CACHE
    if _MANIFEST_FP_CACHE is not None:
        return _MANIFEST_FP_CACHE
    from metrics_tpu_torch.analysis.layout import default_layout_manifest_path
    from metrics_tpu_torch.analysis.manifest import default_manifest_path

    try:
        data = default_manifest_path().read_bytes()
    except OSError:  # an absent manifest is a legal deployment
        _MANIFEST_FP_CACHE = ""
        return _MANIFEST_FP_CACHE
    try:
        layout = default_layout_manifest_path().read_bytes()
    except OSError:
        layout = b""
    _MANIFEST_FP_CACHE = hashlib.sha256(data + b"\x00" + layout).hexdigest()[:16]
    return _MANIFEST_FP_CACHE


# ---------------------------------------------------------------------------
# snapshot codec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Snapshot:
    """One decoded fleet snapshot: provenance header and payloads.

    ``states`` hold CPU tensors that view one host buffer (``buffer``;
    :meth:`to_device` moves it in one copy). ``telemetry`` is a list of
    counter payloads: a leaf publisher ships one, a mid-tier collector the
    concatenation for its subtree."""

    publisher: str
    seq: int
    t: float
    host: str = ""
    process: int = 0
    mode: str = "state"
    tier: str = "leaf"
    schema: int = WIRE_SCHEMA_VERSION
    manifest_hash: str = ""
    states: Optional[Dict[str, Dict[str, Any]]] = None
    states_key: Optional[Dict[str, Any]] = None
    telemetry: List[Dict[str, Any]] = field(default_factory=list)
    #: the publisher's trace-span context at publish time (schema v2+)
    span: Optional[Dict[str, Any]] = None
    #: every array leaf's bytes, 16-byte aligned (uint8, CPU), and where
    #: each leaf lies in it: ``(metric, state, list index or None, offset,
    #: nbytes, dtype, shape)``
    buffer: Optional[Tensor] = field(default=None, compare=False, repr=False)
    layout: Tuple = field(default=(), compare=False, repr=False)

    @property
    def key(self) -> Tuple[str, int]:
        """The dedup identity: ``(publisher, seq)``."""
        return (self.publisher, self.seq)

    def to_device(self, device: Any) -> Optional[Dict[str, Dict[str, Any]]]:
        """The states with every array leaf on ``device``: the buffer goes
        over in ONE copy and each leaf views it there."""
        if self.states is None:
            return None
        device = torch.device(device)
        if self.buffer is None or device.type == "cpu":
            return self.states
        moved = self.buffer.to(device)
        _count_copy("host_to_device")
        out = {m: dict(tree) for m, tree in self.states.items()}
        for metric, name, index, offset, nbytes, dtype, shape in self.layout:
            leaf = _view(moved, offset, nbytes, dtype, shape)
            if index is None:
                out[metric][name] = leaf
            else:
                if out[metric][name] is self.states[metric][name]:
                    out[metric][name] = list(out[metric][name])
                out[metric][name][index] = leaf
        return out


def _view(buffer: Tensor, offset: int, nbytes: int, dtype: torch.dtype, shape: List[int]) -> Tensor:
    return buffer[offset : offset + nbytes].view(dtype).reshape(shape)


def encode_snapshot(
    *,
    publisher: str,
    seq: int,
    t: Optional[float] = None,
    host: str = "",
    process: int = 0,
    mode: str = "state",
    tier: str = "leaf",
    states: Optional[Dict[str, Dict[str, Any]]] = None,
    states_template: Optional[Any] = None,
    telemetry: Optional[Any] = None,
    manifest_hash: Optional[str] = None,
    span: Optional[Dict[str, Any]] = None,
) -> bytes:
    """Serialize one snapshot to wire bytes.

    ``states`` is the ``{metric: {state: leaf}}`` dict of
    :func:`snapshot_states` (tensors, numpy arrays, scalars, lists);
    ``states_template`` (the metric or collection they came from) adds the
    structural :func:`states_key`. ``telemetry`` is one counter payload or
    a list of them; ``t`` defaults to the wall clock, ``manifest_hash`` to
    :func:`manifest_fingerprint`; ``span`` is the publisher's span context."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not publisher:
        raise ValueError("publisher id must be non-empty")
    if seq < 0:
        raise ValueError(f"seq must be non-negative, got {seq}")
    if telemetry is None:
        payloads: List[Dict[str, Any]] = []
    elif isinstance(telemetry, dict):
        payloads = [telemetry]
    else:
        payloads = list(telemetry)
    doc: Dict[str, Any] = {
        "magic": WIRE_MAGIC,
        "schema": WIRE_SCHEMA_VERSION,
        "publisher": publisher,
        "seq": int(seq),
        "t": float(time.time() if t is None else t),
        "host": host,
        "process": int(process),
        "mode": mode,
        "tier": tier,
        "manifest_hash": manifest_fingerprint() if manifest_hash is None else manifest_hash,
    }
    if states is not None:
        tensors: List[Tensor] = []
        encoded = {metric: {name: _encode_tree(leaf, tensors) for name, leaf in tree.items()} for metric, tree in states.items()}
        blobs = _host_bytes(tensors)
        doc["states"] = {metric: {name: _fill_data(v, blobs) for name, v in tree.items()} for metric, tree in encoded.items()}
        if states_template is not None:
            doc["states_key"] = states_key(states_template)
    if payloads:
        doc["telemetry"] = payloads
    if span is not None:
        doc["span"] = span
    return json.dumps(doc, sort_keys=True).encode("utf-8")


def _collect_arrays(tree: Any, metric: str, name: str, index: Optional[int], found: List[Tuple]) -> None:
    if isinstance(tree, dict) and "__list__" in tree:
        items = tree["__list__"]
        if not isinstance(items, list):
            raise WireError(f"corrupt list leaf {metric}.{name}")
        for i, v in enumerate(items):
            _collect_arrays(v, metric, name, i, found)
    elif isinstance(tree, dict) and "__arr__" in tree:
        spec = tree["__arr__"]
        try:
            raw = base64.b64decode(spec["data"].encode("ascii"), validate=True)
            dtype = _TORCH_OF.get(spec["dtype"])
            if dtype is None:
                np_dtype = np.dtype(spec["dtype"])
                dtype = _TORCH_OF.get(np_dtype.str)
                if dtype is None:
                    raise TypeError(f"no torch dtype for {spec['dtype']!r}")
            shape = [int(d) for d in spec["shape"]]
            itemsize = torch.empty((), dtype=dtype).element_size()
            if len(raw) != int(np.prod(shape, dtype=np.int64)) * itemsize:
                raise ValueError(f"{len(raw)} bytes for shape {shape} of {spec['dtype']}")
        except (KeyError, ValueError, TypeError, AttributeError) as err:
            raise WireError(f"corrupt array leaf: {err!r}") from err
        found.append((metric, name, index, raw, dtype, shape))


def _decode_states(states: Any) -> Tuple[Dict[str, Dict[str, Any]], Optional[Tensor], Tuple]:
    """Decoded states, their one host buffer and the leaves' layout in it."""
    if not isinstance(states, dict):
        raise WireError("states must be a {metric: {state: leaf}} object")
    found: List[Tuple] = []
    for metric, tree in states.items():
        if not isinstance(tree, dict):
            raise WireError(f"states of {metric!r} must be an object")
        for name, leaf in tree.items():
            _collect_arrays(leaf, metric, name, None, found)
    layout = []
    offset = 0
    for metric, name, index, raw, dtype, shape in found:
        layout.append((metric, name, index, offset, len(raw), dtype, shape))
        offset += -(-len(raw) // _ALIGN) * _ALIGN
    host = np.zeros(offset, dtype=np.uint8)
    for (_, _, _, lo, n, _, _), (_, _, _, raw, _, _) in zip(layout, found):
        host[lo : lo + n] = np.frombuffer(raw, dtype=np.uint8)
    buffer = torch.from_numpy(host)
    out: Dict[str, Dict[str, Any]] = {
        metric: {name: ([None] * len(leaf["__list__"]) if isinstance(leaf, dict) and "__list__" in leaf else leaf) for name, leaf in tree.items()}
        for metric, tree in states.items()
    }
    for metric, name, index, lo, n, dtype, shape in layout:
        leaf = _view(buffer, lo, n, dtype, shape)
        if index is None:
            out[metric][name] = leaf
        else:
            out[metric][name][index] = leaf
    return out, buffer, tuple(layout)


def decode_snapshot(data: bytes) -> Snapshot:
    """Parse wire bytes into a :class:`Snapshot`. Raises :class:`WireError`
    on anything that is not a complete snapshot this build can read
    (truncated JSON, foreign magic, a future schema, corrupt array leaves):
    the collector's per-snapshot ``fold_error`` boundary."""
    try:
        doc = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise WireError(f"undecodable snapshot bytes: {err!r}") from err
    if not isinstance(doc, dict) or doc.get("magic") != WIRE_MAGIC:
        raise WireError("not a metrics-tpu snapshot (bad magic)")
    schema = doc.get("schema")
    if not isinstance(schema, int) or schema < 1:
        raise WireError(f"bad schema version {schema!r}")
    if schema > WIRE_SCHEMA_VERSION:
        raise WireError(
            f"snapshot schema v{schema} is newer than this build's v{WIRE_SCHEMA_VERSION}; upgrade the collector"
        )
    try:
        publisher = doc["publisher"]
        seq = int(doc["seq"])
        t = float(doc["t"])
    except (KeyError, TypeError, ValueError) as err:
        raise WireError(f"snapshot header incomplete: {err!r}") from err
    states, buffer, layout = None, None, ()
    if doc.get("states") is not None:
        states, buffer, layout = _decode_states(doc["states"])
    telemetry = doc.get("telemetry", [])
    if not isinstance(telemetry, list):
        raise WireError("telemetry payload must be a list of counter payloads")
    mode = doc.get("mode", "state")
    if mode not in MODES:
        raise WireError(f"unknown snapshot mode {mode!r}")
    return Snapshot(
        publisher=publisher,
        seq=seq,
        t=t,
        host=doc.get("host", ""),
        process=int(doc.get("process", 0)),
        mode=mode,
        tier=doc.get("tier", "leaf"),
        schema=schema,
        manifest_hash=doc.get("manifest_hash", ""),
        states=states,
        states_key=doc.get("states_key"),
        telemetry=telemetry,
        span=doc.get("span") if isinstance(doc.get("span"), dict) else None,
        buffer=buffer,
        layout=layout,
    )
