"""The port's fleet wire format (``metrics_tpu_torch.observability.wire``)
on the CPU, held to the JAX package's.

Each contract of ``tests/bases/test_wire.py`` has a case here: bit-exact
leaf round-trips, the provenance header, the ``WireError`` boundary and the
states helpers. Beyond them: a port blob and a JAX blob of the same states
(the same seeded numpy batches through both packages' metrics) carry the
same header fields and leaf bytes, the class paths of ``states_key`` aside;
each package decodes the other's leaves bit for bit; a snapshot of one
package sent to the other's collector counts one ``fold_error``; and the
bfloat16 property of the reference is pinned (its wire writes ``'<V2'`` and
decodes raw ``|V2`` bytes; the port writes the same bytes and decodes them
as bfloat16).
"""
import base64
import hashlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as jm
import metrics_tpu.observability.wire as jwire
import metrics_tpu_torch as tm
from metrics_tpu.observability import FleetCollector as JaxFleetCollector
from metrics_tpu_torch.aggregation import SumMetric
from metrics_tpu_torch.classification import Accuracy, ConfusionMatrix
from metrics_tpu_torch.observability import FleetCollector
from metrics_tpu_torch.observability.wire import (
    WIRE_MAGIC,
    WIRE_SCHEMA_VERSION,
    WireError,
    _leaf_key,
    decode_snapshot,
    encode_snapshot,
    manifest_fingerprint,
    snapshot_states,
    states_key,
)

torch.set_num_threads(2)

T0 = 100.0


def _round_trip(states):
    blob = encode_snapshot(publisher="p", seq=0, t=T0, states=states)
    return decode_snapshot(blob).states


def _port_collection():
    return tm.MetricCollection({"acc": Accuracy(num_classes=2, device="cpu"), "mse": tm.MeanSquaredError(device="cpu")})


def _jax_collection():
    return jm.MetricCollection({"acc": jm.classification.Accuracy(num_classes=2), "mse": jm.MeanSquaredError()})


def _batches(seed, n=3, bs=16):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 2, bs).astype(np.int32), rng.randint(0, 2, bs).astype(np.int32)) for _ in range(n)]


def _both_collections(seed=0):
    port, ref = _port_collection(), _jax_collection()
    for preds, target in _batches(seed):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    return port, ref


class TestLeafCodec:
    @pytest.mark.parametrize(
        "dtype", [np.int32, np.int64, np.float32, np.float64, np.uint8, np.bool_], ids=lambda d: np.dtype(d).name
    )
    def test_array_round_trip_bit_exact(self, dtype):
        rng = np.random.RandomState(0)
        arr = (rng.rand(3, 5) * 100).astype(dtype)
        out = _round_trip({"m": {"x": torch.from_numpy(arr)}})["m"]["x"]
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert out.numpy().dtype == arr.dtype and out.shape == arr.shape
        assert out.numpy().tobytes() == arr.tobytes()
        # the leaf's spec is the JAX package's, byte for byte
        port_doc = json.loads(encode_snapshot(publisher="p", seq=0, t=T0, states={"m": {"x": torch.from_numpy(arr)}}))
        jax_doc = json.loads(jwire.encode_snapshot(publisher="p", seq=0, t=T0, states={"m": {"x": arr}}))
        assert port_doc["states"] == jax_doc["states"]

    def test_int64_values_survive_json(self):
        big = torch.tensor([2**53 + 1, -(2**62)], dtype=torch.int64)
        out = _round_trip({"m": {"x": big}})["m"]["x"]
        assert torch.equal(out, big)

    def test_float32_bits_survive(self):
        vals = torch.tensor([0.1, 1e-38, 3.4e38, float("inf"), float("-inf")], dtype=torch.float32)
        out = _round_trip({"m": {"x": vals}})["m"]["x"]
        assert out.numpy().tobytes() == vals.numpy().tobytes()

    def test_tensor_and_numpy_leaves_decode_as_cpu_tensors(self):
        out = _round_trip({"m": {"x": torch.tensor([1, 2, 3], dtype=torch.int32), "y": np.asarray([4, 5], np.int16)}})["m"]
        assert torch.equal(out["x"], torch.tensor([1, 2, 3], dtype=torch.int32))
        assert out["y"].dtype == torch.int16 and out["y"].tolist() == [4, 5]

    def test_python_scalars_and_list_states(self):
        states = {"m": {"n": 7, "f": 0.5, "cat": [torch.ones(2), torch.zeros(3)]}}
        out = _round_trip(states)["m"]
        assert out["n"] == 7 and out["f"] == 0.5
        assert len(out["cat"]) == 2
        assert torch.equal(out["cat"][0], torch.ones(2)) and torch.equal(out["cat"][1], torch.zeros(3))

    def test_zero_dim_array(self):
        out = _round_trip({"m": {"x": torch.tensor(3.5)}})["m"]["x"]
        assert out.shape == () and float(out) == 3.5

    def test_leaves_view_one_aligned_buffer(self):
        snap = decode_snapshot(
            encode_snapshot(publisher="p", seq=0, states={"m": {"a": torch.arange(3, dtype=torch.int8), "b": torch.ones(5, dtype=torch.float64)}})
        )
        assert snap.buffer is not None and snap.buffer.dtype == torch.uint8
        for _, _, _, offset, _, _, _ in snap.layout:
            assert offset % 16 == 0
        assert snap.states["m"]["b"].untyped_storage().data_ptr() == snap.buffer.untyped_storage().data_ptr()
        # the CPU is its own device: no copy
        assert snap.to_device("cpu") is snap.states


class TestHeader:
    def test_provenance_fields(self):
        snap = decode_snapshot(encode_snapshot(publisher="pub0", seq=17, t=123.5, host="h0", process=3, tier="rack"))
        assert (snap.publisher, snap.seq, snap.t, snap.host, snap.process, snap.tier) == ("pub0", 17, 123.5, "h0", 3, "rack")
        assert snap.schema == WIRE_SCHEMA_VERSION == jwire.WIRE_SCHEMA_VERSION
        assert snap.key == ("pub0", 17)

    def test_manifest_hash_rides_the_header(self):
        snap = decode_snapshot(encode_snapshot(publisher="p", seq=0, t=1.0))
        assert snap.manifest_hash == manifest_fingerprint() != ""

    def test_manifest_fingerprint_stable_and_empty_until_the_port_has_manifests(self):
        # the port has its own manifests now: the JAX package's formula over
        # the port's two files, stable, and not the JAX package's
        from metrics_tpu_torch.analysis.layout import default_layout_manifest_path
        from metrics_tpu_torch.analysis.manifest import default_manifest_path

        fp = manifest_fingerprint()
        assert fp == manifest_fingerprint() and len(fp) == 16 and int(fp, 16) >= 0
        data = default_manifest_path().read_bytes() + b"\x00" + default_layout_manifest_path().read_bytes()
        assert fp == hashlib.sha256(data).hexdigest()[:16]
        assert fp != jwire.manifest_fingerprint()

    def test_mode_validated(self):
        with pytest.raises(ValueError, match="mode"):
            encode_snapshot(publisher="p", seq=0, mode="increment")
        with pytest.raises(ValueError, match="publisher"):
            encode_snapshot(publisher="", seq=0)
        with pytest.raises(ValueError, match="seq"):
            encode_snapshot(publisher="p", seq=-1)

    def test_telemetry_normalizes_to_list(self):
        one = {"process": 0, "call_counts": {}}
        assert decode_snapshot(encode_snapshot(publisher="p", seq=0, telemetry=one)).telemetry == [one]
        assert len(decode_snapshot(encode_snapshot(publisher="p", seq=0, telemetry=[one, one])).telemetry) == 2

    def test_span_context_rides_schema_v2(self):
        ctx = {"span_id": 4, "parent_id": None, "t": 12.0}
        assert decode_snapshot(encode_snapshot(publisher="p", seq=0, span=ctx)).span == ctx
        assert decode_snapshot(encode_snapshot(publisher="p", seq=0)).span is None


class TestWireErrorBoundary:
    def test_garbage_bytes(self):
        with pytest.raises(WireError):
            decode_snapshot(b"not json at all")

    def test_truncated_json(self):
        blob = encode_snapshot(publisher="p", seq=0)
        with pytest.raises(WireError):
            decode_snapshot(blob[: len(blob) // 2])

    def test_foreign_magic(self):
        with pytest.raises(WireError, match="magic"):
            decode_snapshot(json.dumps({"magic": "something-else", "schema": 1}).encode())

    def test_future_schema_refused(self):
        doc = json.loads(encode_snapshot(publisher="p", seq=0).decode())
        doc["schema"] = WIRE_SCHEMA_VERSION + 1
        with pytest.raises(WireError, match="newer"):
            decode_snapshot(json.dumps(doc).encode())

    @pytest.mark.parametrize("corrupt", ["!!!not-base64!!!", "AAAA"], ids=["base64", "length"])
    def test_corrupt_array_leaf(self, corrupt):
        doc = json.loads(encode_snapshot(publisher="p", seq=0, states={"m": {"x": torch.ones(2)}}).decode())
        doc["states"]["m"]["x"]["__arr__"]["data"] = corrupt
        with pytest.raises(WireError):
            decode_snapshot(json.dumps(doc).encode())

    def test_incomplete_header(self):
        with pytest.raises(WireError, match="incomplete"):
            decode_snapshot(json.dumps({"magic": WIRE_MAGIC, "schema": 1, "publisher": "p"}).encode())


class TestStatesHelpers:
    def test_snapshot_states_metric(self):
        m = SumMetric(device="cpu")
        m.update(torch.tensor([2.0, 3.0]))
        states = snapshot_states(m)
        assert list(states) == ["SumMetric"]
        assert float(states["SumMetric"]["value"]) == 5.0

    def test_snapshot_states_collection(self):
        col = _port_collection()
        col.update(torch.tensor([1, 0]), torch.tensor([1, 1]))
        states = snapshot_states(col)
        assert set(states) == {"acc", "mse"}
        key = states_key(col)
        assert key["acc"]["class"] == "metrics_tpu_torch.classification.accuracy.Accuracy"
        assert sorted(key["acc"]["states"]) == sorted(states["acc"])

    def test_states_key_detects_layout_skew(self):
        a = states_key(tm.MetricCollection({"acc": Accuracy(num_classes=2, device="cpu")}))
        b = states_key(tm.MetricCollection({"acc": Accuracy(num_classes=3, device="cpu")}))
        assert a == b  # scalar-state config skew is structurally invisible
        assert a != states_key(tm.MetricCollection({"acc": SumMetric(device="cpu")}))
        d2 = states_key(tm.MetricCollection({"cm": ConfusionMatrix(num_classes=2, device="cpu")}))
        d3 = states_key(tm.MetricCollection({"cm": ConfusionMatrix(num_classes=3, device="cpu")}))
        assert d2 != d3

    @pytest.mark.parametrize(
        "value,want",
        [
            (7, "int"),
            (torch.tensor(7, dtype=torch.int32), "int"),
            (np.asarray(7, np.int32), "int"),
            (0.5, "float"),
            (torch.tensor(0.5), "float"),
            ([], "list"),
            (torch.zeros(3, 2), "<f4[3, 2]"),
            (torch.zeros(4, dtype=torch.bfloat16), "<V2[4]"),
        ],
        ids=["int", "int32", "np-int32", "float", "float32", "list", "f4", "bf16"],
    )
    def test_leaf_key_scalar_normalization(self, value, want):
        assert _leaf_key(value) == want
        # the JAX package's key of the same leaf
        ref = value.to(torch.float32).numpy().astype(jnp.bfloat16) if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16 else value
        if isinstance(ref, torch.Tensor):
            ref = ref.numpy()
        assert jwire._leaf_key(ref) == want

    def test_collection_states_round_trip_bit_exact(self):
        col = _port_collection()
        col.update(torch.tensor([1, 0, 1]), torch.tensor([1, 1, 0]))
        states = snapshot_states(col)
        snap = decode_snapshot(encode_snapshot(publisher="p", seq=0, states=states, states_template=col))
        for mname, tree in states.items():
            for sname, leaf in tree.items():
                got = snap.states[mname][sname]
                if isinstance(leaf, torch.Tensor):
                    assert got.dtype == leaf.dtype and torch.equal(got, leaf), (mname, sname)
                else:
                    assert got == leaf
        assert snap.states_key == states_key(col)


class TestAgainstTheJaxWire:
    def test_same_states_same_header_and_leaf_bytes(self):
        port, ref = _both_collections(seed=3)
        kw = dict(publisher="pub0", seq=5, t=T0, host="h", process=2, tier="leaf", mode="delta", manifest_hash="")
        port_doc = json.loads(encode_snapshot(states=snapshot_states(port), states_template=port, **kw))
        jax_doc = json.loads(jwire.encode_snapshot(states=jwire.snapshot_states(ref), states_template=ref, **kw))
        assert {k: v for k, v in port_doc.items() if k not in ("states", "states_key")} == {
            k: v for k, v in jax_doc.items() if k not in ("states", "states_key")
        }
        assert port_doc["states"] == jax_doc["states"]
        for name in ("acc", "mse"):
            assert port_doc["states_key"][name]["states"] == jax_doc["states_key"][name]["states"]
            assert port_doc["states_key"][name]["class"].startswith("metrics_tpu_torch.")
            assert jax_doc["states_key"][name]["class"].startswith("metrics_tpu.")

    def test_each_package_decodes_the_others_leaves(self):
        port, ref = _both_collections(seed=4)
        jax_blob = jwire.encode_snapshot(publisher="j", seq=0, t=T0, states=jwire.snapshot_states(ref))
        port_blob = encode_snapshot(publisher="p", seq=0, t=T0, states=snapshot_states(port))
        in_port = decode_snapshot(jax_blob).states
        in_jax = jwire.decode_snapshot(port_blob).states
        for mname, tree in snapshot_states(port).items():
            for sname, leaf in tree.items():
                want = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
                got = in_port[mname][sname]
                assert np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got).tobytes() == want.tobytes()
                assert np.asarray(in_jax[mname][sname]).tobytes() == want.tobytes()

    def test_a_snapshot_of_the_other_package_is_one_fold_error(self):
        port, ref = _both_collections(seed=5)
        jax_blob = jwire.encode_snapshot(publisher="j", seq=0, t=T0, states=jwire.snapshot_states(ref), states_template=ref)
        collector = FleetCollector(template=_port_collection())
        assert not collector.ingest(jax_blob, now=T0)
        assert collector.totals()["fold_errors"] == 1 and collector.fold_states() is None
        assert "layout" in collector.fold_error_details[-1]
        port_blob = encode_snapshot(publisher="p", seq=0, t=T0, states=snapshot_states(port), states_template=port)
        ref_collector = JaxFleetCollector(template=_jax_collection())
        assert not ref_collector.ingest(port_blob, now=T0)
        assert ref_collector.totals()["fold_errors"] == 1

    def test_bfloat16_leaf_property_of_the_reference_is_pinned(self):
        bits = np.asarray([0x3FC0, 0x4000, 0x7FC0, 0xFF80, 0x0001], np.uint16)
        port_leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        jax_leaf = jnp.asarray(bits).view(jnp.bfloat16)
        port_doc = json.loads(encode_snapshot(publisher="p", seq=0, t=T0, states={"m": {"x": port_leaf}}))
        jax_doc = json.loads(jwire.encode_snapshot(publisher="p", seq=0, t=T0, states={"m": {"x": jax_leaf}}))
        # both write '<V2' and the same bytes
        assert jax_doc["states"]["m"]["x"]["__arr__"]["dtype"] == "<V2"
        assert port_doc["states"] == jax_doc["states"]
        assert base64.b64decode(port_doc["states"]["m"]["x"]["__arr__"]["data"]) == bits.tobytes()
        # the reference decodes raw void bytes (its collector cannot fold them)
        jax_out = jwire.decode_snapshot(json.dumps(jax_doc).encode()).states["m"]["x"]
        assert jax_out.dtype.kind == "V" and jax_out.dtype.str == "|V2"
        assert jax_out.tobytes() == bits.tobytes()
        # the port decodes bfloat16, bit for bit
        port_out = decode_snapshot(json.dumps(jax_doc).encode()).states["m"]["x"]
        assert port_out.dtype == torch.bfloat16
        assert port_out.view(torch.int16).numpy().view(np.uint16).tolist() == bits.tolist()
