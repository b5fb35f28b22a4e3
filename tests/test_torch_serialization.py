"""The port's flax msgpack codec (``ssde_tpu_torch.serialization``) against
flax's own, and the ``.ckpt`` unpickler's refusals.

``msgpack_restore`` must read what ``flax.serialization.to_bytes`` writes
(float32, int32, 0-d, empty-map leaves, leaves over 64 KiB that take bin32
and ext32) to equal arrays of the same dtype, and ``msgpack_serialize`` must
give flax's ``msgpack_serialize`` bytes exactly.
"""

import pickle

import numpy as np
import pytest

import flax.serialization
import jax.numpy as jnp

from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.serialization import msgpack_restore, msgpack_serialize


def _tree(rs):
    """Leaves of every encoding the JAX checkpoints use, keys out of order."""
    return {
        "params": {
            "conv": {"kernel": rs.randn(3, 3, 4, 8).astype(np.float32),
                     "bias": rs.randn(8).astype(np.float32)},
            "big": rs.randn(130, 150).astype(np.float32),  # 78,000 bytes: bin32, ext32
            "small": rs.randn(1).astype(np.float32),  # a fixext ndarray
            "h0": rs.randn(1, 4, 8, 2).astype(np.float64),
        },
        "count": np.asarray(7, np.int32),  # 0-d
        "ids": np.arange(-3, 40, dtype=np.int32),
        "flag": np.array([True, False]),
        "empty": {},  # optax's EmptyState
        "1": {"0": {"scalar": np.float32(2.5)}},  # a numpy scalar: ext 3
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_restore_reads_flax_to_bytes():
    tree = _tree(np.random.RandomState(0))
    data = flax.serialization.to_bytes(tree)
    _assert_same(msgpack_restore(data), tree)
    # a tuple of the JAX state (optax's chain) comes back keyed "0", "1", ...
    chain = (jnp.zeros((), jnp.int32), {"mu": jnp.ones((2, 3))}, ())
    got = msgpack_restore(flax.serialization.to_bytes(chain))
    assert sorted(got) == ["0", "1", "2"] and got["2"] == {}
    _assert_same(got["1"], {"mu": np.ones((2, 3), np.float32)})


def test_restore_reads_python_scalars_and_strings():
    tree = {"i": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
                  -32768, -32769, -2 ** 31 - 1],
            "f": 1.5, "s": "x" * 40, "b": b"\x00" * 300, "n": None, "t": True}
    data = flax.serialization.msgpack_serialize(tree)
    assert msgpack_restore(data) == tree
    assert msgpack_serialize(tree) == data


def test_bfloat16_widens_exactly():
    x = jnp.asarray(np.random.RandomState(1).randn(5, 7), jnp.bfloat16)
    got = msgpack_restore(flax.serialization.to_bytes({"w": x}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x.astype(jnp.float32)))


def test_serialize_is_byte_identical_to_flax():
    tree = _tree(np.random.RandomState(2))
    want = flax.serialization.msgpack_serialize(tree)
    assert msgpack_serialize(tree) == want
    # and what it writes, flax reads back to the same tree
    _assert_same(flax.serialization.msgpack_restore(msgpack_serialize(tree)), tree)


def test_refusals(tmp_path):
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
                     "chunks": {"0": np.zeros(2, np.float32)}}}
    with pytest.raises(ValueError, match="chunked"):
        msgpack_restore(flax.serialization.msgpack_serialize(chunked))
    with pytest.raises(ValueError, match="big-endian"):
        msgpack_serialize({"w": np.zeros(3, ">f4")})
    with pytest.raises(TypeError, match="tuple"):
        msgpack_serialize({"w": (1, 2)})
    with pytest.raises(ValueError, match="bytes after"):
        msgpack_restore(flax.serialization.msgpack_serialize({"a": 1}) + b"\x00")
    # a .ckpt pickle that names a global (here numpy's) is refused by name
    path = tmp_path / "encoder.ckpt"
    path.write_bytes(pickle.dumps({"params": b"\x80", "extra": {"h": np.int64(3)}}))
    with pytest.raises(ValueError, match="encoder.ckpt.*global numpy"):
        checkpoint.load_module(str(path))
