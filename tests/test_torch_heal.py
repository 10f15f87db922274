"""The port's ``rca/heal.py`` against the JAX package's: the attestation fold (torch, on the tensors' device) equals the
JAX ``attest_fold`` and the host oracle ``attest_host`` at 1, 2 and 4
shards on every dtype a resident table carries, NaN payloads included,
and flags exactly the corrupted block (tests/test_heal.py:183); the
survivor mesh over a pool of positions matches the JAX package's over
its devices."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.rca import heal as j_heal
from kubernetes_aiops_evidence_graph_tpu_torch.rca import heal as t_heal

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _tables(seed: int):
    """Node-addressed tables as a scorer holds them: float32 features
    with NaN payloads, -0.0 and inf; int32 kinds; float32 masks; bool;
    int8 (the quantized table)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(48, 8)).astype(np.float32)
    feats.view(np.int32)[2, 3] = 0x7FC00042
    feats.view(np.int32)[9, 1] = np.int32(-0x00400001)   # negative NaN
    feats[4, 4], feats[30, 0] = -0.0, np.inf
    kind = rng.integers(0, 9, 48).astype(np.int32)
    kind[7] = -1
    mask = (rng.random(48) < 0.7).astype(np.float32)
    live = rng.random((48, 2)) < 0.5
    q = rng.integers(-127, 128, (48, 8)).astype(np.int8)
    return [feats, kind, mask, live, q]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_attest_fold_equals_jax_and_the_host_oracle(shards, seed):
    import jax.numpy as jnp
    tables = _tables(seed)
    got = t_heal.attest_fold(*[torch.from_numpy(a) for a in tables],
                             shards=shards)
    assert got.dtype == torch.int64 and got.shape == (len(tables), shards)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF
    want = np.asarray(j_heal.attest_fold(*[jnp.asarray(a) for a in tables],
                                         shards=shards))
    host = t_heal.attest_host(tables, shards)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(host, j_heal.attest_host(tables, shards))
    np.testing.assert_array_equal(got.numpy(), host.astype(np.int64))


def test_attest_fold_of_a_bf16_table_equals_jax():
    """A bf16 table folds its float32 value in both packages (finite
    values: the two libraries' float32 → bf16 casts keep different NaN
    payloads)."""
    import jax.numpy as jnp
    feats = np.nan_to_num(_tables(2)[0], nan=1.5, posinf=-2.0)
    got = t_heal.attest_fold(torch.from_numpy(feats).to(torch.bfloat16),
                             shards=4)
    want = np.asarray(j_heal.attest_fold(
        jnp.asarray(feats).astype(jnp.bfloat16), shards=4))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shards,block", [(4, 1), (4, 3), (2, 0), (1, 0)])
def test_attest_flags_exactly_the_corrupted_block(shards, block):
    tables = _tables(3)
    host = t_heal.attest_host(tables, shards)
    bad = torch.from_numpy(tables[0].copy())
    rows = 48 // shards
    bad[block * rows:(block + 1) * rows] = float("nan")
    dev = t_heal.attest_fold(bad, *[torch.from_numpy(a)
                                    for a in tables[1:]], shards=shards)
    mism = dev.numpy() != host
    assert mism[0].tolist() == [k == block for k in range(shards)]
    assert not mism[1:].any()
    # a NaN with another payload in a clean block still flags
    other = torch.from_numpy(tables[0].copy())
    other.view(torch.int32)[2, 3] = 0x7FC00043
    dev = t_heal.attest_fold(other, shards=shards)
    assert (dev.numpy()[0] != host[0]).tolist() == [
        k == 2 // rows for k in range(shards)]


def test_the_mesh_waits_for_multi_device_serving():
    """The survivor mesh and the position identity: ``survivor_mesh``
    builds ``(1 x D')`` from a pool of positions less the excluded pool
    indices, in the JAX package's device order (tests/test_heal.py:162),
    and ``device_index`` reads a position's pool index, never comparing
    devices (every position of a CPU pool is the same ``torch.device``)."""
    pool = [torch.device("cpu")] * 8
    m = t_heal.survivor_mesh(3, exclude=(2,), pool=pool)
    want = j_heal.survivor_mesh(3, exclude=(2,))
    assert m.shape == dict(zip(want.axis_names, want.devices.shape)) == {
        "dp": 1, "graph": 3}
    assert m.pool_index.ravel().tolist() == [d.id for d in
                                             want.devices.flat] == [0, 1, 3]
    assert [t_heal.device_index(m, p) for p in range(3)] == [0, 1, 3]
    assert t_heal.survivor_mesh(1, (), pool) is None
    assert t_heal.survivor_mesh(8, (0,), pool) is None
    assert j_heal.survivor_mesh(8, exclude=(0,)) is None
    m2 = t_heal.survivor_mesh(2, (0, 1, 3), pool)
    assert m2.pool_index.ravel().tolist() == [2, 4]
