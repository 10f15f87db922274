"""The crash shield's snapshot pack (``rca/shield._snapshot_pack`` and
``_snapshot_unpack``) against the JAX package's, its kernel preparation
and what the shield leaves to multi-device serving.

The pack equals the JAX package's flat buffer on the dtypes both carry and
round-trips every resident dtype bit for bit through a persisted snapshot.
A kernel's build, load or launch error (``kernels._build.KernelError``)
surfaces from the guarded call at once: it never walks the ladder.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.kernels import _build
from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as t_shield
from kubernetes_aiops_evidence_graph_tpu_torch.rca.faults import TICK_STAGES
from kubernetes_aiops_evidence_graph_tpu_torch.rca.journal import DeltaJournal
from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)


def _arrays(rng):
    f = rng.normal(size=(48, 8)).astype(np.float32)
    f[3, 2] = np.nan
    f.view(np.int32)[5, 1] = 0x7FC00123        # a NaN with a payload
    f[6, 0], f[7, 7] = -0.0, np.inf
    f.view(np.int32)[8, 4] = 1                 # a denormal
    return [f, rng.integers(-5, 1 << 20, (48, 16)).astype(np.int32),
            rng.integers(0, 9, 48).astype(np.int32),
            rng.random((48, 3)) < 0.5]


def test_snapshot_pack_equals_the_jax_flat_buffer():
    """float32 (NaN payloads, -0.0, inf, a denormal), int32 and bool: the
    port's one flat int32 tensor is the JAX package's element for element,
    and the layout names the same shapes and dtypes."""
    import jax.numpy as jnp
    from kubernetes_aiops_evidence_graph_tpu.rca import shield as j_shield
    arrays = _arrays(np.random.default_rng(0))
    tensors = [torch.from_numpy(a) for a in arrays]
    flat = t_shield._snapshot_pack(*tensors)
    want = np.asarray(j_shield._snapshot_pack(*[jnp.asarray(a)
                                                for a in arrays]))
    assert flat.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(flat.numpy(), want)
    layout = t_shield._snapshot_layout(tensors)
    assert layout == tuple((tuple(a.shape), str(a.dtype)) for a in arrays)
    back = j_shield._snapshot_unpack(jnp.asarray(flat.numpy()),
                                     layout=layout)
    for a, b in zip(arrays, back):       # JAX restores bool as int32
        got = np.asarray(b)
        if a.dtype == np.float32:
            got, a = got.view(np.int32), a.view(np.int32)
        np.testing.assert_array_equal(got.astype(a.dtype), a)


def test_every_resident_dtype_round_trips_through_a_persisted_snapshot(
        tmp_path):
    """pack → persist (the journal's atomic snapshot) → load → unpack is
    bit-exact for every dtype a resident scorer carries: float32, the
    streamed tier's bf16 and int8 tables, int32 and bool (and the other
    small dtypes the pack widens)."""
    rng = np.random.default_rng(1)
    f, i32, vec, b = _arrays(rng)
    tensors = [torch.from_numpy(f), torch.from_numpy(f).to(torch.bfloat16),
               torch.from_numpy(f[:, :4]).to(torch.float16),
               torch.from_numpy(rng.integers(-127, 128, (48, 8))
                                .astype(np.int8)),
               torch.from_numpy(rng.integers(0, 256, 10).astype(np.uint8)),
               torch.from_numpy(rng.integers(-30000, 30000, 7)
                                .astype(np.int16)),
               torch.from_numpy(i32), torch.from_numpy(vec),
               torch.from_numpy(b), torch.zeros((0, 8))]
    tensors[1][0, 0] = float("nan")
    layout = t_shield._snapshot_layout(tensors)
    journal = DeltaJournal(str(tmp_path))
    journal.write_snapshot({"layout": layout, "flat": t_shield._snapshot_pack(
        *tensors).numpy()})
    state = journal.load_snapshot()
    journal.close()
    back = t_shield._snapshot_unpack(torch.from_numpy(state["flat"]),
                                     state["layout"])
    for t, u in zip(tensors, back):
        assert u.dtype == t.dtype and u.shape == t.shape
        assert u.is_contiguous()
        assert torch.equal(u.view(torch.uint8), t.view(torch.uint8))


def test_pack_refuses_a_dtype_it_cannot_carry():
    with pytest.raises(TypeError, match="int64"):
        t_shield._snapshot_pack(torch.zeros(3, dtype=torch.int64))


def test_fault_classes_cover_every_tick_stage():
    assert {f[0][0]["stage"] for f in W.FAULTS.values()} == set(TICK_STAGES)
    assert {f["stage"] for f in W.LEARNED_FAULTS.values()} == set(TICK_STAGES)


@pytest.mark.parametrize("tier", ["rules", "walk"])
def test_kernels_are_prepared_before_the_first_tick(tier, params,  # noqa: F811
                                                    tmp_path, monkeypatch):
    """On the CPU the shield builds nothing (every wrapper runs its plain
    version); on the card it builds and loads, before its first tick, the
    kernels of every tier the scorer can walk and of the rules fallback,
    and a build error raises from the constructor."""
    cfg = W.settings(tier=tier)
    cluster, builder, _ = W._world(W.PORT_PKG, cfg, num_pods=60)
    scorer = W.make_scorer(W.PORT_PKG, tier, builder.store, cfg,
                           cluster.now.timestamp(), params)
    shield = t_shield.ShieldedScorer(scorer, cfg, directory=str(tmp_path))
    shield.close()
    assert shield.kernels == ()
    built = []

    def fail(names):
        built.append(tuple(names))
        raise _build.KernelError("kernel build failed: stub")

    monkeypatch.setattr(_build, "build_all", fail)
    monkeypatch.setattr(scorer, "device", torch.device("cuda", 0))
    with pytest.raises(_build.KernelError, match="stub"):
        t_shield.ShieldedScorer(scorer, cfg, directory=str(tmp_path / "b"))
    assert built == [("rules_fold",) if tier == "rules"
                     else ("rules_fold", "gms", "fused_tick")]


def test_a_kernel_error_surfaces_and_never_walks_the_ladder(tmp_path,
                                                            monkeypatch):
    """A launch error from a kernel wrapper is a defect, not a device
    fault: the guarded call raises it at once, with no retry, recovery or
    tier transition."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import streaming
    cfg = W.settings()
    cluster, builder, _ = W._world(W.PORT_PKG, cfg, num_pods=60)
    scorer = W.make_scorer(W.PORT_PKG, "rules", builder.store, cfg,
                           cluster.now.timestamp(), None)
    shield = t_shield.ShieldedScorer(scorer, cfg, directory=str(tmp_path))
    try:
        shield.recover_or_snapshot()

        def broken(*_a, **_k):
            raise _build.KernelError("rules_fold launch failed: stub")

        monkeypatch.setattr(streaming, "rules_fold", broken)
        with pytest.raises(_build.KernelError, match="stub"):
            shield.rescore()
        assert shield.tier_log == [] and shield.recoveries == 0
    finally:
        shield.close()


def test_mesh_operations_wait_for_multi_device_serving(tmp_path):
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import heal
    run = W.run(tmp_path, events=20)
    for call in (lambda s: s.mesh_heal(positions=(0,)), lambda s: s.reexpand(),
                 lambda s: s.scale_mesh(2)):
        with pytest.raises(NotImplementedError, match="item 9"):
            call(run.shield)
    assert run.shield.stats()["serving_shards"] == 1
    assert "mesh_heal" not in t_shield.LADDER
    for call in (lambda: heal.survivor_mesh(2), lambda: heal.device_index(0)):
        with pytest.raises(NotImplementedError, match="item 9"):
            call()
