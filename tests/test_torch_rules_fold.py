"""The port's rules_fold (evidence fold + rules tail) against the JAX
package: its plain PyTorch version must equal ``_score_device`` and the
Pallas kernel's ``score_device_pallas`` (interpret mode on the CPU) on
every output, exactly — the counts are integer-valued f32, so sums are
exact in any order, and the scores are table lookups. The kernel's
condition/rule tables are checked here by a numpy emulation of the
kernel's tail; the kernel itself runs only on the card (``cuda`` marker)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.experiments.pallas_rules import (
    fused_rules_engine, score_device_pallas)
from kubernetes_aiops_evidence_graph_tpu.graph.schema import DIM, F
from kubernetes_aiops_evidence_graph_tpu.rca import tpu_backend as jtb
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
from kubernetes_aiops_evidence_graph_tpu_torch.rca import RULE_INDEX
from chip_smoke import fold_edge_rows
from tests.test_rca_parity import run_pipeline

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

OUTPUTS = ("conds", "matched", "scores", "top_idx", "any_match",
           "top_conf", "top_score")


def _assert_same(port, ref, what=""):
    for name, a, b in zip(OUTPUTS, port, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


def _jax_score(batch_arrays, pair_width, pallas=False):
    features, ev_idx, ev_cnt, ev_pair, chain = map(jnp.asarray, batch_arrays)
    kw = dict(padded_incidents=ev_idx.shape[0], pair_width=pair_width)
    if pallas:
        return score_device_pallas(features, ev_idx, ev_cnt, ev_pair, chain,
                                   interpret=True, **kw)
    return jtb._score_device(features, ev_idx, ev_cnt, ev_pair, chain, **kw)


def _port_score(batch_arrays, pair_width):
    return rf.rules_fold(*(torch.from_numpy(np.ascontiguousarray(a))
                           for a in batch_arrays), pair_width)


def _random_batch(seed, pn, pi, width, pair_width):
    rng = np.random.default_rng(seed)
    features = ((rng.random((pn, DIM)) < 0.15)
                * rng.integers(1, 4, (pn, DIM))).astype(np.float32)
    features[:, F.POD_PROBLEM] = rng.random(pn) < 0.5
    ev_cnt = rng.integers(0, width + 1, pi).astype(np.int32)
    ev_cnt[::5] = 0
    ev_idx = rng.integers(0, pn, (pi, width)).astype(np.int32)
    ev_pair = rng.integers(0, pair_width + 1, (pi, width)).astype(np.int32)
    return (features, ev_idx, ev_cnt, ev_pair, np.zeros(pi, np.float32))


def test_plain_matches_score_device_and_pallas_on_scenarios():
    _, _, snapshot = run_pipeline(
        ["crashloop_deploy", "oom", "imagepull", "network", "node_pressure",
         "hpa_maxed", "probe_failure", "config_error", "oom_pressure",
         "crashloop"], num_pods=300, seed=17)
    b = jtb.TpuRcaBackend().prepared(snapshot)
    arrays = (b.features, b.ev_idx, b.ev_cnt, b.ev_pair_slot,
              np.zeros(b.padded_incidents, np.float32))
    port = _port_score(arrays, b.pair_width)
    assert port[4][:snapshot.num_incidents].all()
    _assert_same(port, _jax_score(arrays, b.pair_width), "_score_device")
    _assert_same(port, _jax_score(arrays, b.pair_width, pallas=True),
                 "score_device_pallas")


@pytest.mark.parametrize("pn,pi,width,pair_width", [
    (512, 32, 512, 8),      # W > 256: the fold runs in 256-slot chunks
    (512, 32, 64, 128),     # pair width > 64: the pair axis in 64 chunks
    (256, 8, 16, 4),        # the 8-row bucket
], ids=["wide_slots", "wide_pairs", "pi8"])
def test_plain_matches_score_device_at_chunked_shapes(pn, pi, width,
                                                      pair_width):
    arrays = _random_batch(pn + width, pn, pi, width, pair_width)
    port = _port_score(arrays, pair_width)
    assert port[4].any() and not port[4].all()
    _assert_same(port, _jax_score(arrays, pair_width), f"W={width}")


def test_chain_is_added_as_min_zero():
    arrays = list(_random_batch(3, 256, 32, 32, 8))
    arrays[4] = np.linspace(-2.0, 2.0, 32).astype(np.float32)
    _assert_same(_port_score(arrays, 8), _jax_score(arrays, 8), "chain")


def _edge_counts():
    """The synthetic condition-edge rows of tests/test_pallas_rules.py."""
    pi = 8
    counts = np.zeros((pi, DIM), np.float32)
    per_row_max = np.zeros(pi, np.float32)
    counts[0, F.W_CRASHLOOPBACKOFF] = 2
    counts[0, F.HAS_RECENT_DEPLOY] = 1
    counts[1, F.W_CRASHLOOPBACKOFF] = 1
    counts[3, F.LOG_NETWORK] = 5
    counts[3, F.NETWORK_ERROR_COUNT] = 9
    counts[4, F.LOG_CONNECTION] = 1
    counts[4, F.NETWORK_ERROR_COUNT] = 10
    counts[5, F.NODE_NOT_READY] = 1
    per_row_max[5] = 1
    counts[6, F.NODE_NOT_READY] = 1
    per_row_max[6] = 2
    return counts, per_row_max


def test_synthetic_edges_match_jax_tails():
    counts, prm = _edge_counts()
    port = rf.finish_scores(torch.from_numpy(counts), torch.from_numpy(prm))
    _assert_same(port, jtb.finish_scores(jnp.asarray(counts), jnp.asarray(prm),
                                         8), "finish_scores")
    _assert_same(port, fused_rules_engine(jnp.asarray(counts), jnp.asarray(prm),
                                          interpret=True), "fused_rules_engine")
    conds, matched, _, top_idx, any_match, top_conf, top_score = port
    assert top_idx[0] == RULE_INDEX["crashloop_recent_deploy"]
    assert top_idx[1] == RULE_INDEX["crashloop_no_change"]
    assert not any_match[2]
    assert float(top_conf[2]) == pytest.approx(0.3)
    assert float(top_score[2]) == pytest.approx(0.15)
    assert not matched[3, RULE_INDEX["network_error"]]
    assert matched[4, RULE_INDEX["network_error"]]
    assert not matched[5, RULE_INDEX["node_failure_isolated"]]
    assert matched[6, RULE_INDEX["node_failure_isolated"]]
    assert conds[2, 5] and not any_match[2]


def test_synthetic_edges_through_the_fold():
    """The same edges built as evidence slots (one feature row per slot,
    problem pods sharing one pair id) score like the JAX pass."""
    counts, prm = _edge_counts()
    feats = [np.zeros(DIM, np.float32)]
    ev_idx = np.zeros((8, 16), np.int32)
    ev_cnt = np.zeros(8, np.int32)
    ev_pair = np.full((8, 16), 4, np.int32)
    for i in range(8):
        slots = [counts[i]] if counts[i].any() else []
        slots += [np.eye(DIM, dtype=np.float32)[F.POD_PROBLEM]] * int(prm[i])
        for w, f in enumerate(slots):
            ev_idx[i, w] = len(feats)
            feats.append(f)
            if f[F.POD_PROBLEM]:
                ev_pair[i, w] = 0
        ev_cnt[i] = len(slots)
    arrays = (np.stack(feats), ev_idx, ev_cnt, ev_pair, np.zeros(8, np.float32))
    port = _port_score(arrays, 4)
    _assert_same(port, _jax_score(arrays, 4), "edge slots")
    assert port[1][6, RULE_INDEX["node_failure_isolated"]]


def _emulate_kernel_tail(counts, per_row_max):
    """numpy emulation of the CUDA kernel's table-driven tail: what the
    kernel computes from kernel_tables(), lane by lane."""
    t = rf.kernel_tables()
    aug = np.concatenate([counts, per_row_max[:, None]], axis=1)
    pi = counts.shape[0]
    conds = np.zeros((pi, len(t["cond_mask"])), bool)
    for c, (mask, thresh, op) in enumerate(zip(t["cond_mask"], t["cond_thresh"],
                                               t["cond_op"])):
        cols = [f for f in range(DIM + 1) if (int(mask) >> f) & 1]
        s = aug[:, cols[0]].copy()
        for f in cols[1:]:
            s = s + aug[:, f]
        r = s >= thresh if op & 1 else s > thresh
        conds[:, c] = ~r if op & 2 else r
    bits = (conds * (1 << np.arange(conds.shape[1]))).sum(1)
    matched = (bits[:, None] & t["rule_mask"][None]) == t["rule_mask"][None]
    scores = np.where(matched, t["rule_score"][None], 0.0).astype(np.float32)
    any_match = matched.any(1)
    top_idx = scores.argmax(1).astype(np.int32)
    top_conf = np.where(any_match, t["rule_conf"][top_idx],
                        np.float32(0.3)).astype(np.float32)
    top_score = np.where(any_match, scores.max(1),
                         np.float32(0.15)).astype(np.float32)
    return conds, matched, scores, top_idx, any_match, top_conf, top_score


def test_kernel_tables_encode_finish_scores():
    """The kernel reads its conditions and rules from tables; holding a
    numpy emulation of that tail against finish_scores on random and
    threshold counts checks the tables without the card."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 3, (256, DIM)).astype(np.float32)
    counts[rng.random((256, DIM)) < 0.7] = 0
    counts[:, F.NETWORK_ERROR_COUNT] = rng.integers(8, 12, 256)
    per_row_max = rng.integers(0, 4, 256).astype(np.float32)
    edge_counts, edge_prm = _edge_counts()
    counts = np.concatenate([counts, edge_counts])
    per_row_max = np.concatenate([per_row_max, edge_prm])
    ref = rf.finish_scores(torch.from_numpy(counts), torch.from_numpy(per_row_max))
    _assert_same(_emulate_kernel_tail(counts, per_row_max), ref, "tables")


def test_rule_tables_equal_the_jax_backend():
    for name in ("_RULE_COND", "_RULE_REQ", "_FINAL_SCORES", "_CONFIDENCES"):
        np.testing.assert_array_equal(getattr(rf, name), getattr(jtb, name))
    assert (rf._FOLD_CHUNK, rf._PAIR_CHUNK) == (jtb._FOLD_CHUNK, jtb._PAIR_CHUNK)


def test_bound_bytes_counts_live_rows_tables_and_outputs():
    ev_idx = np.arange(3 * 64, dtype=np.int32).reshape(3, 64) % 40
    ev_idx[0] = 99                               # past ev_cnt: never read
    ev_cnt = np.array([0, 3, 70], np.int32)      # 70 clips to the width
    n = rf.bound_bytes(ev_idx, ev_cnt, outputs=False)
    # row 1 gathers rows 24..26, row 2 every row 0..39: 40 distinct rows
    assert n == 40 * DIM * 4 + (3 + 64) * 8 + 3 * 8
    assert rf.bound_bytes(ev_idx, ev_cnt) > n


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version(cuda_device):
    """On the card: the kernel equals its plain version bit for bit at the
    chunked shapes (the tests above hold the plain version to JAX)."""
    for pn, pi, width, pw in ((512, 32, 512, 8), (512, 32, 64, 128),
                              (256, 8, 16, 4)):
        arrays = [torch.from_numpy(a).to(cuda_device)
                  for a in _random_batch(pn, pn, pi, width, pw)]
        before = rf.launches
        got = rf.rules_fold(*arrays, pw)
        torch.cuda.synchronize()
        assert rf.launches == before + 1
        _assert_same([t.cpu() for t in got],
                     [t.cpu() for t in rf.rules_fold_reference(*arrays, pw)],
                     f"W={width}")


@pytest.mark.parametrize("width", [16, 64, 512])
def test_plain_matches_score_device_on_fold_edge_rows(width):
    """The plain version equals the JAX package's _score_device on the fold
    edge rows (chip_smoke.fold_edge_rows' plain inputs: the invalid slots
    taken out), every output exactly."""
    _, plain = fold_edge_rows(width, 256, 16, width, 8, "cpu")
    plain = [t.numpy() for t in plain]
    _assert_same(_port_score(plain, 8), _jax_score(plain, 8),
                 f"edge rows W={width}")


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version_on_fold_edge_rows(cuda_device):
    """On the card, at W 16, 64 and 512 (chip_smoke.fold_edge_rows): rows
    with ev_cnt 0, == W, past W and negative, invalid ids between live
    slots and past ev_cnt, pair ids outside [0, pair_width), NaN features
    (outside POD_PROBLEM: the plain version's one-hot contraction would
    spread such a NaN to every bin), a negative and a NaN chain. The kernel
    equals the plain version on the same rows without their invalid slots,
    bit for bit, and two launches are equal."""
    for width in (16, 64, 512):
        for pair_width in (4, 16, 128):
            args, plain = fold_edge_rows(width + pair_width, 512, 32, width,
                                         pair_width, cuda_device)
            got = rf.rules_fold(*args, pair_width)
            again = rf.rules_fold(*args, pair_width)
            torch.cuda.synchronize()
            want = rf.rules_fold_reference(*(t.cpu() for t in plain),
                                           pair_width)
            what = f"W={width} pair width {pair_width}"
            _assert_same([t.cpu() for t in got], want, what)
            _assert_same([t.cpu() for t in again], want, what)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")
