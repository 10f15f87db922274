"""Multi-tenant serving: for now only the atomic params swap across tenants.

The port of ``swap_tenants_atomically`` from the JAX package's
``rca/surge.py``, which the online learner (``learn/loop.py``) calls. The
rest of that module (``MultiTenantScorer``, ``SurgeServer``, live
migration) is ROADMAP item 7.
"""
from __future__ import annotations

from contextlib import ExitStack

import numpy as np
import torch


def swap_tenants_atomically(targets, params, source: str = "") -> int:
    """Flip EVERY tenant's resident GNN scorer to one new params generation
    atomically: acquire every target's ``serve_lock`` FIRST (in the
    caller's stable registration order — every swapper must use this
    helper, which is what makes the ordered acquisition deadlock-free),
    then install the same generation through each scorer's locked seam.
    No tick on any tenant can observe a mix: in-flight ticks complete on
    the old generation, and every dispatch that starts after this returns
    serves the new one. A target that carries a ``journal`` (a shielded
    scorer) gets a ``params_swap`` record with the exact leaves before the
    swap applies. Returns the shared new generation (1 + the max across
    tenants)."""
    targets = list(targets)
    if not targets:
        raise ValueError("swap_tenants_atomically needs >= 1 scorer")
    with ExitStack() as stack:
        for t in targets:
            stack.enter_context(t.serve_lock)
        gen = 1 + max(int(getattr(t, "params_generation", 0))
                      for t in targets)
        leaves = None
        for t in targets:
            journal = getattr(t, "journal", None)   # shielded-scorer seam
            scorer = getattr(t, "scorer", t)
            if journal is not None:
                if leaves is None:
                    from .gnn import flat_params
                    leaves = [np.asarray(v.detach().cpu() if isinstance(
                        v, torch.Tensor) else v)
                        for v in flat_params(params).values()]
                seq = int(scorer._synced_seq)
                journal.append((), seq, seq, kind="params_swap",
                               force_sync=True, generation=gen,
                               leaves=leaves, source=source)
            scorer._swap_params_locked(params, gen, source=source)
    return gen
