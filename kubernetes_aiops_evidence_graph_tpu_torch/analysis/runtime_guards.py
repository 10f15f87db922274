"""Pass 3: the runtime guards, the halves of the audit that only a run
can show. A sync, a kernel build mid-serve or a reallocated resident
tensor shows only on CUDA; ``chip_smoke.py`` drives these guards over
the serving tiers on the card, the tests over the CPU path.

* :func:`no_implicit_syncs`: ``torch.cuda.set_sync_debug_mode("error")``
  over a region, restored on exit. A device->host sync inside the region
  (``.item()``, ``.cpu()``, a blocking copy, ``nonzero``) raises. Its
  only upload exemption is the one the tick's feed earns: a
  ``non_blocking`` copy from pinned memory does not synchronize, so the
  tick's staged slab passes and a pageable upload fails. The counterpart
  of the reference's ``no_implicit_transfers(host_to_device=False)``. A
  no-op without CUDA (the AST ``host-sync`` rule is the backstop there).
* :class:`BuildFence`: counts ``kernels/_build.build_all`` and ``load``
  calls. Armed after a tier's first tick, any build or load is a
  violation: a build mid-serve costs an ``nvcc`` run. It stands in for
  the reference's ``CompileFence`` / ``CompileCounter`` (nothing
  retraces: a kernel compiles once).
* :func:`resident_pointers`: the ``data_ptr()`` of every resident tensor
  of a scorer, to compare across ticks: the runtime counterpart of the
  reference's ``tick-donation`` rule (the resident state is updated in
  place, never reallocated).
* :class:`LockOrderGuard`: the dynamic half of the sentinel
  ``lock-order`` rule. Its ``install()`` patches the
  ``threading.Lock``/``RLock`` factories so every lock created after
  install is tagged with its
  allocation site, wraps the port's module-level locks (created at
  import, before any install: :data:`MODULE_LOCKS`), records the
  site-level acquisition graph per thread, and flags any edge that
  closes a cycle.

Stdlib-only at import; torch is imported inside the functions that use
it.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import sys
import threading

# (module of the port, attribute) of every module-level lock, created at
# import: LockOrderGuard.install() wraps them in place
MODULE_LOCKS = (
    ("kernels._build", "_lock"),
    ("rca", "_BUILD_LOCK"),
    ("parallel.compat", "_STREAMS_LOCK"),
)
_PACKAGE = __name__.rsplit(".", 2)[0]


@contextlib.contextmanager
def no_implicit_syncs():
    """Raise on any device->host sync inside the block (see the module
    docstring); the previous debug mode comes back on exit, also when the
    block raises. Without CUDA the block runs unguarded."""
    import torch
    if not torch.cuda.is_available():
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class BuildFence:
    """Counts kernel builds and loads; once armed, every one is a
    violation (:meth:`assert_clean` raises). Install patches
    ``kernels._build.build_all`` and ``load`` (the kernel modules call
    them through the module), uninstall restores them."""

    def __init__(self):
        self.builds = 0
        self.loads = 0
        self.violations: list[dict] = []
        self._armed = False
        self._saved = None
        self._meta = threading.Lock()

    def install(self) -> "BuildFence":
        if self._saved is not None:
            return self
        build = importlib.import_module(f"{_PACKAGE}.kernels._build")
        real_build, real_load = build.build_all, build.load
        self._saved = (build, real_build, real_load)

        def build_all(*a, **kw):
            self._note("build_all", a)
            return real_build(*a, **kw)

        def load(*a, **kw):
            self._note("load", a)
            return real_load(*a, **kw)

        build.build_all, build.load = build_all, load
        return self

    def uninstall(self) -> None:
        if self._saved is not None:
            build, real_build, real_load = self._saved
            build.build_all, build.load = real_build, real_load
            self._saved = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def arm(self) -> None:
        """Start failing on builds and loads (call after a tier's first
        tick, which builds and loads what the tier launches)."""
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    def _note(self, what: str, args: tuple) -> None:
        with self._meta:
            if what == "load":
                self.loads += 1
            else:
                self.builds += 1
            if self._armed:
                self.violations.append({
                    "call": what, "args": [str(a) for a in args],
                    "thread": threading.current_thread().name})

    def assert_clean(self) -> None:
        if self.violations:
            raise AssertionError(
                f"{len(self.violations)} kernel build(s)/load(s) after the "
                f"fence was armed: {self.violations}")


def resident_pointers(scorer) -> dict[str, int]:
    """``data_ptr()`` of every resident tensor of a streaming scorer: the
    tensors a snapshot packs (``_resident_arrays``), the chain operand
    and, on the streamed tier, the two activation buffers. Equal dicts
    across ticks mean the ticks updated the state in place."""
    out = {f"resident[{i}]": int(t.data_ptr())
           for i, t in enumerate(scorer._resident_arrays())
           if hasattr(t, "data_ptr")}
    chain = getattr(scorer, "_chain0", None)
    if hasattr(chain, "data_ptr"):
        out["chain"] = int(chain.data_ptr())
    for i, t in enumerate(getattr(scorer, "_dma_h", None) or ()):
        out[f"dma_h[{i}]"] = int(t.data_ptr())
    return out


class _GuardedLock:
    """Proxy around a real lock that reports acquire/release to the
    guard. Everything else (Condition's ``_is_owned`` etc.) delegates."""

    def __init__(self, guard: "LockOrderGuard", real, site: str):
        self._guard, self._real, self._site = guard, real, site

    def acquire(self, *a, **kw):
        got = self._real.acquire(*a, **kw)
        if got:
            self._guard._note_acquire(self._site)
        return got

    def release(self):
        self._guard._note_release(self._site)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._real, name)


class LockOrderGuard:
    """Dynamic lock-ordering witness (the runtime half of the static
    sentinel ``lock-order`` rule).

    Locks are classed by ALLOCATION SITE (``file.py:line`` of the
    ``threading.Lock()`` call; ``module:attr`` for a module-level lock):
    every scorer's ``serve_lock`` is one class, every server's ``_lock``
    another. Acquiring B while holding A records the site edge A->B; an
    acquisition whose new edge closes a cycle in the site graph is the
    deadlock shape: two threads walking the cycle in opposite directions
    can deadlock even if this run, single-threaded, sailed through.

    Opt-in: install patches the lock factories for the whole process and
    wraps :data:`MODULE_LOCKS`; uninstall (or leaving the ``with`` block)
    restores both, so no later code inherits the guard. Violations
    collect in :attr:`violations`; :meth:`assert_clean` raises on any.
    """

    def __init__(self):
        self.violations: list[dict] = []
        self._edges: set[tuple] = set()
        self._tls = threading.local()
        self._meta = threading.Lock()   # pre-patch factory: not tracked
        self._saved = None
        self._wrapped: list[tuple] = []

    # -- factory patching ---------------------------------------------

    def _site(self) -> str:
        f = sys._getframe(2)
        here = (__file__, threading.__file__)
        while f is not None and f.f_code.co_filename in here:
            f = f.f_back
        if f is None:
            return "<unknown>"
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"

    def install(self) -> "LockOrderGuard":
        if self._saved is not None:
            return self
        real_lock, real_rlock = threading.Lock, threading.RLock
        self._saved = (real_lock, real_rlock)

        def lock_factory():
            return _GuardedLock(self, real_lock(), self._site())

        def rlock_factory():
            return _GuardedLock(self, real_rlock(), self._site())

        threading.Lock = lock_factory
        threading.RLock = rlock_factory
        for mod_name, attr in MODULE_LOCKS:
            mod = importlib.import_module(f"{_PACKAGE}.{mod_name}")
            real = getattr(mod, attr)
            setattr(mod, attr, _GuardedLock(self, real, f"{mod_name}:{attr}"))
            self._wrapped.append((mod, attr, real))
        return self

    def uninstall(self) -> None:
        if self._saved is not None:
            threading.Lock, threading.RLock = self._saved
            self._saved = None
        for mod, attr, real in self._wrapped:
            setattr(mod, attr, real)
        self._wrapped.clear()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- acquisition bookkeeping --------------------------------------

    def _held(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _note_acquire(self, site: str) -> None:
        held = self._held()
        with self._meta:
            for h in held:
                if h == site:   # re-entrant same-class: not an ordering
                    continue
                if (h, site) not in self._edges and \
                        self._reaches(site, h):
                    self.violations.append({
                        "cycle": (h, site),
                        "thread": threading.current_thread().name,
                        "path": self._path(site, h),
                    })
                self._edges.add((h, site))
        held.append(site)

    def _note_release(self, site: str) -> None:
        held = self._held()
        # remove the innermost matching frame (locks are released LIFO in
        # `with` blocks; tolerate hand-rolled ordering)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                break

    def _reaches(self, src: str, dst: str) -> bool:
        seen, todo = set(), [src]
        while todo:
            cur = todo.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            todo.extend(b for a, b in self._edges if a == cur)
        return False

    def _path(self, src: str, dst: str) -> list:
        """One witness path src->dst through the recorded edges."""
        parents, todo = {src: None}, [src]
        while todo:
            cur = todo.pop(0)
            if cur == dst:
                out = [cur]
                while parents[cur] is not None:
                    cur = parents[cur]
                    out.append(cur)
                return out[::-1]
            for a, b in self._edges:
                if a == cur and b not in parents:
                    parents[b] = cur
                    todo.append(b)
        return [src, dst]

    @property
    def edges(self) -> int:
        return len(self._edges)

    def assert_clean(self) -> None:
        if self.violations:
            raise AssertionError(
                f"lock-order cycles observed: {self.violations}")

