"""kubernetes_aiops_evidence_graph_tpu_torch — the evidence-graph RCA platform
in PyTorch, with its device work as hand-written CUDA kernels for NVIDIA
Hopper (H100, ``sm_90a``).

The subpackages carry the names of their counterparts in
``kubernetes_aiops_evidence_graph_tpu``: ``graph/`` tensorizes the
evidence-graph store, ``rca/`` scores every incident in one device pass
(``cuda_backend`` with the rules, ``gnn_backend`` with the learned GNN)
or incrementally under churn (``streaming``, ``gnn_streaming``), and
``kernels/`` holds the CUDA sources with their plain PyTorch versions
(``ops/`` the plain message pass). ``checkpoints/gnn.npz`` holds the GNN's
shipped weights.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``device.resolve_device``); the CPU path runs each
kernel's plain PyTorch version. Importing the package starts nothing and
builds nothing: kernels compile at their first launch.
"""

__version__ = "0.1.0"
