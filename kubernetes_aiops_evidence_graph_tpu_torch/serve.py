"""`python -m kubernetes_aiops_evidence_graph_tpu_torch.serve` — run the platform on the CUDA device."""
from .app import main

if __name__ == "__main__":
    main()
