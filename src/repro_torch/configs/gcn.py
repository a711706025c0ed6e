"""GCN — the paper's native application (Kipf & Welling GCN layer is exactly
``D = A(XW)`` = GeMM-SpMM with A the normalized adjacency)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_nodes: int = 4096
    in_dim: int = 128
    hidden_dim: int = 128
    out_dim: int = 32
    n_layers: int = 2
    avg_degree: int = 8


CONFIG = GCNConfig()
REDUCED = GCNConfig(n_nodes=256, in_dim=16, hidden_dim=16, out_dim=8)
